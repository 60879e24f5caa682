"""CLIP train steps through the port's entries: ``entry`` ``pretrain_clip``
(``train.pretrain_clip.build_model`` and ``make_step``: InfoNCE) or
``finetune_mir`` (``train.finetune_mir.build_model`` and
``train.steps.make_mir_finetune_step``: the max-margin loss), each with
the optimizer of ``optim.factory.build_optimizer`` as the entry builds it,
in a ``core.train_state.TrainState`` of one process.

The model is built on the meta device by the entry, given storage on the
card, and loaded with the benchmark's weights (strict: every name and
shape must match).
"""

from __future__ import annotations

from portbench.jobs import Program, recipe_overrides


def build(config: dict, traffic: dict, weights: dict, device) -> Program:
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer

    recipe = traffic["recipe"]
    cfg = TrainConfig().apply_overrides([
        f"model.name={config['port_model']}",
        f"model.project_embed_dim={config['embed_dim']}",
        f"data.clip_length={traffic['video']['frames']}",
        f"data.batch_size={traffic['batch']}",
        f"data.crop_size={traffic['video']['size']}",
        *recipe_overrides(recipe), *traffic["model_overrides"]])
    entry = traffic["entry"]
    if entry == "pretrain_clip":
        from avion_tpu_torch.train import pretrain_clip

        model = pretrain_clip.build_model(cfg).to_empty(device=device)
        num_layers, make = None, lambda: pretrain_clip.make_step(cfg, model)
    elif entry == "finetune_mir":
        from avion_tpu_torch.train import finetune_mir
        from avion_tpu_torch.train.steps import make_mir_finetune_step

        model = finetune_mir.build_model(cfg).to_empty(device=device)
        num_layers = cfg.model.vision_layers
        make = lambda: make_mir_finetune_step(  # noqa: E731
            model, margin=traffic.get("margin", 0.2), seed=cfg.seed + 1)
    else:
        raise ValueError(f"unknown CLIP entry {entry!r}")
    model.load_state_dict(weights, strict=True)
    optimizer, _ = build_optimizer(cfg.optim, model,
                                   recipe["steps_per_epoch"],
                                   num_layers=num_layers)
    return Program(model, optimizer, TrainState.create(model, optimizer),
                   make(), cfg.optim.betas[0])
