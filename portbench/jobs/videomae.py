"""VideoMAE pretraining's train step through the port's entry:
``train.videomae_pretrain.build_model``, the learning rate scaled by
batch / ``lr_scale_by_batch`` as the entry scales it, the optimizer of
``optim.factory.build_optimizer`` with the encoder's layer count, and
``train.steps.make_videomae_train_step`` on the batch's tube masks, in a
``core.train_state.TrainState`` of one process.

The model is built on the meta device by the entry and given storage on
the card; ``init_weights`` fills its fixed sinusoid tables (buffers that
no state dict carries), and the benchmark's weights are loaded over its
parameters (strict: every name and shape must match).
"""

from __future__ import annotations

from portbench.jobs import Program, recipe_overrides


def build(config: dict, traffic: dict, weights: dict, device) -> Program:
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train import videomae_pretrain
    from avion_tpu_torch.train.steps import make_videomae_train_step

    recipe = traffic["recipe"]
    cfg = TrainConfig().apply_overrides([
        f"model.name={config['port_model']}",
        f"model.decoder_layers={config['decoder_layers']}",
        f"data.clip_length={traffic['video']['frames']}",
        f"data.batch_size={traffic['batch']}",
        f"data.mask_ratio={config['mask_ratio']!r}",
        *recipe_overrides(recipe), *traffic["model_overrides"]])
    if recipe.get("lr_scale_by_batch"):
        cfg.optim.lr = cfg.optim.lr * traffic["batch"] / recipe[
            "lr_scale_by_batch"]
    model = videomae_pretrain.build_model(cfg).to_empty(device=device)
    model.init_weights()
    model.load_state_dict(weights, strict=True)
    optimizer, _ = build_optimizer(cfg.optim, model,
                                   recipe["steps_per_epoch"],
                                   num_layers=model.encoder_layers)
    step = make_videomae_train_step(
        model, patch_size=model.patch_size, tubelet_size=model.tubelet_size,
        normalize_target=config["normalize_target"], seed=cfg.seed + 1)
    return Program(model, optimizer, TrainState.create(model, optimizer),
                   step, cfg.optim.betas[0])
