"""The LaViLa narrator's train step through the port's narrator entry:
``train.train_narrator.build_model`` (frozen by LaViLa's recipe), the
optimizer of ``optim.factory.build_optimizer`` over the leaves that train, as
``build_model_and_state`` builds it, and ``make_narrator_step`` (the token
mean of the next-token NLL), in a ``core.train_state.TrainState`` of one
process.

The model is built on the meta device by the entry, given storage on the
card, and loaded with the benchmark's weights (strict: every name and
shape must match); the learning rate is held at ``lr`` where the recipe
says ``fix_lr``.
"""

from __future__ import annotations

from portbench.jobs import Program, recipe_overrides


def build(config: dict, traffic: dict, weights: dict, device) -> Program:
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train import train_narrator

    recipe = traffic["recipe"]
    cfg = TrainConfig().apply_overrides([
        f"model.name={config['port_model']}",
        f"data.clip_length={traffic['video']['frames']}",
        f"data.batch_size={traffic['batch']}",
        f"data.crop_size={traffic['video']['size']}",
        f"optim.fix_lr={bool(recipe.get('fix_lr'))}",
        *recipe_overrides(recipe), *traffic["model_overrides"]])
    model = train_narrator.build_model(cfg).to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    optimizer, _ = build_optimizer(cfg.optim, model,
                                   recipe["steps_per_epoch"],
                                   num_layers=model.layers)
    return Program(model, optimizer, TrainState.create(model, optimizer),
                   train_narrator.make_narrator_step(model),
                   cfg.optim.betas[0])
