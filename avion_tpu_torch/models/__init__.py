from avion_tpu_torch.models.registry import create_model, list_models  # noqa: F401
