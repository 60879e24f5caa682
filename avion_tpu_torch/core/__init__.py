from avion_tpu_torch.core.policy import Policy, DEFAULT_POLICY
from avion_tpu_torch.core.config import (
    MeshConfig,
    OptimConfig,
    TrainConfig,
    DataConfig,
    ModelConfig,
)
