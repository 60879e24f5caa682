from avion_tpu_torch.serve.batcher import MicroBatcher  # noqa: F401
from avion_tpu_torch.serve.server import ClipService, make_server  # noqa: F401
