from avion_tpu_torch.egonlq.nlq_eval import evaluate_nlq
from avion_tpu_torch.egonlq.vslnet import (VSLNet, extract_top_spans,
                                           vslnet_loss)
