"""Models of the port: parameter trees, layers, paged and prefill
attention, the MoE FFN, the Mamba2 mixer, the rwkv6 time-mix and
channel-mix and the decoder stack (counterpart of ``repro/models``)."""

from repro_torch.models import (attention, layers, mamba2, module, moe,
                                rwkv6, transformer)
from repro_torch.models.transformer import (forward_decode, forward_prefill,
                                            forward_verify, model_defs)

__all__ = ["attention", "layers", "mamba2", "module", "moe", "rwkv6",
           "transformer",
           "model_defs", "forward_prefill", "forward_decode",
           "forward_verify"]
