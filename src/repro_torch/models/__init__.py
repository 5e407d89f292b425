"""Models of the port: parameter trees, layers, paged, prefill, dense
and cross-attention, the MoE FFN, the Mamba2 mixer, the rwkv6 time-mix
and channel-mix, the decoder stack and whisper's encoder (counterpart of
``repro/models``)."""

from repro_torch.models import (attention, layers, mamba2, module, moe,
                                rwkv6, transformer)
from repro_torch.models.transformer import (cache_structure, forward_decode,
                                            forward_dense_logits,
                                            forward_prefill, forward_train,
                                            forward_verify, model_defs,
                                            prepare_decode_cache)

__all__ = ["attention", "layers", "mamba2", "module", "moe", "rwkv6",
           "transformer",
           "model_defs", "forward_train", "forward_dense_logits",
           "forward_prefill", "forward_decode", "forward_verify",
           "prepare_decode_cache", "cache_structure"]
