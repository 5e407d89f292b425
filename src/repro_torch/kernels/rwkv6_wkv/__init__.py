"""RWKV6 wkv with data-dependent decay: Hopper CUDA kernel, its wrapper
and its plain PyTorch version (port of ``repro/kernels/rwkv6_wkv``)."""

from repro_torch.kernels.rwkv6_wkv.ops import (rwkv6_wkv, supported,
                                               wkv_model_layout)
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref

__all__ = ["rwkv6_wkv", "rwkv6_wkv_ref", "supported", "wkv_model_layout"]
