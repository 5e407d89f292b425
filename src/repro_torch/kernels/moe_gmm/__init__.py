"""Grouped per-expert matmul for MoE FFNs: Hopper CUDA kernel, its
wrapper and its plain PyTorch version (port of ``repro/kernels/moe_gmm``)."""

from repro_torch.kernels.moe_gmm.ops import moe_gmm, supported
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

__all__ = ["moe_gmm", "moe_gmm_ref", "supported"]
