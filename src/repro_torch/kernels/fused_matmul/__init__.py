"""Matmul with fused data preparation (paper §5, fig11's fused case):
Hopper CUDA kernel, its wrapper, its autograd op and its plain PyTorch
version (port of ``repro/kernels/fused_matmul``)."""

from repro_torch.kernels.fused_matmul.ops import (fused_matmul, matmul,
                                                  supported)
from repro_torch.kernels.fused_matmul.ref import (fused_matmul_ref, matmul1,
                                                  prep)

__all__ = ["fused_matmul", "matmul", "fused_matmul_ref", "matmul1", "prep",
           "supported"]
