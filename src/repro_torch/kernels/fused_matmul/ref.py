"""Plain PyTorch version of fused_matmul (the oracle of
``repro/kernels/fused_matmul/ref.py``) — and the paper's ``MatMul1``
baseline.

``matmul1`` materializes the prepared (upcast + scaled) x before the
product: the separate data-preparation step whose overhead §5.1
measures.  The numerics are those of the kernel; only the fusion
structure differs.  The product runs in fp32 with TF32 off, as the
reference computes it.  ``fused_matmul_tiled_ref`` computes the same
function by the CUDA kernel's arithmetic (3xTF32 products, the row scale
in the epilogue), for the CPU tests.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels.tf32 import exact_in_tf32, mma_sum


@contextlib.contextmanager
def tf32_off():
    """fp32 products in full fp32 on the card, whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def prep(x: torch.Tensor, x_scale: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """The 'data preparation': upcast + per-row dequant scale."""
    xf = x.to(torch.float32)
    if x_scale is not None:
        xf = xf * x_scale.to(torch.float32)
    return xf


def matmul1(x: torch.Tensor, w: torch.Tensor,
            x_scale: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Separate prep (one round trip through device memory), then the
    library product."""
    out_dtype = out_dtype or w.dtype
    xf = prep(x, x_scale)
    with tf32_off():
        out = torch.matmul(xf, w.to(torch.float32))
    return out.to(out_dtype)


fused_matmul_ref = matmul1  # the oracle: same math, unfused structure


def fused_matmul_tiled_ref(x: torch.Tensor, w: torch.Tensor,
                           x_scale: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """``matmul1`` by the CUDA kernel's arithmetic, on the CPU: x enters the
    product at its stored values (upcast exactly, no scale), the products
    as the tensor cores sum them (``kernels/tf32.mma_sum``: x and w split
    only where fp32, so 2 TF32 products for an int8, bf16 or fp16 x with
    fp32 w, 1 with bf16 w, 3 for fp32 x and w), then the row scale on the
    fp32 sum (the epilogue) and one rounding to the output type."""
    acc = mma_sum(x.float(), w.float(), exact_in_tf32(x.dtype),
                  exact_in_tf32(w.dtype))
    if x_scale is not None:
        acc = acc * x_scale.to(torch.float32)
    return acc.to(out_dtype or w.dtype)
