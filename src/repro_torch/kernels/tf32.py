"""The arithmetic of the port's tensor-core matrix products, in plain
PyTorch: what ``kernels/common/tf32_mma.cuh`` and ``tf32_gemm.cuh`` do on
the card, for the tests on the CPU.

An fp32 operand is split into two TF32 values, ``big = rna(x)`` (nearest,
ties away from zero, 10 mantissa bits) and ``small = x - big``, which the
tensor core reads truncated to its 19 high bits.  Each fp32 product is
then the sum of the TF32 products small*big, big*small and big*big
("3xTF32"); an operand whose values are all exact in TF32 (int8, bf16,
fp16) has no small half, so a product takes 2 TF32 products when one side
is exact and 1 when both are.  ``mma_sum`` adds them as the mainloop
does: per step of 8 along K (one ``mma.sync`` m16n8k8), each product's
8-term dot into the MMA's fp32 accumulator, which rounds toward zero, and
per shared-memory stage of 64 that accumulator's sum into an fp32 total
that rounds to nearest.
"""

from __future__ import annotations

from typing import Optional

import torch

K_STEP = 8    # the K depth of one mma.sync m16n8k8
STAGE_K = 64  # the K depth of one shared-memory stage (tf32_gemm.cuh kBK)


def rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 by integer ops on the bits (the kernels'
    ``rna_tf32``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_view(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register: the low 13
    mantissa bits dropped."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """``(big, small)``: big = rna(x), small = x - big as the tensor core
    reads it."""
    x = x.to(torch.float32)
    big = rna(x)
    return big, tf32_view(x - big)


def exact_in_tf32(dtype: torch.dtype) -> bool:
    """Every value of ``dtype`` is a TF32 value: int8, bf16 (8 significant
    bits) and fp16 (11, its subnormals normal in TF32's 8-bit exponent)."""
    return dtype in (torch.int8, torch.bfloat16, torch.float16)


def products(a_dtype: torch.dtype, b_dtype: torch.dtype) -> int:
    """TF32 products per fp32 product for operands of these types."""
    return 1 + (not exact_in_tf32(a_dtype)) + (not exact_in_tf32(b_dtype))


def _add_toward_zero(acc: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    """fp32 ``acc + dot`` rounded toward zero: the tensor cores' add into
    their accumulator (as modelled here)."""
    exact = acc.double() + dot
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def mma_sum(a: torch.Tensor, b: torch.Tensor, a_exact: bool,
            b_exact: bool, stage_k: Optional[int] = STAGE_K) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] (fp32 values) as the mainloop sums it:
    for each step of 8 along K, the TF32 products small*big, big*small,
    big*big (those of an exact operand dropped), each 8-term dot exact and
    added into the MMA accumulator rounded toward zero; every ``stage_k``
    along K that accumulator starts from 0 and its sum is added into an
    fp32 total rounded to nearest (None: one accumulator for all of K, no
    promotion).  Returns float32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    ab, as_ = (a, None) if a_exact else split(a)
    bb, bs = (b, None) if b_exact else split(b)
    terms = [(x, y) for x, y in ((as_, bb), (ab, bs), (ab, bb))
             if x is not None and y is not None]
    k = a.shape[-1]
    stage_k = stage_k or max(k, 1)
    total = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32,
                        device=a.device)
    for s0 in range(0, k, stage_k):
        part = torch.zeros_like(total)
        for k0 in range(s0, min(s0 + stage_k, k), K_STEP):
            for x, y in terms:
                dot = x[..., k0:k0 + K_STEP].double() @ y[..., k0:k0 + K_STEP,
                                                           :].double()
                part = _add_toward_zero(part, dot)
        total = (total.double() + part.double()).float()
    return total
