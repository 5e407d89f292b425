"""Plain PyTorch version of the grouped per-expert matmul (the oracle of
``repro/kernels/moe_gmm/ref.py``): an fp32 einsum cast back to x's dtype,
with rows at or past ``row_counts`` zeroed.  ``moe_gmm_tiled_ref`` computes
the same function by the CUDA kernel's decomposition and arithmetic, for
the CPU tests."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.tf32 import mma_sum


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor,
                row_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [E,C,D] (or [G,E,C,D]) @ w [E,D,F] -> [E,C,F] (or [G,E,C,F]);
    ``row_counts`` [E] (or [G,E]): rows ``>= row_counts[e]`` are 0."""
    out = torch.einsum("...ecd,edf->...ecf", x.float(), w.float()).to(x.dtype)
    if row_counts is not None:
        rows = torch.arange(x.shape[-2], device=x.device)
        valid = rows < row_counts[..., None]
        out = out * valid[..., None].to(out.dtype)
    return out


# The CUDA kernel's decomposition (csrc/moe_gmm.cu: kBF, kBR, kRowStep):
# one block per (group, expert, F tile), passes of up to ROW_PASS live
# rows, each computed in steps of ROW_STEP rows (the MMA's n8 tiles, taken
# in turn by the 2 warps along the rows).
F_TILE = 128
ROW_PASS = 128
ROW_STEP = 16


def moe_gmm_rows_computed(row_counts, capacity: int) -> int:
    """Rows the kernel computes for these counts (an iterable of ints, or
    None for every row live in one expert of ``capacity`` rows): each
    pass of up to ROW_PASS live rows rounded up to ROW_STEP."""
    counts = [capacity] if row_counts is None else row_counts
    total = 0
    for c in counts:
        c = min(max(int(c), 0), capacity)
        for r0 in range(0, c, ROW_PASS):
            rows = min(ROW_PASS, c - r0)
            total += -(-rows // ROW_STEP) * ROW_STEP
    return total


def moe_gmm_tiled_ref(x: torch.Tensor, w: torch.Tensor,
                      row_counts: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``moe_gmm_ref`` by the CUDA kernel's decomposition, on the CPU:
    outᵀ = wᵀ xᵀ per (group, expert, F tile), passes of ROW_PASS live rows
    each rounded up to ROW_STEP with zero rows, the products as the tensor
    cores sum them (``kernels/tf32.mma_sum``: 3xTF32 for fp32, 1 TF32
    product for bf16), rows at or past the count exactly 0."""
    squeeze = x.dim() == 3
    x4 = x[None] if squeeze else x
    G, E, C, D = x4.shape
    F = w.shape[2]
    exact = x.dtype != torch.float32
    out = torch.zeros(G, E, C, F, dtype=torch.float32)
    counts = (None if row_counts is None
              else row_counts.reshape(G, E).tolist())
    for g in range(G):
        for e in range(E):
            count = C if counts is None else min(max(counts[g][e], 0), C)
            for r0 in range(0, count, ROW_PASS):
                rows = min(ROW_PASS, count - r0)
                xb = torch.zeros(-(-rows // ROW_STEP) * ROW_STEP, D)
                xb[:rows] = x4[g, e, r0:r0 + rows].float()
                for f0 in range(0, F, F_TILE):
                    wt = w[e, :, f0:f0 + F_TILE].float()
                    acc = mma_sum(wt.T, xb.T, exact, exact)     # [f, rows]
                    out[g, e, r0:r0 + rows, f0:f0 + F_TILE] = acc.T[:rows]
    out = out.to(x.dtype)
    return out[0] if squeeze else out
