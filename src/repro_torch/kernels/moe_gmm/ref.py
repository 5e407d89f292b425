"""Plain PyTorch version of the grouped per-expert matmul (the oracle of
``repro/kernels/moe_gmm/ref.py``): an fp32 einsum cast back to x's dtype,
with rows at or past ``row_counts`` zeroed."""

from __future__ import annotations

from typing import Optional

import torch


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
