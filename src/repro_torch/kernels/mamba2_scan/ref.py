"""Plain PyTorch version of the Mamba2 scan (the oracle of
``repro/kernels/mamba2_scan/ref.py``): the per-step recurrence

    h_t = exp(dt_t * a) h_{t-1} + dt_t * b_t (x) x_t
    y_t = c_t . h_t

in fp32, one step at a time, from an optional initial state ``h0``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, a: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [BH,S,P], dt [BH,S], b/c [BH,S,N], a [BH] (negative decay rate),
    h0 [BH,N,P] or None (zeros) -> (y [BH,S,P] in x's dtype, h_final
    [BH,N,P] fp32)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    if h0 is None:
        h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)                         # [BH]
        upd = torch.einsum("bn,b,bp->bnp", bf[:, t], dtf[:, t], xf[:, t])
        h = h * decay[:, None, None] + upd
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype), h
