"""Plain PyTorch version of the RWKV6 wkv (the oracle of
``repro/kernels/rwkv6_wkv/ref.py``): the per-step recurrence

    y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t (x) v_t

in fp32, one step at a time, from an optional initial state ``h0``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lw: torch.Tensor, u: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [BH,S,K] (lw: log decays, <= 0), u [BH,K], h0 [BH,K,K]
    or None (zeros) -> (y [BH,S,K] in r's dtype, h_final [BH,K,K] fp32)."""
    bh, s, kk = r.shape
    rf, kf, vf, lwf = r.float(), k.float(), v.float(), lw.float()
    uf = u.float()[:, :, None]
    if h0 is None:
        h = torch.zeros((bh, kk, kk), dtype=torch.float32, device=r.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        kv = kf[:, t, :, None] * vf[:, t, None, :]               # [BH,K,V]
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t], h + uf * kv))
        h = torch.exp(lwf[:, t])[:, :, None] * h + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros((bh, 0, kk))
    return y.to(r.dtype), h
