"""AdamW of the port, with an optional int8 second moment (counterpart
of ``repro/optim/adamw.py``).

* The update follows the reference's arithmetic: the gradients clipped
  by their global norm, fp32 moments with bias correction, decoupled
  weight decay on matrices only (``ndim >= 2``), the new value cast back
  to the param's dtype.
* ``quantize_v``: ``v`` block-quantized to int8 over the last dim in
  blocks of ``QBLOCK`` with a fp32 scale per block (leaves whose last
  dim is at least ``QBLOCK``).
* The update runs **in place**, under ``torch.no_grad()``, over the
  param tree's leaves in the reference's flatten order (sorted keys):
  params, ``m``, ``v`` (a ``QTensor``'s payload and scales) and
  ``count`` are overwritten, and ``update`` returns the same objects.
  A leaf without a gradient (``None``: a leaf the forward never read)
  steps with a zero gradient, as the reference's zero cotangent does.
* Every value stays on the params' device: ``count``, the learning rate
  and the grad norm are 0-d tensors, so a step reads nothing back.

ZeRO-1 (the optimizer state sharded over the data axis) is ROADMAP
A14's: this is the single-device optimizer.  ``state_from_numpy``
carries the reference's ``init``/``update`` state over (numpy leaves, a
``QTensor`` ``v`` included), so both packages can start from one state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.module import tree_leaves, tree_map

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_v: bool = False          # int8 second moment
    dtype: torch.dtype = torch.float32   # first-moment dtype


class QTensor(NamedTuple):
    q: torch.Tensor       # int8 payload, padded to QBLOCK on the last dim
    scale: torch.Tensor   # fp32 per-block scales


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def quantize(x: torch.Tensor) -> QTensor:
    xf = x.float()
    pad = (-xf.shape[-1]) % QBLOCK
    if pad:
        xf = F.pad(xf, (0, pad))
    blocks = xf.reshape(*xf.shape[:-1], xf.shape[-1] // QBLOCK, QBLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QTensor(q.reshape(xf.shape), scale[..., 0])


def dequantize(qt: QTensor, orig_last: int) -> torch.Tensor:
    q = qt.q.float()
    blocks = q.reshape(*q.shape[:-1], q.shape[-1] // QBLOCK, QBLOCK)
    x = (blocks * qt.scale[..., None]).reshape(q.shape)
    return x[..., :orig_last]


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments shaped like the param tree's leaves, on their
    devices, and ``count`` 0."""
    def mk_v(p):
        if cfg.quantize_v and p.dim() >= 1 and p.shape[-1] >= QBLOCK:
            return quantize(torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.dtype,
                                                device=p.device), params),
            "v": tree_map(mk_v, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, summed in
    the flatten order as the reference sums them."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: Dict[str, Any], params, cfg: AdamWConfig,
           lr=None) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step in place -> (params, state, {"grad_norm"}).
    ``grads``: a tree like ``params``, or None for each leaf's ``.grad``.
    ``lr``: a float or a 0-d tensor (default ``cfg.lr``)."""
    flat_p = tree_leaves(params)
    flat_g = ([p.grad for p in flat_p] if grads is None
              else tree_leaves(grads))
    flat_g = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat_p, flat_g)]
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"], is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_m)} m and {len(flat_v)} v leaves")
    count = state["count"] + 1
    countf = count.float()
    lr_t = cfg.lr if lr is None else lr
    gnorm = global_norm(flat_g)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                    device=countf.device), countf)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                    device=countf.device), countf)
    for p, g, mo, vo in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * clip
        m = cfg.b1 * mo.float() + (1 - cfg.b1) * g
        v_f = dequantize(vo, p.shape[-1]) if _is_q(vo) else vo
        v = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.dim() >= 2:    # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr_t * step).to(p.dtype))
        mo.copy_(m.to(cfg.dtype))
        if _is_q(vo):
            nq = quantize(v)
            vo.q.copy_(nq.q)
            vo.scale.copy_(nq.scale)
        else:
            vo.copy_(v)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm}


def state_from_numpy(tree, device: DeviceLike = None) -> Dict[str, Any]:
    """The optimizer-state bridge: the reference's ``adamw.init`` /
    ``update`` state as numpy (``jax.tree.map(np.asarray, state)``) ->
    the port's, leaf for leaf; a reference ``QTensor`` (a named tuple of
    ``q``, ``scale``) becomes this module's."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, tuple) and getattr(x, "_fields", None) == (
                "q", "scale"):
            return QTensor(conv(x.q), conv(x.scale))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.as_tensor(np.array(x)).to(dev)

    return {"m": conv(tree["m"]), "v": conv(tree["v"]),
            "count": conv(tree["count"]).to(torch.int32)}


__all__ = ["QBLOCK", "AdamWConfig", "QTensor", "quantize", "dequantize",
           "init", "global_norm", "update", "state_from_numpy"]
