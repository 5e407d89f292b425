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

``state_from_numpy`` carries the reference's ``init``/``update`` state
over (numpy leaves, a ``QTensor`` ``v`` included), so both packages can
start from one state.

**Sharded** (parameters placed by ``parallel/sharding.place`` on a live
mesh): ZeRO-1.  ``m`` and ``v`` take ``zero1_sharding_fn``'s spec (the
param rules with ``d_model`` moved onto the data axes; ``launch/build``'s
dry-run stores the same shards) and ``update``:

1. completes each leaf's gradient (``complete_grad``): summed over the
   ranks whose shares of the step it is partial on (``grad_sum_axes``)
   and cut to the moment's shard, a reduce-scatter over the data axes
   that ZeRO-1 adds (or gathered where the moment is wider than the
   param shard: context parallelism's fully sharded weights);
2. clips by the global norm of the full gradient: each leaf's squares
   summed over its moment shard and all-reduced over the axes that
   shard is split on (a replicated leaf counts once);
3. steps the moment shard and the param's part under it, then
   all-gathers that part back into the rank's param shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.module import (EMBED, KV_HEADS, tree_leaves,
                                        tree_map)
from repro_torch.parallel import sharding as sh

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


def zero1_sharding_fn(cfg, rules: sh.Rules, defs):
    """Optimizer-state specs: the param rules with the d_model axis
    forced onto the data axis (ZeRO-1); ``fn(shape)`` gives the spec of
    the first param of that shape, as the reference's looks it up.
    ``defs``: the model's ``ParamDef`` tree (or anything whose leaves
    have ``shape`` and ``axes``, e.g. placed parameters' ``Placement``s,
    in the flatten order)."""
    del cfg
    zrules = sh.Rules(table={**rules.table, EMBED: rules.table.get(
        sh.BATCH)}, mesh=rules.mesh)
    by_shape: Dict[Tuple[int, ...], Tuple] = {}
    for d in tree_leaves(defs):
        by_shape.setdefault(tuple(d.shape), d.axes)

    def fn(shape) -> Optional[Tuple]:
        ax = by_shape.get(tuple(shape))
        return None if ax is None else zrules.spec_for(ax, tuple(shape))

    return fn


def _moment_placement(p, zfn) -> Optional[sh.Placement]:
    """A placed param's moment placement (ZeRO-1), None when unplaced."""
    pl = sh.placement(p)
    if pl is None:
        return None
    return sh.Placement(tuple(zfn(pl.shape)), pl.shape, pl.axes, pl.rules)


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments shaped like the param tree's leaves, on their
    devices, and ``count`` 0.  Placed params (``sharding.place``) get
    moments on their ZeRO-1 shards, tagged with those placements."""
    leaves = tree_leaves(params)
    pls = [sh.placement(p) for p in leaves]
    zfn = None
    if any(pl is not None for pl in pls):
        zfn = zero1_sharding_fn(None, pls[0].rules, pls)

    def shape_of(p):
        zp = _moment_placement(p, zfn) if zfn else None
        return p.shape if zp is None else zp.local_shape, zp

    def mk_m(p):
        shape, zp = shape_of(p)
        m = torch.zeros(shape, dtype=cfg.dtype, device=p.device)
        return m if zp is None else sh.tag(m, zp.axes, zp.shape, zp.rules,
                                           zp.spec)

    def mk_v(p):
        shape, zp = shape_of(p)
        if cfg.quantize_v and p.dim() >= 1 and p.shape[-1] >= QBLOCK:
            if zp is not None and zp.entry(p.dim() - 1) is not None \
                    and shape[-1] % QBLOCK:
                raise NotImplementedError(
                    f"quantize_v: a moment shard's last dim {shape[-1]} "
                    f"splits {QBLOCK}-blocks")
            return quantize(torch.zeros(shape, dtype=torch.float32,
                                        device=p.device))
        v = torch.zeros(shape, dtype=torch.float32, device=p.device)
        return v if zp is None else sh.tag(v, zp.axes, zp.shape, zp.rules,
                                           zp.spec)

    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(mk_m, params), "v": tree_map(mk_v, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads, placements=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, summed in
    the flatten order as the reference sums them.  ``placements`` (a
    leaf's moment ``Placement`` or None, as many as the leaves): a leaf
    whose shard is split over mesh axes has its squares summed over
    them, once for each group of leaves split alike, so every element of
    the full gradient counts once."""
    leaves = tree_leaves(grads)
    parts: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, zp in zip(leaves, placements or [None] * len(leaves)):
        axes = () if zp is None else tuple(
            a for e in zp.spec for a in sh.axes_of(e))
        sq = torch.sum(torch.square(g.float()))
        parts[axes] = sq if axes not in parts else parts[axes] + sq
    total = None
    for axes in sorted(parts):
        part = parts[axes]
        if axes:
            rules = next(zp.rules for zp in placements if zp is not None)
            part = sh.all_reduce(part, _group(rules, axes))
        total = part if total is None else total + part
    return torch.sqrt(total)


def grad_sum_axes(pl: sh.Placement) -> Tuple[str, ...]:
    """The mesh axes over which a placed param's local gradient is a
    partial sum of the step's gradient (``transformer.forward_train``'s
    sharded step), beyond the axes its FSDP gather already
    reduce-scatters: the axes whose ranks hold other tokens (the data
    axes; under context parallelism the sequence's too) that the leaf's
    spec does not split, the model axes of a ``KV_HEADS`` leaf they do
    not shard (its heads computed in parts), and under Megatron-SP the
    model axes of a norm scale (applied to sequence shards)."""
    rules = pl.rules
    split = {a for e in pl.spec for a in sh.axes_of(e)}
    tokens = sh.axes_of(rules.table.get(sh.BATCH))
    model = sh.axes_of(rules.table.get(sh.SEQ)) if rules.context_parallel \
        else sh.axes_of(rules.table.get(sh.HEADS))
    out = [a for a in tokens if a not in split]
    if rules.context_parallel:
        out += [a for a in model if a not in split]
    elif KV_HEADS in pl.axes or (pl.axes == (EMBED,) and rules.table.get(
            sh.SEQ) is not None):
        out += [a for a in model if a not in split]
    return tuple(out)


def _group(rules: sh.Rules, axes):
    """The process group of a set of mesh axes."""
    return rules.group(sh.entry_of(rules.mesh, axes))


def _coord(rules: sh.Rules, axes) -> int:
    return rules.coordinate(sh.entry_of(rules.mesh, axes))


def _zero1_axes(pl: sh.Placement, zp: sh.Placement):
    """(the dim ZeRO-1 re-splits, the axes the moment adds to the param
    shard's split there, the axes it drops), checked: every other dim is
    split alike, and one split extends the other."""
    dim = pl.axes.index(EMBED) if EMBED in pl.axes else None
    for d in range(len(pl.shape)):
        if d != dim and pl.entry(d) != zp.entry(d):
            raise NotImplementedError(
                f"ZeRO-1 spec {zp.spec} re-splits dim {d} of {pl.spec}")
    if dim is None:
        return None, (), ()
    pa, za = sh.axes_of(pl.entry(dim)), sh.axes_of(zp.entry(dim))
    if za[:len(pa)] == pa:
        return dim, za[len(pa):], ()
    if pa[:len(za)] == za:
        return dim, (), pa[len(za):]
    raise NotImplementedError(f"ZeRO-1 spec {zp.spec} against {pl.spec}")


def complete_grad(p: torch.Tensor, g: torch.Tensor,
                  zp: Optional[sh.Placement] = None) -> torch.Tensor:
    """A placed param's local gradient ``g`` completed: summed over
    ``grad_sum_axes`` and, with ``zp`` (its moment's placement), cut or
    gathered to the moment's shard (a reduce-scatter over the data axes
    ZeRO-1 adds)."""
    pl = sh.placement(p)
    rules = pl.rules
    dim, add, drop = (None, (), ()) if zp is None else _zero1_axes(pl, zp)
    rest = tuple(a for a in grad_sum_axes(pl) if a not in add)
    if rest:
        g = sh.all_reduce(g, _group(rules, rest))
    if add:
        g = sh.reduce_scatter(g, dim, _group(rules, add))
    if drop:
        g = sh.all_gather(g, dim, _group(rules, drop))
    return g.contiguous()


@torch.no_grad()
def update(grads, state: Dict[str, Any], params, cfg: AdamWConfig,
           lr=None) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step in place -> (params, state, {"grad_norm"}).
    ``grads``: a tree like ``params``, or None for each leaf's ``.grad``.
    ``lr``: a float or a 0-d tensor (default ``cfg.lr``).  Placed params
    (``sharding.place``) take the ZeRO-1 step (the module docstring):
    their grads are the ranks' local ones, ``grad_norm`` the global
    norm."""
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
    lr_t = cfg.lr if lr is None else lr
    zps = [sh.placement(m) for m in flat_m]     # None when unplaced
    grads = [g if zp is None else complete_grad(p, g, zp)
             for p, g, zp in zip(flat_p, flat_g, zps)]
    gnorm = global_norm(grads, zps)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    countf = count.float()
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                    device=countf.device), countf)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                    device=countf.device), countf)
    for p, g, mo, vo, zp in zip(flat_p, grads, flat_m, flat_v, zps):
        dim, add, drop = (None, (), ()) if zp is None else _zero1_axes(
            sh.placement(p), zp)
        pz = p
        if add:          # the param's part under the moment shard
            n = mo.shape[dim]
            pz = p.narrow(dim, _coord(zp.rules, add) * n, n)
        elif drop:       # the moment spans other ranks' param shards
            pz = sh.all_gather(p, dim, _group(zp.rules, drop))
        g = g.float() * clip
        m = cfg.b1 * mo.float() + (1 - cfg.b1) * g
        v_f = dequantize(vo, mo.shape[-1]) if _is_q(vo) else vo
        v = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.dim() >= 2:    # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * pz.float()
        new = (pz.float() - lr_t * step).to(p.dtype)
        if add:
            new = sh.all_gather(new, dim, _group(zp.rules, add))
        elif drop:
            n = p.shape[dim]
            new = new.narrow(dim, _coord(zp.rules, drop) * n, n)
        p.copy_(new)
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
           "init", "global_norm", "update", "state_from_numpy",
           "zero1_sharding_fn", "grad_sum_axes", "complete_grad"]
