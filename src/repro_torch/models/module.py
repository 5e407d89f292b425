"""Parameter trees for the port: ``ParamDef`` tables, seeded init and
the weight bridge from the reference's pytrees.

A model's parameters are one ``ParamTree`` — an ``nn.Module`` whose
submodule and parameter names are the reference's pytree keys, so
``named_parameters()`` yields ``layers.0.mixer.wq``, ``embed.table``,
... and each tensor keeps the reference's layout (``wq [d,H,dh]``,
``wo [H,dh,d]``, ``head [d,V]``).  Layer code indexes it like the
reference's nested dicts (``params["layers"][0]["mixer"]["wq"]``).

Serving builds frozen leaves (``trainable=False``, the default: no
autograd graph, no gradient buffers); training builds trainable ones
(``trainable=True``).  ``tree_of`` / ``tree_leaves`` / ``tree_map`` walk
a tree of tensors in the reference's flatten order (dict keys sorted,
lists in order), which the optimizer state and the checkpoints share
with the param tree; ``optim/adamw.state_from_numpy`` carries the
reference's optimizer state over as ``params_from_numpy`` carries its
weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


# Logical axis names of the parameters (the reference's): the sharding
# rules (``parallel/sharding``) map them to mesh axes.
EMBED = "embed"        # d_model
VOCAB = "vocab"        # vocabulary
HEADS = "heads"        # query heads
KV_HEADS = "kv_heads"  # kv heads (may be replicated when not divisible)
HEAD_DIM = "head_dim"  # per-head feature dim
MLP = "mlp"            # d_ff
EXPERT = "expert"      # MoE expert dim -> "pool" under the paper's tuner
SSM_INNER = "ssm_inner"  # mamba d_inner / rwkv channel dim
STATE = "state"        # ssm state dim
LAYERS = "layers"      # stacked-layer leading dim (never sharded)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # one logical axis name (or None) a dim
    init: str = "fan_in"     # fan_in | zeros | ones | normal | embed | custom
    scale: float = 1.0       # extra multiplier on the init
    dtype: Optional[torch.dtype] = None   # None -> the model's param dtype
    # init="custom": (generator, shape, device) -> fp32 tensor
    custom: Optional[Callable] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef: shape {self.shape} has "
                             f"{len(self.shape)} dims, axes {self.axes} "
                             f"{len(self.axes)}")


class ParamTree(nn.Module):
    """Nested parameter container: dict nodes are ``ParamTree``s, list
    nodes ``nn.ModuleList``s, leaves ``nn.Parameter``s, frozen unless
    ``trainable`` (serving never trains).  ``tree["key"]`` reads a child
    like a dict."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=trainable))
            elif isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    [ParamTree(v, trainable) for v in val]))
            else:
                raise TypeError(f"param tree leaf {key!r}: {type(val)}")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def tree_of(params) -> Any:
    """A ``ParamTree`` as the reference's pytree: nested dicts and lists
    whose leaves are the tree's own ``nn.Parameter`` objects (no copy).
    Anything else passes through."""
    if isinstance(params, ParamTree):
        return {k: tree_of(v) for k, v in
                list(params._parameters.items())
                + list(params._modules.items())}
    if isinstance(params, nn.ModuleList):
        return [tree_of(v) for v in params]
    return params


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of a tree of tensors in the reference's flatten order:
    dict keys sorted, lists and tuples (a ``QTensor`` too, unless
    ``is_leaf`` says it is a leaf) in order, ``None`` an empty node.  A
    ``ParamTree`` flattens as its pytree."""
    tree = tree_of(tree)
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), rebuilding its dicts, lists and named tuples."""
    tree = tree_of(tree)
    rest = [tree_of(r) for r in rest]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v, *[r[i] for r in rest])
                            for i, v in enumerate(tree)])
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def axes_tree(defs):
    """The defs tree with each ``ParamDef`` replaced by its logical axes:
    the reference's ``axes_tree``, which ``parallel/sharding`` reads."""
    return _map_tree(defs, lambda d: d.axes)


def shapes_tree(defs):
    """The defs tree with each ``ParamDef`` replaced by its shape."""
    return _map_tree(defs, lambda d: d.shape)


def param_count(defs) -> int:
    """The number of parameters a defs tree describes."""
    if isinstance(defs, ParamDef):
        return math.prod(defs.shape)
    nodes = defs.values() if isinstance(defs, dict) else defs
    return sum(param_count(v) for v in nodes)


def _init_one(d: ParamDef, gen: torch.Generator, dtype,
              device: torch.device) -> torch.Tensor:
    dtype = d.dtype or dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "custom":
        return d.custom(gen, d.shape, device).to(dtype)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if d.init in ("normal", "embed"):
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[0] if len(d.shape) == 1 \
            else int(np.prod(d.shape[:-1]))
        std = d.scale / max(fan_in, 1) ** 0.5
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return x.mul_(std).to(dtype)


def init_params(defs, seed: int, dtype=torch.float32,
                device: DeviceLike = None,
                trainable: bool = False) -> ParamTree:
    """Random parameters from a defs tree, drawn from one seeded
    ``torch.Generator`` on ``device`` (the card unless given); trainable
    leaves when ``trainable``.  The init rules are the reference's; the
    random bits are torch's, so the same seed gives other values than
    ``repro.models.module.init_params`` — parity tests carry the
    reference's values over with :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(tree):   # the reference's flatten order: sorted dict keys
        if isinstance(tree, dict):
            return {k: draw(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [draw(v) for v in tree]
        return _init_one(tree, gen, dtype, dev)

    return ParamTree(draw(defs), trainable)


def params_from_numpy(tree, device: DeviceLike = None,
                      trainable: bool = False) -> ParamTree:
    """The weight bridge: the reference's param pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's params, key for
    key and layout for layout (no transposes); trainable leaves when
    ``trainable``."""
    dev = resolve_device(device)
    return ParamTree(_map_tree(
        tree, lambda a: torch.as_tensor(np.array(a)).to(dev)), trainable)


def params_to_numpy(params: nn.Module) -> Dict[str, np.ndarray]:
    """Flat ``{dotted name: array}`` view, for round-trip checks."""
    return {k: v.detach().cpu().numpy()
            for k, v in params.named_parameters()}
