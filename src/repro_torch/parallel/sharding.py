"""Logical-axis sharding rules: the bridge between model code and meshes
(counterpart of ``repro/parallel/sharding.py``, its rule logic).

Parameters carry logical axes in their ``ParamDef`` (``models/module``)
and activations are named by the axes below.  A ``Rules`` table, which
the paper's tuner produces (``core/tuner.make_rules``), maps each
logical axis to a mesh axis, a tuple of mesh axes or ``None``.  A spec is
a plain tuple with one entry a tensor dim and trailing ``None``\\s
trimmed, so it compares equal to ``tuple(PartitionSpec(...))`` of the
reference.

Divisibility fallback: a rule whose mesh size does not divide the
dimension shrinks to the longest prefix of its mesh axes that does, and
is dropped (and logged in ``Rules.fallbacks``) when none does, e.g.
gemma2's 8 query heads on a 16-wide model axis.

The mesh is a descriptor (``launch/mesh``): ``.shape`` maps axis names to
sizes.  ``sharding_for`` returns ``None`` without a device mesh: placing
tensors on a ``DeviceMesh`` is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

# logical activation axes
BATCH = "batch"
SEQ = "seq"          # sequence (activations)
KV_SEQ = "kv_seq"    # kv-cache sequence dim (decode: sharded on model)
PAGES = "pages"      # paged-KV pool page dim (serving: sharded on data)
EMBED = "act_embed"  # activation d_model dim
HEADS = "act_heads"
MLP = "act_mlp"
EXPERT = "act_expert"
GROUPS = "act_groups"  # MoE dispatch groups
VOCAB = "act_vocab"

MeshAxis = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxis, ...]


@dataclasses.dataclass
class Rules:
    """logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    table: Dict[str, MeshAxis]
    mesh: Any = None
    fallbacks: List[str] = dataclasses.field(default_factory=list)
    # context parallelism: activations stay seq-sharded through the blocks
    # (no SP gather); attention gathers KV instead of sharding heads
    context_parallel: bool = False

    def mesh_size(self, axis: MeshAxis) -> int:
        if axis is None or self.mesh is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(int(self.mesh.shape[a]) for a in axis)
        return int(self.mesh.shape[axis])

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 dims: Optional[Sequence[int]] = None) -> Spec:
        """The spec of a tensor with the given logical axes.  ``dims``
        (if given) enables the divisibility fallback."""
        entries: List[MeshAxis] = []
        used: set = set()
        for i, ax in enumerate(logical_axes):
            phys = self.table.get(ax) if ax is not None else None
            if phys is not None:
                # a mesh axis may appear only once per spec: keep the unused
                # subtuple (e.g. expert dim takes "pool", ff dim keeps "intra")
                flat = phys if isinstance(phys, tuple) else (phys,)
                flat = tuple(f for f in flat if f not in used)
                phys = None if not flat else (flat if len(flat) > 1
                                              else flat[0])
                if phys is not None and dims is not None and \
                        dims[i] % self.mesh_size(phys) != 0:
                    # try progressively smaller prefixes before giving up
                    while flat and dims[i] % self.mesh_size(
                            flat if len(flat) > 1 else flat[0]) != 0:
                        flat = flat[:-1]
                    if flat:
                        phys = flat if len(flat) > 1 else flat[0]
                    else:
                        self.fallbacks.append(
                            f"{ax}: dim {dims[i]} not divisible")
                        phys = None
            if phys is not None:
                used.update(phys if isinstance(phys, tuple) else (phys,))
            entries.append(phys)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def local_shape(self, spec: Spec, dims: Sequence[int]
                    ) -> Tuple[int, ...]:
        """Each of ``dims`` over the mesh size of its ``spec`` entry: a
        tensor's per-device shape."""
        return tuple(d // self.mesh_size(spec[i] if i < len(spec) else None)
                     for i, d in enumerate(dims))

    def shard_shape(self, logical_axes: Sequence[Optional[str]],
                    dims: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor with these logical axes and
        dims (the divisibility fallback applied)."""
        return self.local_shape(self.spec_for(logical_axes, dims), dims)

    def sharding_for(self, logical_axes, dims=None) -> None:
        """No device placement yet: a ``DeviceMesh`` sharding is the
        multi-device work still to come, so every tensor stays whole."""
        del logical_axes, dims
        return None


_ctx = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Rules]):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def param_shardings(axes_tree: Any, shapes_tree: Any, rules: Rules) -> Any:
    """The spec of every parameter: ``axes_tree`` and ``shapes_tree``
    (``models/module``) walked together in the reference's flatten order
    (dict keys sorted, so ``rules.fallbacks`` logs in its order), each
    leaf's axes and shape through ``rules.spec_for``."""
    if _is_axes(axes_tree):
        return rules.spec_for(axes_tree, shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: param_shardings(axes_tree[k], shapes_tree[k], rules)
                for k in sorted(axes_tree)}
    return [param_shardings(v, s, rules)
            for v, s in zip(axes_tree, shapes_tree)]


def unsharded_like(tree: Any) -> Any:
    """``None`` in place of every leaf of a tree (dicts, lists and tuples
    are nodes, as in a pytree)."""
    if isinstance(tree, dict):
        return {k: unsharded_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unsharded_like(v) for v in tree)
    return None
