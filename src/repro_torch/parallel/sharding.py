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

The mesh is a descriptor (``launch/mesh.MeshDescriptor``: the dry-run's,
with no devices) or a ``torch.distributed.device_mesh.DeviceMesh``
(``launch/mesh.device_mesh``).  ``sharding_for`` returns the placements
of a tensor on a ``DeviceMesh`` (``Shard(d)`` or ``Replicate()`` per mesh
dim) and ``None`` on a descriptor.  The port runs SPMD ranks whose
kernels take plain local tensors, so a rank reads its part of a sharded
dim with ``local_range`` and its place on an axis with ``coordinate``;
the serving engine (``serve/engine.Engine(rules=...)``) is their caller.
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


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (it names its dims
    ``mesh_dim_names``; a descriptor names them ``axis_names``)."""
    return hasattr(mesh, "mesh_dim_names")


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a descriptor (its ``shape`` is that dict) or
    a ``DeviceMesh`` (its ``shape`` a tuple in ``mesh_dim_names`` order)."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


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
        sizes = axis_sizes(self.mesh)
        if isinstance(axis, tuple):
            return math.prod(int(sizes[a]) for a in axis)
        return int(sizes[axis])

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

    def sharding_for(self, logical_axes, dims=None):
        """The placements of a tensor on the ``DeviceMesh``: one per mesh
        dim, ``Shard(d)`` where tensor dim ``d``'s spec entry names that
        mesh axis, else ``Replicate()`` (with ``dims``, under the
        divisibility fallback of ``spec_for``).  ``None`` when the mesh
        is a descriptor or absent: nothing is placed."""
        if not is_device_mesh(self.mesh):
            return None
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        placements = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec_for(logical_axes, dims)):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    placements[names.index(ax)] = Shard(d)
        return tuple(placements)

    def coordinate(self, axis: MeshAxis) -> int:
        """This rank's index along ``axis`` of the ``DeviceMesh`` (a tuple
        of axes counts row-major, first axis slowest); 0 for ``None``."""
        if axis is None:
            return 0
        axes = axis if isinstance(axis, tuple) else (axis,)
        idx = 0
        for ax in axes:
            idx = idx * self.mesh_size(ax) + int(self.mesh.get_local_rank(ax))
        return idx

    def local_range(self, spec: Spec, dims: Sequence[int],
                    dim: int = 0) -> Tuple[int, int]:
        """The ``[lo, hi)`` rows of tensor dim ``dim`` this rank holds
        under ``spec`` (a ``spec_for`` result): its coordinate's equal
        share of a sharded dim, all of a replicated one."""
        entry = spec[dim] if dim < len(spec) else None
        n = self.mesh_size(entry)
        rows = dims[dim] // n
        lo = self.coordinate(entry) * rows
        return lo, lo + rows


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
