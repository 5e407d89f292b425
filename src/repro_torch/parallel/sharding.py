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

**Sharded training** (``with axis_rules(rules)`` on a ``DeviceMesh``,
``live_rules()``): each rank holds its slice of every parameter
(``place``; ``gather`` is the inverse), tagged with its ``Placement``,
and the model code changes layouts by explicit collectives on the mesh's
process groups (``Rules.group``), each a ``torch.autograd.Function``:

* ``gather_along`` (all-gather forward, reduce-scatter backward): the
  FSDP pair (``full``: a weight's dims sharded with a data axis,
  gathered at each use), ``sp_boundary`` (the sequence over ``SEQ``)
  and context-parallel attention's KV gather;
* ``scatter_along`` (reduce-scatter forward, all-gather backward): a
  row-parallel product's output back onto the sequence shards;
* ``reduce_over`` (all-reduce forward, identity backward) and
  ``copy_over`` (identity forward, all-reduce backward): the Megatron
  pair around a tensor-parallel region; ``tp_in`` / ``tp_out`` pick
  the pair or, under sequence sharding, ``sp_boundary`` /
  ``scatter_along``.

The reference's ``shard`` constraints become these (GSPMD inserts the
collectives there; the port names them at each call site):
``layers.embed``'s (``src/repro/models/layers.py:87``) is ``tp_out``
after the vocab-parallel lookup; ``logits``' (``:115``) none, the
logits stay vocab-sharded and ``cross_entropy`` reduces their max,
sum of exponentials and label logit over the model axis; ``mlp``'s
(``:135-139``) ``tp_in`` before the column-parallel ``w_gate``/``w_up``
and ``tp_out`` after the row-parallel ``w_down``; ``chunked_attention``'s
KV repeat (``models/attention.py:84-85``) none, the kernel groups the
local KV heads; ``apply``'s (``:587-597``) head-parallel projections,
the KV heads a rank's query heads group to (a slice of replicated
``wk``/``wv`` when ``KV_HEADS`` falls back), and under context
parallelism ``gather_along`` of K and V over ``SEQ`` in
``cp_attention``; its output's (``:616-629``) ``tp_out``.  Each
``sp_boundary`` of ``transformer.py`` is ``tp_in`` after the norm.
``shard`` itself stays for the one real split: a replicated input
(the batch, its sequence under context parallelism) cut to this rank's
rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

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

    def group(self, axis: MeshAxis):
        """The process group over mesh axis ``axis`` (a tuple: over all of
        them, its ranks in row-major order of ``coordinate``).  Every
        rank makes the groups of a tuple together, at its first use on
        this ``DeviceMesh``; they live as long as the mesh does, as its
        own groups do, so a mesh made after a process group was destroyed
        and joined again gets new ones."""
        axes = axes_of(axis)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        names = list(self.mesh.mesh_dim_names)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            # a process group orders its ranks by number, which is the
            # coordinate's row-major order only for axes in mesh order
            raise NotImplementedError(
                f"mesh axes {axes} out of the mesh's order {tuple(names)}")
        groups = self.mesh.__dict__.setdefault("_tuple_groups", {})
        if axes not in groups:
            rest = [i for i in range(len(names)) if i not in idx]
            ranks = self.mesh.mesh.permute(*rest, *idx).reshape(
                -1, math.prod(self.mesh.mesh.shape[i] for i in idx))
            import torch.distributed as dist
            groups[axes] = dist.new_subgroups_by_enumeration(
                ranks.tolist())[0]
        return groups[axes]

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


def axes_of(entry: MeshAxis) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def entry_of(mesh, axes) -> MeshAxis:
    """A set of mesh axes as a spec entry in the mesh's order (None for
    none): the group of ranks that a sum over them runs on."""
    names = list(axis_sizes(mesh))
    axes = sorted(set(axes), key=names.index)
    return None if not axes else (tuple(axes) if len(axes) > 1
                                  else axes[0])


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


# ---------------------------------------------------------------------------
# Live meshes: this rank's shards and the collectives between them
# ---------------------------------------------------------------------------

def live_rules() -> Optional[Rules]:
    """The active rules when their mesh is a ``DeviceMesh`` (SPMD ranks
    that each hold shards), else None: outside a context, and on a
    descriptor (the dry-run's meta path), the model code runs as on one
    device."""
    rules = current_rules()
    if rules is None or not is_device_mesh(rules.mesh):
        return None
    return rules


@dataclasses.dataclass(eq=False)
class Placement:
    """Where a rank's tensor sits in the whole: the full ``shape``, the
    logical ``axes`` and the ``spec`` (``Rules.spec_for``) under
    ``rules``.  ``place`` tags each parameter with one (``placement``)."""

    spec: Spec
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    rules: Rules

    def entry(self, dim: int) -> MeshAxis:
        return self.spec[dim] if dim < len(self.spec) else None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return self.rules.local_shape(self.spec, self.shape)


def placement(t) -> Optional[Placement]:
    """The ``Placement`` a tensor was tagged with, or None."""
    return getattr(t, "placement", None)


def tag(t: torch.Tensor, axes, shape, rules: Rules,
        spec: Optional[Spec] = None) -> torch.Tensor:
    """Tag ``t`` (this rank's part) with its placement; ``spec``
    defaults to ``rules.spec_for(axes, shape)``."""
    if spec is None:
        spec = rules.spec_for(axes, shape)
    t.placement = Placement(tuple(spec), tuple(shape), tuple(axes), rules)
    return t


def local_part(full: torch.Tensor, spec: Spec,
               rules: Rules) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec``: every sharded dim
    narrowed to ``rules.local_range``; contiguous (a dim it keeps whole
    costs no copy)."""
    out = full
    for d in range(full.dim()):
        if (spec[d] if d < len(spec) else None) is not None:
            lo, hi = rules.local_range(spec, full.shape, d)
            out = out.narrow(d, lo, hi - lo)
    return out.contiguous()


def _walk_sorted(tree, fn, it):
    """``fn(leaf, next(it))`` over a nested dict/list tree, dict keys
    sorted (the flatten order of ``it``'s items), rebuilt as dicts and
    lists."""
    if isinstance(tree, dict):
        return {k: _walk_sorted(tree[k], fn, it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_walk_sorted(v, fn, it) for v in tree]
    return fn(tree, next(it))


def place(full_tree, defs, rules: Rules, trainable: Optional[bool] = None):
    """The full parameters (a ``ParamTree``, e.g. from
    ``models/module.params_from_numpy``, or ``init_params``) -> a
    ``ParamTree`` of this rank's slice of every leaf under ``rules``
    (``param_shardings``' specs; copies, never views of the input), each
    ``nn.Parameter`` tagged with its ``Placement``.  ``trainable``
    defaults to the input's."""
    from repro_torch.models import module as m

    full = m.tree_of(full_tree)
    leaves = m.tree_leaves(full)
    if trainable is None:
        trainable = any(t.requires_grad for t in leaves)
    specs = m.tree_leaves(param_shardings(m.axes_tree(defs),
                                          m.shapes_tree(defs), rules),
                          is_leaf=_is_spec)

    def part(t, spec):   # a copy: the step updates it in place
        t = t.detach()
        out = local_part(t, spec, rules)
        same = out.untyped_storage().data_ptr() \
            == t.untyped_storage().data_ptr()
        return out.clone() if same else out

    local = m.ParamTree(_walk_sorted(full, part, iter(specs)), trainable)
    for t, d, spec in zip(m.tree_leaves(local), m.tree_leaves(defs), specs):
        tag(t, d.axes, d.shape, rules, spec)
    return local


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def gather_tensor(t: torch.Tensor, pl: Optional[Placement] = None
                  ) -> torch.Tensor:
    """The whole of a placed tensor (``pl`` defaults to its tag): every
    sharded dim all-gathered over its axes (a collective: every rank
    calls it).  An untagged tensor is returned as it is."""
    pl = pl or placement(t)
    if pl is None:
        return t
    out = t.detach()
    for d in range(out.dim()):
        if pl.entry(d) is not None:
            out = all_gather(out, d, pl.rules.group(pl.entry(d)))
    return out.contiguous()


def gather(tree):
    """The inverse of ``place``: every leaf of ``tree`` (placed params,
    ZeRO-1 moments) whole, as a tree of plain tensors (the pytree of
    ``models/module.tree_of``); a collective."""
    from repro_torch.models import module as m

    return m.tree_map(gather_tensor, tree)


def full(p: torch.Tensor) -> torch.Tensor:
    """A weight as the model computes with it under the active rules:
    its dims sharded with a data axis (FSDP; under context parallelism
    every weight's ``d_model`` dim) all-gathered, differentiably (the
    gradient reduce-scattered back).  Untagged tensors, and everything
    outside a live context, pass through."""
    pl = placement(p)
    if pl is None or live_rules() is None:
        return p
    data = set(axes_of(pl.rules.table.get(BATCH)))
    for d in range(p.dim()):
        entry = pl.entry(d)
        if entry is not None and data & set(axes_of(entry)):
            p = gather_along(p, d, entry, pl.rules)
    return p


# -- collectives on local tensors (any dim) ----------------------------------

@contextlib.contextmanager
def _renamed_collectives():
    """torch 2.13 renames the tensor collectives (``*_single``) and warns
    on the old names; torch 2.11, on the card, has only those."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*is deprecated",
                                category=FutureWarning)
        yield


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ranks' ``x`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    with _renamed_collectives():
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of the group's ``x``, this rank's equal part along
    ``dim``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    with _renamed_collectives():
        dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The group's ``x`` reduced (``"sum"`` or ``"max"``) into a new
    tensor."""
    import torch.distributed as dist

    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.grad_scale if ctx.grad_scale != 1.0 else g,
                None, None)


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def gather_along(x, dim: int, entry: MeshAxis, rules: Rules):
    """All-gather ``x`` along ``dim`` over ``entry``'s axes; the
    backward reduce-scatters the cotangent."""
    return _GatherAlong.apply(x, dim, rules.group(entry))


def scatter_along(x, dim: int, entry: MeshAxis, rules: Rules):
    """Reduce-scatter ``x`` along ``dim`` over ``entry``'s axes; the
    backward all-gathers the cotangent."""
    return _ScatterAlong.apply(x, dim, rules.group(entry))


def reduce_over(x, entry: MeshAxis, rules: Rules, grad_scale: float = 1.0):
    """All-reduce (sum) ``x`` over ``entry``'s axes; the backward passes
    the cotangent on (times ``grad_scale``: ``1 / replicas`` where the
    ranks summed are copies)."""
    return _ReduceOver.apply(x, rules.group(entry), grad_scale)


def copy_over(x, entry: MeshAxis, rules: Rules):
    """Identity; the backward all-reduces (sums) the cotangent over
    ``entry``'s axes."""
    return _CopyOver.apply(x, rules.group(entry))


# -- the layout of one sharded step -------------------------------------------

@dataclasses.dataclass
class Layout:
    """How ``transformer.forward_train`` laid out one step's activations
    on a live mesh: ``seq``, the entry the residual stream's sequence is
    split over (Megatron-SP
    under ``seq_shard``, or context parallelism), else None; ``cp``,
    context parallelism with the sequence split (the attention gathers
    KV); ``model``, the model-parallel axes (``HEADS``' rule);
    ``vocab``, the entry of the LM head's vocab dim; ``loss``, the axes
    whose ranks hold different tokens (the loss sums over them); and
    ``grad_scale``, 1 / the ranks that hold the same tokens where the
    weights' gradients sum over them (context parallelism whose
    sequence does not divide)."""

    rules: Rules
    seq: MeshAxis
    cp: bool
    model: MeshAxis
    vocab: MeshAxis
    loss: Tuple[str, ...]
    grad_scale: float = 1.0

    @property
    def sp(self) -> bool:
        """Megatron-SP: the residual stream sequence-sharded between
        tensor-parallel regions."""
        return self.seq is not None and not self.cp


def current_layout() -> Optional[Layout]:
    return getattr(_ctx, "layout", None)


@contextlib.contextmanager
def step_layout(layout: Optional[Layout]):
    prev = getattr(_ctx, "layout", None)
    _ctx.layout = layout
    try:
        yield layout
    finally:
        _ctx.layout = prev


def _check_tp(lay: Layout, entry: MeshAxis, what: str) -> None:
    if entry is None and not lay.cp and lay.rules.mesh_size(lay.model) > 1:
        raise NotImplementedError(
            f"{what}: its model-parallel rule fell back (the dim does not "
            f"divide the model axes {axes_of(lay.model)}); the port shards "
            "it or raises")
    if lay.sp and entry is not None and axes_of(entry) != axes_of(lay.seq):
        raise NotImplementedError(
            f"{what} is sharded over {axes_of(entry)} but the sequence over "
            f"{axes_of(lay.seq)}")


def tp_in(x, entry: MeshAxis, what: str = "a weight"):
    """Enter a tensor-parallel region whose weights are sharded over
    ``entry`` (x [B,S,d]): under Megatron-SP the sequence all-gathered
    (``sp_boundary``), else ``copy_over`` (the backward sums the partial
    cotangents).  No-op without a layout or for replicated weights."""
    lay = current_layout()
    if lay is None:
        return x
    _check_tp(lay, entry, what)
    if entry is None:
        return x
    if lay.sp:
        return sp_boundary(x)
    return copy_over(x, entry, lay.rules)


def tp_out(y, entry: MeshAxis, what: str = "a weight"):
    """Leave a tensor-parallel region (y [B,S,d], a partial sum): under
    Megatron-SP reduce-scattered onto the sequence shards, else
    all-reduced (``reduce_over``)."""
    lay = current_layout()
    if lay is None or entry is None:
        return y
    if lay.sp:
        return scatter_along(y, 1, lay.seq, lay.rules)
    return reduce_over(y, entry, lay.rules)


def sp_boundary(x):
    """Megatron-SP boundary (x [B,S,D], this rank's sequence shard):
    forward all-gathers the sequence over ``SEQ``'s axes, backward
    reduce-scatters the cotangent.  A no-op outside a live context, when
    ``SEQ`` has no rule, and under context parallelism, as in the
    reference."""
    rules = live_rules()
    if rules is None or rules.table.get(SEQ) is None \
            or rules.context_parallel:
        return x
    return gather_along(x, 1, rules.table[SEQ], rules)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's constraint where it is a real split: a tensor
    every rank holds whole (the batch) cut to this rank's part of each
    dim whose logical axis has a rule that divides it.  A no-op outside
    a live context."""
    rules = live_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"{logical_axes} vs shape {tuple(x.shape)}")
    return local_part(x, rules.spec_for(logical_axes, x.shape), rules)
