"""Synchronous vs asynchronous operator scheduling over a pool axis of a
``DeviceMesh`` (paper §4, Fig. 3; counterpart of
``repro/core/scheduler.py``).

On a CPU framework the scheduler picks which thread pool runs each ready
operator.  On a mesh the schedule is set by where independent heavy ops
run:

* synchronous  = the branches one after another, each on every device
  (the paper's one big pool): ``run_sync``;
* asynchronous = branch ``i`` on device group ``i`` of the ``pool`` axis,
  all at once, the results summed across the groups: ``run_async``;
* Fig. 6's middle ground = ``p`` pools, each running its
  ``groups / p`` branches in turn: ``hybrid_pools``.

The reference expresses the last two with ``shard_map`` and a ``psum``.
The port runs SPMD ranks (every rank calls the function with the same
arguments, as under ``torchrun``): the pool rank at coordinate ``i``
slices its own branches out of the stacked tree, which every rank holds
whole (the reference's inputs before ``shard_map`` splits them), and
``all_reduce`` over ``mesh.get_group(pool_axis)`` sums them.  Ranks along
the other axes compute the same thing and hold the same result: the
reference's replicated ``P()`` output.  ``branch_fn(params_i, x)`` is
plain torch on local tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import module as m


def _branches(tree: Any) -> int:
    return int(m.tree_leaves(tree)[0].shape[0])


def _sum_branches(branch_fn: Callable, stacked_params, x: torch.Tensor,
                  rows) -> torch.Tensor:
    out = None
    for i in rows:
        y = branch_fn(m.tree_map(lambda t: t[i], stacked_params), x)
        out = y if out is None else out + y
    return out


def run_sync(branch_fn: Callable, stacked_params,
             x: torch.Tensor) -> torch.Tensor:
    """Sequential (synchronous) schedule: ``sum_i f(params_i, x)``, one
    branch at a time in a static loop (the one-big-pool baseline)."""
    return _sum_branches(branch_fn, stacked_params, x,
                         range(_branches(stacked_params)))


def _pool(mesh, pool_axis: str):
    names = list(mesh.mesh_dim_names)
    if pool_axis not in names:
        raise ValueError(f"mesh axes {names} have no {pool_axis!r} axis")
    return int(mesh.size(names.index(pool_axis))), \
        int(mesh.get_local_rank(pool_axis)), mesh.get_group(pool_axis)


def run_async(branch_fn: Callable, stacked_params, x: torch.Tensor, *,
              mesh, pool_axis: str = "pool") -> torch.Tensor:
    """Asynchronous schedule: the rank at coordinate ``i`` of
    ``pool_axis`` runs branch ``i``; the results are summed with an
    ``all_reduce`` over that axis.  The leading (branch) dim of
    ``stacked_params`` must equal the pool-axis size."""
    import torch.distributed as dist

    n = _branches(stacked_params)
    size, coord, group = _pool(mesh, pool_axis)
    assert n == size, (n, pool_axis, size)
    y = branch_fn(m.tree_map(lambda t: t[coord], stacked_params),
                  x).contiguous()
    dist.all_reduce(y, group=group)
    return y


def hybrid_pools(branch_fn: Callable, stacked_params, x: torch.Tensor, *,
                 mesh, pool_axis: str = "pool") -> torch.Tensor:
    """Paper Fig. 6's middle ground: ``p`` pools, the pool at coordinate
    ``i`` running branches ``i * groups/p .. (i+1) * groups/p - 1`` in
    turn, then an ``all_reduce`` over ``pool_axis``.  ``groups % p`` must
    be 0.  (The reference's ``inner`` argument, which it never reads, is
    not taken.)"""
    import torch.distributed as dist

    groups = _branches(stacked_params)
    p, coord, group = _pool(mesh, pool_axis)
    assert groups % p == 0, (groups, p)
    per = groups // p
    y = _sum_branches(branch_fn, stacked_params, x,
                      range(coord * per, (coord + 1) * per)).contiguous()
    dist.all_reduce(y, group=group)
    return y
