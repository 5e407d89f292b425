"""Mesh descriptors: the shapes and axis names of the production and the
tuner's meshes, without devices (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` gives 16 x 16 = 256 devices per pod
(``("data", "model")``), and 2 x 16 x 16 = 512 for two pods
(``("pod", "data", "model")``).  ``make_tuned_mesh`` factors the model
axis into the paper tuner's ``("data", "pool", "intra")`` axes (and
``"pod"`` before them) when a plan wants ``pools > 1``, e.g. grok's 8
experts on a 16-wide axis.  The sharding rules
(``parallel/sharding.Rules``) and the tuner (``core/tuner.make_rules``)
read only ``.shape`` and ``.axis_names``, so the dry-run (``launch/build``,
``launch/dryrun``) runs on descriptors.

``device_mesh`` builds a real ``torch.distributed.device_mesh.DeviceMesh``
of a shape and axis names, or of a descriptor (the counterpart of the
reference's ``_make_mesh`` and ``make_tuned_mesh``, which build a
``jax.sharding.Mesh``).  It needs a joined process group:
``join_process_group`` joins one from explicit arguments or from the
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` variables
``torchrun`` sets.  Every rank runs the same program (SPMD); on the card
each rank holds ``cuda:<local rank>`` and joins over NCCL.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.parallel.sharding import axis_sizes


@dataclasses.dataclass(frozen=True)
class MeshDescriptor:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshDescriptor:
    if multi_pod:
        return MeshDescriptor(("pod", "data", "model"), (2, 16, 16))
    return MeshDescriptor(("data", "model"), (16, 16))


def make_tuned_mesh(pools: int, *, multi_pod: bool = False,
                    model_axis: int = 16,
                    data_axis: int = 16) -> MeshDescriptor:
    if pools <= 1:
        return make_production_mesh(multi_pod=multi_pod)
    if model_axis % pools:
        raise ValueError(f"pools {pools} do not divide the model axis "
                         f"{model_axis}")
    intra = model_axis // pools
    if multi_pod:
        return MeshDescriptor(("pod", "data", "pool", "intra"),
                              (2, data_axis, pools, intra))
    return MeshDescriptor(("data", "pool", "intra"),
                          (data_axis, pools, intra))


def mesh_for_plan(plan, *, multi_pod: bool = False,
                  factored: bool = False) -> MeshDescriptor:
    """The mesh a plan runs on.  ``factored=False`` keeps the production
    axes (the pool degree expressed through divisible dims only)."""
    if factored and plan.pools > 1:
        return make_tuned_mesh(plan.pools, multi_pod=multi_pod,
                               model_axis=plan.pools * plan.intra,
                               data_axis=plan.data)
    return make_production_mesh(multi_pod=multi_pod)


def describe(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in axis_sizes(mesh).items())


def join_process_group(backend: Optional[str] = None, *,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> int:
    """Join the default process group and return this process's rank.

    ``None`` arguments come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``; ``init_method`` defaults to ``env://``, which reads
    ``MASTER_ADDR`` and ``MASTER_PORT``).  ``backend`` defaults to
    ``"nccl"``; a NCCL rank takes ``cuda:<LOCAL_RANK>`` (or its rank) as
    its device and binds the group to it (``device_id``), so the NCCL
    communicator is set up here and not inside the first collective.  A
    rank that cannot join raises: no other backend is tried."""
    import torch
    import torch.distributed as dist

    backend = backend or "nccl"
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    bind = {}
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        bind["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **bind)
    return rank


def device_mesh(shape: Union[MeshDescriptor, Sequence[int]],
                axis_names: Optional[Sequence[str]] = None, *,
                device_type: str = "cuda"):
    """A ``DeviceMesh`` over the joined process group: ``shape`` sizes
    (their product the world size) named ``axis_names``, or a
    ``MeshDescriptor`` (``make_production_mesh``, ``make_tuned_mesh``)
    whose axes and sizes it takes.  Ranks fill it in row-major order, as
    the reference's meshes keep device order.  ``device_type`` is
    ``"cuda"`` unless the caller asks for ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if isinstance(shape, MeshDescriptor):
        shape, axis_names = shape.sizes, shape.axis_names
    if axis_names is None or len(axis_names) != len(shape):
        raise ValueError(f"axis names {axis_names} for mesh shape {shape}")
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axis_names))
