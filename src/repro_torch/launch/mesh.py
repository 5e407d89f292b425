"""Mesh descriptors: the shapes and axis names of the production and the
tuner's meshes, without devices (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` gives 16 x 16 = 256 devices per pod
(``("data", "model")``), and 2 x 16 x 16 = 512 for two pods
(``("pod", "data", "model")``).  ``make_tuned_mesh`` factors the model
axis into the paper tuner's ``("data", "pool", "intra")`` axes (and
``"pod"`` before them) when a plan wants ``pools > 1``, e.g. grok's 8
experts on a 16-wide axis.  The sharding rules
(``parallel/sharding.Rules``) and the tuner (``core/tuner.make_rules``)
read only ``.shape`` and ``.axis_names``; building a ``DeviceMesh`` of
them is the multi-device work still to come.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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
    return "x".join(f"{k}={v}" for k, v in mesh.shape.items())
