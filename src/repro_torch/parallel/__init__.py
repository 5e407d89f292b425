"""Parallelism of the port (counterpart of ``repro/parallel``): the
logical-axis sharding rules and their placements on a ``DeviceMesh``."""

from repro_torch.parallel import sharding

__all__ = ["sharding"]
