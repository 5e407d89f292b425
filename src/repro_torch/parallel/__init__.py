"""Parallelism of the port (counterpart of ``repro/parallel``): the
logical-axis sharding rules, without devices."""

from repro_torch.parallel import sharding

__all__ = ["sharding"]
