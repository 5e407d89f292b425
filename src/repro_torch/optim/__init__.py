"""Optimizer of the port: AdamW with an optional int8 second moment, and
the learning-rate schedules (counterpart of ``repro/optim``)."""

from repro_torch.optim import adamw, schedule

__all__ = ["adamw", "schedule"]
