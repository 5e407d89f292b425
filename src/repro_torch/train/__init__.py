"""Training of the port: the single-device ``Trainer`` and preemption-safe
checkpoints (counterpart of ``repro/train``)."""
