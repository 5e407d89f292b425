"""Entry points of the port (counterpart of ``repro/launch``):
``python -m repro_torch.launch.serve``."""
