"""The port's examples (counterparts of the repository's ``examples/``),
run as ``python -m repro_torch.examples.<name>``: on the card by
default, on the CPU with ``--device cpu``."""
