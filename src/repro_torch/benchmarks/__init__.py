"""The port's benchmark scripts (counterparts of the repository's
``benchmarks/`` that run on the card), run as
``python -m repro_torch.benchmarks.<name>``."""
