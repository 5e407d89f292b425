"""Entry points of the port (counterpart of ``repro/launch``):
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train`` (``--production``: the dry-run of a cell) and
``python -m repro_torch.launch.dryrun``; ``build`` and ``mesh`` are the
dry-run's glue."""
