"""Entry points of the port (counterpart of ``repro/launch``):
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train`` (``--production``: the dry-run of a cell) and
``python -m repro_torch.launch.dryrun``; ``build`` is the dry-run's
glue, and ``mesh`` its mesh descriptors and the real ``DeviceMesh`` of
data-parallel serving (``mesh.device_mesh``, ``mesh.join_process_group``)."""
