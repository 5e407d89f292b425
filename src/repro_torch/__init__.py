"""PyTorch + CUDA port of the ``repro`` serving system for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``serve/``, ``launch/``) so each module's counterpart sits
at the same path.  It imports ``torch`` and numpy only: never ``jax`` and nothing of
the reference package.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
