"""Hand-written Hopper kernels of the port, one folder per kernel of the
reference's ``repro/kernels`` (``csrc/`` CUDA source, ``ops.py`` wrapper,
``ref.py`` plain PyTorch version), built by ``build.py`` at first use."""
