"""PyTorch/CUDA port of the EARL reproduction (``src/repro/`` is the JAX
reference it is held against).

Module paths mirror the JAX package one for one. The port imports
``torch`` and never ``jax`` or ``repro``; hot-path kernels are hand-written
CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use
(``kernels/_build.py``). Entry points run on the GPU unless the caller
passes ``device="cpu"``, where every kernel wrapper uses its plain PyTorch
version instead.
"""
