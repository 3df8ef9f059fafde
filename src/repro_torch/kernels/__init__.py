"""Hand-written Hopper kernels and their plain PyTorch versions (ports of
``src/repro/kernels/``).  CUDA sources live in ``csrc/`` and are built on
first use (kernels/_nvcc.py)."""
