"""PyTorch/CUDA port of the ``repro`` package (FlexLink reproduction).

Laid out module for module like ``src/repro/``: every file names the
reference file it answers to.  The port imports ``torch`` and ``numpy``,
never ``jax`` and nothing of ``repro``.
"""
