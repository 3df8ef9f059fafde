"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json``,
``metrics/<metric>.py`` and ``drivers/<driver>.py``.  Nothing here imports
JAX or the JAX package ``repro``; ``reference/`` imports nothing of
``repro_torch`` either.
"""
