"""Benchmark of the PyTorch and CUDA port, ``pbte_tpu_torch``: data-driven
cells (``BENCHMARK.json``, ``configs/``, ``traffic/``, ``workloads/``,
``metrics/``, ``costs/``) and a plain reference (``reference/``). Entry:
``python3 pbte_bench/run.py`` (see its docstring)."""
