"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

One run of one cell: ``python ocpbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see `run.py`).
The cells, metrics and bounds are in ``BENCHMARK.json``; a configuration
is a file under ``configs/``, a traffic mix a file under ``mixes/``, the
limits of a cell's correctness check a file under ``limits/`` and a
per-layer metric family a reader under ``layers/``, each found by its
name.  ``counts/`` holds the frozen operation and byte counts and
``reference/`` the plain fp32 models that decide ``correct``.
"""
