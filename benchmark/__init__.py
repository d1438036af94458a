"""The benchmark of the PyTorch and CUDA port (``wrf_partmc_tpu_torch``).

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process runs one cell once on the card and prints one JSON line.
What a cell is, how it is built, what it reports and how its output is
judged is found by name from files of their own: ``BENCHMARK.json`` at
the root, ``configs/``, ``workloads/``, ``limits/``, ``builders/`` and
``metrics/`` here, on the plain reference in ``reference/``.
``README.md`` says how to add one of each.
"""
