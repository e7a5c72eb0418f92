"""The benchmark of the PyTorch port (``repro_torch``): ``run.py`` runs a
cell of ``BENCHMARK.json``; ``harness/`` drives the program, ``reference/``
holds the plain reference that decides ``correct``, ``metrics/`` one
reader a per-layer metric, ``counts.py`` the operation and byte counts."""
