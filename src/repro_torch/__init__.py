"""PyTorch / CUDA port of the ``repro`` package (the JAX reference).

The same layout and names as ``repro``: ``repro_torch/core/rounds.py`` is
the counterpart of ``repro/core/rounds.py``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.  The package imports no JAX and
nothing of ``repro``; it keeps its own copy of what it needs.
"""
