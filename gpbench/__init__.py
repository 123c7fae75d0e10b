"""The benchmark of stheno_torch, the PyTorch and CUDA port of stheno_tpu.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that belongs
to one configuration, traffic mix or metric sits in a file of its own
(``configs/``, ``traffic/``, ``limits/``, ``metrics/``), found by the name
``BENCHMARK.json`` gives it; the code a configuration's path needs sits in
``paths/`` (the program side), ``reference/`` (the plain float64 side) and
``work/`` (the operations and bytes the work needs), found by the
configuration's ``path``.
"""
