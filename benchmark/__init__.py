"""The benchmark of ``emfusion_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on one card. Everything that belongs to
one configuration, traffic mix, per-layer metric or cell's limits is a file
of its own (``configs/``, ``traffic/``, ``metrics/``, ``limits/``), found by
the name the manifest gives. ``reference/`` is the plain reference that
decides ``correct``; it imports nothing of the port.
"""
