"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on the H100.

``run.py`` runs one cell of ``BENCHMARK.json``.  Everything a cell needs is
found by name: its configuration, traffic mix, driver, plain reference,
per-layer metric readers and limits (``cell.py``).
"""
