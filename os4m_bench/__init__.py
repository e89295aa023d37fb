"""The benchmark of the PyTorch/CUDA port of OS4M (``src/repro_torch``).

One command runs one cell (a configuration under a traffic mix) once and
prints one JSON line; see ``README.md``. Everything a cell needs is found
by name from ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
