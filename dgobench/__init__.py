"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m dgobench.run --workload rs680.closed --seed 7 --seconds 10 --trace 0

Everything a cell needs is found by name: its configuration in
``configs/<name>.json`` with the plain reference beside it
(``configs/<name>.py``), its traffic mix in ``traffic/<name>.json``, each
per-layer metric's reader in ``metrics/<metric>.py`` and each objective's
operation count in ``counts/<problem>.py``.  See ``README.md``.
"""
