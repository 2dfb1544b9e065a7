"""The port's benchmark: serving cells of ``repro_torch`` on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line. Everything that belongs to one configuration, traffic mix,
metric or cell lives in a file of its own, found by name:
``configs/<config>.json``, ``mixes/<mix>.json``, ``metrics/<metric>.py``
(or the reader of the metric's base name, before its first dot) and
``limits/<cell>.json``. ``reference/`` holds the plain float32 models
the outputs are judged against, ``work/`` the operation and byte counts
and the chip's peaks.
"""
