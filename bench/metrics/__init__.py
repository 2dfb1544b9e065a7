"""One reader per metric: ``read(window) -> float | None``.

The harness finds ``<metric>.py``, or the reader of the metric's base
name (the part before the first dot: ``engine_host_pct.py`` reads both
``engine_host_pct.chat`` and ``engine_host_pct.longprompt``). A reader
that finds nothing to read returns None, and the metric is left out of
the result line; a share of a roofline or a peak is never reported as 0.
"""
