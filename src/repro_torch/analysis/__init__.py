"""Static verification of the port's task graphs (the ``graphcheck`` pass
of ``repro.analysis``, copied: ``report.py`` and ``graphcheck.py``).

The planner (``FinDEPPlanner(validate=True)``) and the engine
(``ServingEngine(validate=True)``) run graphcheck at plan time, so a bad
lowering or a tampered hint vector fails before it reaches the executor.
The reference's ``kernelcheck`` (over Pallas index maps) and ``jitlint``
(over traced JAX code) have no counterpart here.
"""
from __future__ import annotations

from repro_torch.analysis.report import AnalysisError, Violation, codes

__all__ = ["AnalysisError", "Violation", "codes"]
