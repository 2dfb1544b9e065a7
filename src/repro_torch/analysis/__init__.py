"""Static verification of the port: properties no runtime test can
exhaustively cover, proved on the artifacts directly (the counterpart of
``repro.analysis``).

Three passes, one CLI (``python -m repro_torch.analysis [--check]
[--fast] [-q] [passes...]``):

  graphcheck    task-graph verifier (a copy of the reference's): dep
                soundness, lane races, deadlock, capacity conservation,
                hint validity over the policies x Table-5/7 shapes sweep.
  kernelcheck   bounds checker for the CUDA kernels' index arithmetic:
                the kernel packages' Python mirrors of the ``.cu`` index
                math over the whole grid x boundary ledger states, no
                kernel launch.
  capturelint   CUDA-graph hygiene (in place of the reference's jitlint):
                graph- and plan-key types hashable by value, host syncs in
                the modules a step runs, the DEP walker's tracer rule.

The planner (``FinDEPPlanner(validate=True)``) and the engine
(``ServingEngine(validate=True)``) run graphcheck at plan time, so a bad
lowering or a tampered hint vector fails before it reaches the executor.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.report import AnalysisError, Violation, codes

PASSES = ("graphcheck", "kernelcheck", "capturelint")

__all__ = ["AnalysisError", "PASSES", "Violation", "codes", "run_all"]


def run_all(passes: Tuple[str, ...] = PASSES, fast: bool = False,
            log=None) -> Tuple[Dict[str, List[Violation]], Dict]:
    """Run the requested passes; returns ({pass: violations}, info)."""
    import importlib

    results: Dict[str, List[Violation]] = {}
    info: Dict = {}
    for name in passes:
        if name not in PASSES:
            raise ValueError(f"unknown pass {name!r}; choose from {PASSES}")
        mod = importlib.import_module(f"repro_torch.analysis.{name}")
        violations, meta = mod.run(fast=fast, log=log)
        results[name] = violations
        info.update({f"{name}.{k}": v for k, v in meta.items()})
    return results, info
