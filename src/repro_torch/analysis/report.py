"""A copy of ``repro.analysis.report``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Shared finding types for the static-analysis passes.

Every pass (``graphcheck``, ``kernelcheck``, ``jitlint``) reports
``Violation`` records instead of raising mid-scan, so one run surfaces
every problem at once; callers that want fail-fast semantics (the
planner/engine ``validate=`` knobs, the ``--check`` CLI gate) wrap the
collected list in an ``AnalysisError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence


@dataclass(frozen=True)
class Violation:
    """One verified-property failure.

    ``pass_name`` is the reporting pass, ``code`` a stable kebab-case
    identifier for the property that failed (tests match on it),
    ``where`` the artifact (graph shape / kernel case / file:line), and
    ``message`` the human-actionable description."""

    pass_name: str
    code: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}:{self.code}] {self.where}: {self.message}"


class AnalysisError(RuntimeError):
    """Raised when a validate-mode caller hits violations: the planner's
    ``validate=True`` solve, the engine's program validation, or the CLI
    ``--check`` gate."""

    def __init__(self, violations: Sequence[Violation]):
        self.violations: List[Violation] = list(violations)
        lines = [f"{len(self.violations)} static-analysis violation(s):"]
        lines += [f"  {v}" for v in self.violations]
        super().__init__("\n".join(lines))


def codes(violations: Iterable[Violation]) -> List[str]:
    """The violation codes, in report order (test helper)."""
    return [v.code for v in violations]
