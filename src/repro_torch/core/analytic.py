"""A copy of ``repro.core.analytic``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Closed-form makespan / throughput model of the FinDEP pipeline.

Implements the paper's timestamp recurrences for the ASAS order
(Section 4.2, Fig. 5) and the objective of Eq. 13 / Eq. 17:

    X(m_a) = t_a(m_a) + t_s(m_a)
    Y(m_e) = max(t_e(m_e), t_a2e(m_e))
    F      = max(X, r2 * Y)
    G      = t_a + t_a2e + t_e + t_e2a + (r2 - 1) * Y            (Eq. 12)

    D = (T-1)*max(G, r1*F) + max(X, G) + (r2-1)*Y + (r1-1)*F     (Eq. 13 denom)

and an analogous closed form for the AASS order derived with the same
deterministic tandem-queue decomposition. ``repro.core.simulator`` is the
exact event-order ground truth; tests quantify how tight these closed forms
are (the paper itself treats Eq. 13 as the objective of its solver).

All times in seconds.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.perf_model import StageModels

ORDER_ASAS = "ASAS"
ORDER_AASS = "AASS"
ORDERS = (ORDER_ASAS, ORDER_AASS)


@dataclass(frozen=True)
class StageTimes:
    """Concrete per-segment durations for a chosen (m_a, m_e)."""

    t_a: float   # one attention segment (m_a samples) on AG
    t_s: float   # one shared-expert segment (m_a samples) on AG
    t_e: float   # one routed-expert chunk (m_e tokens/expert) on EG
    t_c: float   # one direction of a2e/e2a for one chunk
    t_rep: float = 0.0   # replicated hot-expert segment (m_a samples) on AG

    @staticmethod
    def from_models(models: StageModels, m_a: float, m_e: float) -> "StageTimes":
        t_rep_model = getattr(models, "t_rep", None)
        return StageTimes(
            t_a=models.t_a(m_a),
            t_s=models.t_s(m_a) if models.spec.n_shared > 0 else 0.0,
            t_e=models.t_e(m_e),
            t_c=models.t_c(m_e),
            t_rep=t_rep_model(m_a) if t_rep_model is not None else 0.0,
        )


@dataclass(frozen=True)
class XYFG:
    X: float
    Y: float
    F: float
    G: float


def xyfg(st: StageTimes, r1: int, r2: int) -> XYFG:
    # t_rep (replicated hot-expert segment) runs on AG between the gate
    # and the shared expert, so it joins X: the per-micro-batch AG work.
    X = st.t_a + st.t_rep + st.t_s
    Y = max(st.t_e, st.t_c)
    F = max(X, r2 * Y)
    G = st.t_a + 2.0 * st.t_c + st.t_e + (r2 - 1) * Y
    return XYFG(X=X, Y=Y, F=F, G=G)


def makespan_asas(st: StageTimes, T: int, r1: int, r2: int) -> float:
    """Eq. 13 denominator (the paper's closed-form ASAS makespan)."""
    v = xyfg(st, r1, r2)
    return ((T - 1) * max(v.G, r1 * v.F)
            + max(v.X, v.G)
            + (r2 - 1) * v.Y
            + (r1 - 1) * v.F)


def makespan_aass(st: StageTimes, T: int, r1: int, r2: int) -> float:
    """Closed-form AASS makespan via the same decomposition.

    NOTE: unlike the ASAS form (Eq. 13, a guaranteed upper bound), this is
    a two-sided approximation (within [0.85, 1.0] x exact over randomized
    workloads) — cross-micro-batch queueing on the links has no clean
    closed form under AASS. The solver's default "hybrid" objective
    re-ranks the analytic top-K with the exact event simulator, so this
    only needs to rank candidates sensibly.

    Within a layer AG runs A_0..A_{r1-1} then S_0..S_{r1-1}; chunk (i, j)
    enters the a2e->expert->e2a deterministic tandem at (i+1)*t_a after the
    layer's AG start. Departure of the last chunk from the tandem is
        2*t_c + t_e + max(r1*t_a + (r2-1)*Y, t_a + (r1*r2 - 1)*Y).
    The per-layer steady-state offset is max(AG work, tandem rate, chain):
        P = max(r1*(t_a + t_s), r1*r2*Y, G)
    """
    v = xyfg(st, r1, r2)
    P = max(r1 * v.X, r1 * r2 * v.Y, v.G)
    tandem_last = (2.0 * st.t_c + st.t_e
                   + max(r1 * st.t_a + (r2 - 1) * v.Y,
                         st.t_a + (r1 * r2 - 1) * v.Y))
    shared_last = r1 * st.t_a + r1 * (st.t_rep + st.t_s)
    return (T - 1) * P + max(tandem_last, shared_last)


def makespan_closed_form(st: StageTimes, T: int, r1: int, r2: int,
                         order: str) -> float:
    if order == ORDER_ASAS:
        return makespan_asas(st, T, r1, r2)
    if order == ORDER_AASS:
        return makespan_aass(st, T, r1, r2)
    raise ValueError(f"unknown order {order!r}")


def throughput(models: StageModels, T: int, m_a: float, r1: int, r2: int,
               order: str = ORDER_ASAS, makespan: float | None = None) -> float:
    """Tokens/second (Eq. 6 numerator r1*m_a*ag, scaled by S to tokens)."""
    m_e = models.me_from_ma(m_a, r2)
    if makespan is None:
        st = StageTimes.from_models(models, m_a, m_e)
        makespan = makespan_closed_form(st, T, r1, r2, order)
    tokens = r1 * m_a * models.cluster.ag * models.spec.S
    return tokens / makespan


# ---------------------------------------------------------------------------
# Baseline closed forms (naive DEP / PPPipe) -- see also core.simulator for
# the exact event-order versions.
# ---------------------------------------------------------------------------


def makespan_naive(st: StageTimes, T: int) -> float:
    """Strictly sequential DEP: per layer A -> S -> a2e -> E -> e2a."""
    return T * (st.t_a + st.t_rep + st.t_s + st.t_c + st.t_e + st.t_c)


def makespan_pppipe(st: StageTimes, T: int, r1: int) -> float:
    """PPPipe (MegaScale-Infer): r1 micro-batches, shared expert folded into
    the attention stage (a2e waits for shared), no r2 chunking.

    Stage chain per micro-batch: [A+S] -> a2e -> E -> e2a with deterministic
    tandem recursion; per-layer offset max(chain, r1 * bottleneck stage).
    """
    stage_ag = st.t_a + st.t_rep + st.t_s
    chain = stage_ag + st.t_c + st.t_e + st.t_c
    bottleneck = max(stage_ag, st.t_c, st.t_e)
    P = max(chain, r1 * bottleneck)
    fill = chain + (r1 - 1) * bottleneck
    return (T - 1) * P + fill
