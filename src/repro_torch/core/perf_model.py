"""A copy of ``repro.core.perf_model``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

alpha-beta performance models (paper Eqs. 7-9) and their composition into
per-stage layer models (Eqs. 1-4, 10-11).

All times are SECONDS. Workload units follow the paper:
  * GEMM      x = m*k*n          (product of the three GEMM dims)
  * attention y = N_h B S^2 (d_k + d_v)
  * comm      z = bytes on the wire per device

The paper fits these with least squares on microbenchmarks (Fig. 7,
R^2 > 0.994); ``fit_alpha_beta`` reproduces that procedure and
``benchmarks/perf_model_fit.py`` validates linearity on this host's
measured GEMMs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DepClusterConfig, ModelConfig

# ---------------------------------------------------------------------------
# alpha-beta primitive
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlphaBeta:
    """t(x) = alpha + beta * x  (alpha: fixed overhead [s], beta: [s/unit])."""

    alpha: float
    beta: float

    def __call__(self, x: float) -> float:
        return self.alpha + self.beta * x

    def scaled(self, count: float) -> "AlphaBeta":
        """count back-to-back invocations: count*alpha + count*beta*x'."""
        return AlphaBeta(self.alpha * count, self.beta * count)

    def as_dict(self) -> dict:
        return {"alpha": self.alpha, "beta": self.beta}

    @staticmethod
    def from_dict(d: dict) -> "AlphaBeta":
        return AlphaBeta(float(d["alpha"]), float(d["beta"]))


def fit_alpha_beta(xs: Sequence[float], ts: Sequence[float]) -> Tuple[AlphaBeta, float]:
    """Least-squares fit of t = alpha + beta*x; returns (model, R^2)."""
    x = np.asarray(xs, dtype=np.float64)
    t = np.asarray(ts, dtype=np.float64)
    A = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    pred = alpha + beta * x
    ss_res = float(np.sum((t - pred) ** 2))
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return AlphaBeta(alpha, beta), r2


# ---------------------------------------------------------------------------
# Hardware profiles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareProfile:
    """Per-device alpha-beta models for the primitive operations.

    ``decode`` is an optional FOURTH primitive: single-query ragged
    decode attention, fitted in BYTES-STREAMED units (z = sum(lengths) *
    kv_heads * (d_k + d_v) * dtype_bytes). Decode attention is
    bandwidth-bound — one query streams the whole KV cache — so reusing
    the prefill attention fit (FLOP-shaped, compute-bound regime)
    systematically mis-slopes it. Profiles without a decode fit fall
    back to the prefill attention model (pre-PR-6 behaviour)."""

    name: str
    gemm: AlphaBeta     # x = m*k*n
    attn: AlphaBeta     # y = N_h B S^2 (d_k + d_v)
    comm: AlphaBeta     # z = bytes per device on the a2e/e2a path
    decode: Optional[AlphaBeta] = None   # z = KV bytes streamed

    @staticmethod
    def from_peaks(name: str, *, peak_flops: float, link_bw: float,
                   gemm_eff: float = 0.6, attn_eff: float = 0.35,
                   launch_overhead: float = 5e-6,
                   comm_overhead: float = 15e-6) -> "HardwareProfile":
        """Analytic profile from peak numbers. ``peak_flops`` counts 2 FLOPs
        per MAC, so beta_gm = 2 / (eff * peak) per m*k*n unit."""
        return HardwareProfile(
            name=name,
            gemm=AlphaBeta(launch_overhead, 2.0 / (gemm_eff * peak_flops)),
            attn=AlphaBeta(launch_overhead, 2.0 / (attn_eff * peak_flops)),
            comm=AlphaBeta(comm_overhead, 1.0 / link_bw),
        )

    def as_dict(self) -> dict:
        """JSON-safe representation. ``json`` serializes floats with
        ``repr``, which round-trips IEEE doubles exactly, so
        ``from_dict(as_dict())`` is bit-for-bit."""
        out = {"name": self.name, "gemm": self.gemm.as_dict(),
               "attn": self.attn.as_dict(), "comm": self.comm.as_dict()}
        if self.decode is not None:
            out["decode"] = self.decode.as_dict()
        return out

    @staticmethod
    def from_dict(d: dict) -> "HardwareProfile":
        return HardwareProfile(
            name=str(d["name"]),
            gemm=AlphaBeta.from_dict(d["gemm"]),
            attn=AlphaBeta.from_dict(d["attn"]),
            comm=AlphaBeta.from_dict(d["comm"]),
            decode=(AlphaBeta.from_dict(d["decode"])
                    if d.get("decode") is not None else None),
        )

    def scaled(self, ratio: float, *, name: Optional[str] = None
               ) -> "HardwareProfile":
        """Uniformly rescale every primitive by ``ratio`` (> 1 = slower).
        Used by drift recalibration: a uniform rescale leaves the solver's
        argmax unchanged but brings modeled makespans back onto the
        measured wall-times."""
        return self.scaled_by({"gemm": ratio, "attn": ratio,
                               "comm": ratio}, name=name)

    def scaled_by(self, ratios: Dict[str, float], *,
                  name: Optional[str] = None) -> "HardwareProfile":
        """Rescale each primitive by its own ratio (missing keys keep a
        primitive unchanged). Per-primitive drift attribution uses this
        to retune alpha_c/beta_c (comm) separately from the GEMM and
        attention terms — unlike the uniform ``scaled``, this CAN move
        the solver's argmax, which is the point."""
        def sc(m: AlphaBeta, kind: str) -> AlphaBeta:
            r = float(ratios.get(kind, 1.0))
            return AlphaBeta(m.alpha * r, m.beta * r)
        # drift attribution tags decode tasks with the attn class, so the
        # decode fit follows the attn ratio unless given one of its own
        decode = None
        if self.decode is not None:
            r = float(ratios.get("decode", ratios.get("attn", 1.0)))
            decode = AlphaBeta(self.decode.alpha * r, self.decode.beta * r)
        return HardwareProfile(name=name or self.name,
                               gemm=sc(self.gemm, "gemm"),
                               attn=sc(self.attn, "attn"),
                               comm=sc(self.comm, "comm"),
                               decode=decode)


# TPU v5e analytic target (roofline constants from the assignment):
# 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI. The a2e all_to_all
# moves z bytes per device over ICI; with 2 bidirectional links usable on a
# torus axis we take ~45 GB/s effective per device.
TPU_V5E = HardwareProfile.from_peaks(
    "tpu_v5e", peak_flops=197e12, link_bw=45e9)

# The paper's Testbed A fit (Fig. 7 caption, times converted ms -> s):
# alpha_gm=0.17ms, beta_gm=8.59e-11 ms/unit -> 8.59e-14 s per m*k*n
# (~23 TFLOP/s effective, consistent with A6000 fp16); attention likewise.
# comm (eg=4,ag=4): alpha=0.37ms, beta=2.55e-6 ms/B -> 2.55e-9 s/B
# (~0.4 GB/s effective per-pair NCCL over shared PCIe — this is what makes
# communication a first-order term in the paper's testbeds).
PAPER_A6000 = HardwareProfile(
    "paper_a6000",
    gemm=AlphaBeta(0.17e-3, 8.59e-14),
    attn=AlphaBeta(0.15e-3, 1.54e-14),
    comm=AlphaBeta(0.37e-3, 2.55e-9),
)

PROFILES = {p.name: p for p in (TPU_V5E, PAPER_A6000)}


def register_profile(profile: HardwareProfile,
                     overwrite: bool = True) -> HardwareProfile:
    """Add a (typically calibrated) profile to the in-process registry so
    planners and CLIs can refer to it by name."""
    if not overwrite and profile.name in PROFILES:
        raise ValueError(f"profile {profile.name!r} already registered")
    PROFILES[profile.name] = profile
    return profile


def get_profile(name: str) -> HardwareProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; registered: "
                       f"{sorted(PROFILES)}") from None


# ---------------------------------------------------------------------------
# DEP stage models (Eqs. 1-4 composed with Eqs. 7-9)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DepModelSpec:
    """The scheduler's view of one transformer layer of an MoE model
    (paper Table 1 notation)."""

    S: int              # sequence length per sample
    M: int              # embedding size
    H: int              # expert FFN hidden size
    E: int              # global routed experts
    top_k: int
    n_shared: int       # N_shared
    shared_H: int       # hidden size of each shared expert
    T: int              # number of (MoE) layers
    n_heads: int
    d_k: int
    d_v: int
    n_kv_heads: int = 0  # 0 -> MHA (= n_heads)
    # > 0: decode-phase attention — each of the S tokens per sample is a
    # single query streaming `decode_context` cached KV positions (the
    # occupancy histogram's mean context), so the attention workload is
    # LINEAR in context instead of the prefill S^2 term. 0 = prefill.
    decode_context: float = 0.0

    @staticmethod
    def from_model_config(cfg: ModelConfig, S: int) -> "DepModelSpec":
        assert cfg.moe is not None, "DEP schedules MoE models"
        m = cfg.moe
        return DepModelSpec(
            S=S, M=cfg.d_model, H=m.expert_ffn_dim, E=m.num_experts,
            top_k=m.top_k, n_shared=m.num_shared_experts,
            shared_H=m.shared_ffn_dim or m.expert_ffn_dim,
            T=len(cfg.moe_layer_indices()),
            n_heads=cfg.num_heads, d_k=cfg.head_dim, d_v=cfg.head_dim,
            n_kv_heads=cfg.num_kv_heads,
        )


@dataclass(frozen=True)
class StageModels:
    """Linear per-stage models t_a, t_s, t_e, t_c as functions of m_a / m_e.

    t_a(m_a): attention segment on one AG device, m_a samples (Eq. 1/10/11)
    t_s(m_a): shared-expert segment on one AG device (Eq. 2)
    t_e(m_e): routed-expert chunk on one EG device (Eq. 3; note: we keep the
              factor 3 from Eq. 3 that the prose's alpha_e/beta_e drops)
    t_c(m_e): one direction of a2e/e2a for one m_e chunk (Eq. 4/9)
    t_rep(m_a): replicated hot-expert segment on one AG device — only set
              when the models were built under a ``SkewSummary`` with
              replication (rho > 0); None = no REP stage modeled
    skew:     the quantized skew fingerprint these models were scaled by
              (None = uniform routing assumed)
    """

    t_a: AlphaBeta
    t_s: AlphaBeta
    t_e: AlphaBeta
    t_c: AlphaBeta
    spec: DepModelSpec
    cluster: DepClusterConfig
    t_rep: Optional[AlphaBeta] = None
    skew: Optional[object] = None      # repro.placement.SkewSummary

    # -- token-conservation constraint (paper SS4.2):
    #    m_a * ag * top_k * S = m_e * r2 * E
    def me_from_ma(self, m_a: float, r2: int) -> float:
        s = self.spec
        return m_a * self.cluster.ag * s.top_k * s.S / (r2 * s.E)

    def ma_from_me(self, m_e: float, r2: int) -> float:
        s = self.spec
        return m_e * r2 * s.E / (self.cluster.ag * s.top_k * s.S)


def build_stage_models(hw: HardwareProfile, spec: DepModelSpec,
                       cluster: DepClusterConfig,
                       skew=None) -> StageModels:
    """Compose the primitive alpha-beta models into per-stage linear models.

    ``skew`` (a ``repro.placement.SkewSummary``, optional) makes the
    stage models reflect OBSERVED routing skew instead of the uniform
    assumption the paper's Eqs. 3-4 make:

      * t_e scales by ``kappa`` — the EXP lane finishes when its
        most-loaded rank does, and under skewed routing the worst rank
        holds ``kappa`` x the mean cold load;
      * t_c scales by ``(1 - rho)`` — tokens routed to replicated hot
        experts are computed on their attention rank and never cross
        the A2E/E2A wire;
      * ``t_rep`` appears when ``rho > 0``: the hot-expert FFN segment
        each AG rank runs locally (3 GEMMs over the rho fraction of
        this rank's routed assignments).

    ``skew=None`` (or a uniform summary) reproduces the pre-skew models
    exactly."""
    s, c = spec, cluster
    if skew is not None and getattr(skew, "is_uniform", False):
        skew = None
    kv_heads = s.n_kv_heads or s.n_heads

    # --- attention (Eq. 1): 4 projections + self-attention -----------------
    # q/o projections: m_a*S x M x (n_heads*d)  |  k/v: m_a*S x M x (kv*d)
    # prefill: S queries x S keys per sample (the paper's S^2 unit).
    # decode (decode_context > 0): each token is ONE query over the cached
    # context — the term the ragged kernel makes proportional to actual
    # occupancy — so the workload is S * mean_context, linear in context.
    if s.decode_context > 0 and hw.decode is not None:
        # dedicated decode fit: bytes of KV streamed per sample (the
        # ragged kernel reads kv_heads, not n_heads, rows — GQA shares
        # them across the query heads)
        attn_model = hw.decode
        attn_units = (s.S * s.decode_context * kv_heads
                      * (s.d_k + s.d_v) * c.dtype_bytes)
    elif s.decode_context > 0:
        attn_model = hw.attn
        attn_units = s.S * s.decode_context * s.n_heads * (s.d_k + s.d_v)
    else:
        attn_model = hw.attn
        attn_units = (s.S ** 2) * s.n_heads * (s.d_k + s.d_v)
    beta_a = hw.gemm.beta * (
        s.S * s.M * s.n_heads * s.d_k          # Q proj
        + s.S * s.M * kv_heads * s.d_k         # K proj
        + s.S * s.M * kv_heads * s.d_v         # V proj
        + s.S * s.M * s.n_heads * s.d_v        # O proj
    ) + attn_model.beta * attn_units
    alpha_a = 4 * hw.gemm.alpha + attn_model.alpha
    t_a = AlphaBeta(alpha_a, beta_a)

    # --- shared expert (Eq. 2): 3 N_shared GEMMs of m_a*S x M x H ----------
    t_s = AlphaBeta(3 * s.n_shared * hw.gemm.alpha,
                    3 * s.n_shared * hw.gemm.beta * s.S * s.M * s.shared_H)

    # --- routed experts (Eq. 3): 3 (E/eg) GEMMs of m_e x M x H -------------
    # Under skew the lane is bound by its most-loaded rank: kappa x the
    # mean per-rank cold load (kappa = 1 when balanced).
    kappa = float(getattr(skew, "kappa", 1.0)) if skew is not None else 1.0
    rho = float(getattr(skew, "rho", 0.0)) if skew is not None else 0.0
    e_per_dev = s.E / c.eg
    t_e = AlphaBeta(3 * e_per_dev * hw.gemm.alpha,
                    3 * e_per_dev * hw.gemm.beta * s.M * s.H * kappa)

    # --- a2e / e2a (Eq. 4): z = (E/eg) * m_e * M elements per device -------
    # Hot-replica tokens (rho of the routed volume) stay on their AG rank.
    t_c = AlphaBeta(hw.comm.alpha,
                    hw.comm.beta * e_per_dev * s.M * c.dtype_bytes
                    * (1.0 - rho))

    # --- replicated hot experts: 3 GEMMs over rho of this AG rank's
    # routed assignments (m_a * S tokens x top_k), each M x H -------------
    t_rep = None
    if rho > 0.0:
        t_rep = AlphaBeta(3 * hw.gemm.alpha,
                          3 * hw.gemm.beta * s.S * s.top_k * rho
                          * s.M * s.H)

    return StageModels(t_a=t_a, t_s=t_s, t_e=t_e, t_c=t_c,
                       spec=spec, cluster=cluster, t_rep=t_rep, skew=skew)


def fit_profile(measured: dict, name: str = "calibrated"
                ) -> Tuple[HardwareProfile, Dict[str, float]]:
    """Least-squares fit a HardwareProfile from measured (x, t) samples.

    ``measured`` maps {"gemm": (xs, ts), "attn": (xs, ts), "comm": (zs, ts)}
    in the primitive units of this module's header. Returns the profile and
    the per-primitive R^2 of each fit (the paper's Fig. 7 quality gate).
    """
    models, r2s = {}, {}
    for kind in ("gemm", "attn", "comm"):
        models[kind], r2s[kind] = fit_alpha_beta(*measured[kind])
    decode = None
    if "decode" in measured:    # optional fourth primitive
        decode, r2s["decode"] = fit_alpha_beta(*measured["decode"])
    hw = HardwareProfile(name, gemm=models["gemm"], attn=models["attn"],
                         comm=models["comm"], decode=decode)
    return hw, r2s


def calibrated_stage_models(measured: dict, spec: DepModelSpec,
                            cluster: DepClusterConfig) -> StageModels:
    """Build StageModels from measured (x, t) samples.

    ``measured`` maps {"gemm": (xs, ts), "attn": (xs, ts), "comm": (zs, ts)}.
    """
    hw, _ = fit_profile(measured)
    return build_stage_models(hw, spec, cluster)
