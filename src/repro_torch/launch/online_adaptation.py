"""Paper §5.5 live: requests with varying sequence lengths arrive; the
FinDEP policy re-solves (r1, r2, order) per shape in milliseconds — with
repeated shapes served from the PlanCache — vs a static PPPipe
configuration tuned for the expected shape. The PyTorch counterpart of
``examples/online_adaptation.py``, with the same table and summary.

It runs the port's copy of the planning layer (``FinDEPPlanner``,
``PlanCache``, ``best_pppipe``, ``StageTimes``, ``simulate_pppipe``) and
uses no card: the planner is host code and computes the same plans on
any device, so this entry point takes no ``--device``.

Run:  python -m repro_torch.launch.online_adaptation
(with ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core import PAPER_A6000, FinDEPPlanner, best_pppipe
from repro_torch.core.analytic import StageTimes
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.simulator import simulate_pppipe
from repro_torch.sched import FinDEPPolicy, PlanCache


@dataclass
class Arrival:
    """One arrival of the trace: its length, the plan FinDEP resolved for
    it and the two throughputs (tokens/s)."""
    seq_len: int
    plan: object
    findep_tps: float
    pppipe_tps: float


@dataclass
class Adaptation:
    """What ``main`` printed: the static PPPipe config, every arrival, the
    aggregate speedup and the plan cache."""
    pppipe: object
    arrivals: List[Arrival] = field(default_factory=list)
    speedup: float = 0.0
    cache: PlanCache = None


def main() -> Adaptation:
    cfg = get_config("deepseek-v2-lite")
    cluster = DepClusterConfig(num_devices=8, ag=3, eg=5)
    planner = FinDEPPlanner(cfg, cluster, PAPER_A6000,
                            PlannerConfig(mem_cap_samples=4, r1_cap=4))
    cache = PlanCache(FinDEPPolicy(planner))
    T = planner.num_moe_layers()

    # static PPPipe tuned for the "expected" S = 2048
    models_ref = planner.stage_models(2048)
    pp_cfg = best_pppipe(models_ref, T, 4, r1_cap=4)
    print(f"static PPPipe config (tuned for S=2048): "
          f"m_a={pp_cfg.m_a} r1={pp_cfg.r1}")
    out = Adaptation(pppipe=pp_cfg, cache=cache)

    rng = np.random.RandomState(0)
    total_fd = total_pp = 0.0
    print(f"\n{'arrival S':>10} {'FinDEP plan':>24} {'solve ms':>9} "
          f"{'FinDEP tok/s':>13} {'static PP':>10} {'speedup':>8}")
    for _ in range(8):
        S = int(rng.choice([512, 1024, 2048, 4096, 8192]))
        plan = cache.get("prefill", S, 4)
        models = planner.stage_models(S)
        st = StageTimes.from_models(models, pp_cfg.m_a,
                                    models.me_from_ma(pp_cfg.m_a, 1))
        res = simulate_pppipe(st, T, pp_cfg.r1)
        pp_tps = pp_cfg.r1 * pp_cfg.m_a * cluster.ag * S / res.makespan
        total_fd += plan.throughput
        total_pp += pp_tps
        out.arrivals.append(Arrival(S, plan, plan.throughput, pp_tps))
        print(f"{S:>10} m_a={plan.m_a} r1={plan.r1} r2={plan.r2:>2} "
              f"{plan.order:>5} {cache.stats.solve_time_last*1e3:>8.1f} "
              f"{plan.throughput:>13.0f} {pp_tps:>10.0f} "
              f"{plan.throughput/pp_tps:>7.3f}x")
    out.speedup = total_fd / total_pp
    print(f"\naggregate speedup over the trace: "
          f"{out.speedup:.3f}x (paper Table 6: 1.00-1.24x)")
    s = cache.stats
    print(f"plan cache: {s.misses} solves + {s.hits} hits over "
          f"{s.lookups} arrivals ({s.solve_time_total*1e3:.1f} ms "
          f"total solver time)")
    return out


if __name__ == "__main__":
    main()
