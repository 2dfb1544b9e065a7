"""How ``correct`` is decided: the served tokens against the plain
float32 reference.

Once the window has closed and the engine is freed, a sample of the
greedy requests finished in the window is drawn from the seed: the one
with the most served tokens, then others in a seeded order until
``check.served_tokens`` tokens are in. The reference runs once over each
prompt and its served tokens (teacher-forced, on the same weights) and
gives the logits at every served position. A served greedy token is as
good as the reference's best up to rounding; its gap is how far its
reference logit lies below the reference's largest logit at its
position. The number compared is the mean gap over every compared
token; the widest gap is reported beside it (on these random-weight
models bf16 rounding alone moves the logits by 5-17%, so the widest gap
rests on a few near-ties and does not separate the served precision
from the one below it; see PERF.md).

The control puts the reference in the program's place at the precision
below the served one (every weight product in fp8, ``fp8_matmul``): at
each position of the same prompts and tokens, the gap of the token the
control puts first. It must exceed the limit.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.reference import common


def sample(recs: Sequence, t0: float, t1: float, seed: int,
           served_tokens: int) -> List:
    """The greedy requests finished inside [t0, t1] that the check
    compares: the one with the most served tokens first."""
    done = [r for r in recs if r.spec.greedy and r.finished
            and r.req.output and t0 <= r.req.finish_t <= t1]
    if not done:
        return []
    done.sort(key=lambda r: r.spec.index)
    longest = max(done, key=lambda r: (len(r.req.output), -r.spec.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 3]).permutation(len(rest))
    chosen, n = [longest], len(longest.req.output)
    for i in order:
        if n >= served_tokens:
            break
        chosen.append(rest[i])
        n += len(rest[i].req.output)
    return chosen


def _reference_layer(served: Dict):
    return importlib.import_module(
        f"bench.reference.{served['reference']}").layer


def teacher_forced(params, served: Dict, ref_cfg: Dict, chosen: Sequence,
                   device, mm=common.matmul) -> List[torch.Tensor]:
    """Logits [n_served, V] of each chosen request: the reference over
    its prompt and served tokens, read out where each served token was
    predicted."""
    common.strict_float32()
    seqs = [torch.tensor(r.spec.prompt + r.req.output[:-1], dtype=torch.long,
                         device=device) for r in chosen]
    start = [len(r.spec.prompt) - 1 for r in chosen]
    with torch.no_grad():
        return common.forward(params, ref_cfg, _reference_layer(served),
                              seqs, start, mm)


def gaps(ref_logits: Sequence[torch.Tensor],
         picks: Sequence[torch.Tensor]) -> torch.Tensor:
    """(reference max - reference logit of the picked token) at every
    position, all requests' positions in one float64 vector on the
    host."""
    out = []
    for logits, pick in zip(ref_logits, picks):
        best = logits.max(dim=-1).values
        got = logits.gather(1, pick[:, None].to(logits.device))[:, 0]
        out.append((best - got).double().cpu())
    return torch.cat(out)


def reading(g: torch.Tensor) -> Dict[str, float]:
    return {"mean": float(g.mean()), "widest": float(g.max())}


def served_gaps(params, served: Dict, ref_cfg: Dict, chosen: Sequence,
                device) -> Dict[str, float]:
    """The served tokens' mean and widest gap."""
    ref = teacher_forced(params, served, ref_cfg, chosen, device)
    picks = [torch.tensor(r.req.output, dtype=torch.long) for r in chosen]
    return reading(gaps(ref, picks))


def control_gaps(params, served: Dict, ref_cfg: Dict, chosen: Sequence,
                 device) -> Dict[str, Dict[str, float]]:
    """The program's reading and the fp8 control's on the same chosen
    requests, both against the float32 reference."""
    ref = teacher_forced(params, served, ref_cfg, chosen, device)
    low = teacher_forced(params, served, ref_cfg, chosen, device,
                         mm=common.fp8_matmul)
    served_picks = [torch.tensor(r.req.output, dtype=torch.long)
                    for r in chosen]
    control_picks = [x.argmax(dim=-1) for x in low]
    return {"program": reading(gaps(ref, served_picks)),
            "control": reading(gaps(ref, control_picks))}


def verdict(gap: Optional[float], limit: Optional[float],
            n_tokens: int) -> bool:
    """Correct when the check compared some tokens and the mean gap is
    within the limit."""
    return (gap is not None and limit is not None and n_tokens > 0
            and gap <= limit)
