"""A copy of ``repro.data.pipeline``, kept by the port so that it
imports nothing of the JAX package (it is numpy only); the tests hold
the two against each other.

Synthetic-but-learnable token pipeline.

Markov-chain token streams: a fixed random transition table over the vocab
gives next-token structure a model can actually learn (loss decreases),
unlike uniform noise. Deterministic per seed, sharded per host, infinite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 8        # successors per token (lower => easier)


class MarkovTextDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        V = cfg.vocab_size
        self.successors = rng.randint(0, V, size=(V, cfg.branching))
        self.probs = rng.dirichlet(np.ones(cfg.branching), size=V)

    def sample_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed + 1) * 100003 + step)
        B, S = cfg.batch_size, cfg.seq_len
        out = np.empty((B, S), np.int32)
        out[:, 0] = rng.randint(0, cfg.vocab_size, size=B)
        for t in range(1, S):
            cur = out[:, t - 1]
            choice = np.array([rng.choice(cfg.branching, p=self.probs[c])
                               for c in cur])
            out[:, t] = self.successors[cur, choice]
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.sample_batch(step)
            step += 1

    def optimal_nll(self) -> float:
        """Entropy of the transition distribution = the loss floor."""
        p = self.probs
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(-1)
        return float(ent.mean())
