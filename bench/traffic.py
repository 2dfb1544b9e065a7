"""The one traffic generator: a closed loop of clients whose requests a
mix file describes.

A mix (``mixes/<name>.json``) gives the number of clients, the prompt and
output lengths (log-uniform between ``lo`` and ``hi``), which requests
are greedy, and the temperature of the others. Every seed sends the same
multiset of sizes in another order: the lengths of each block of
``pool`` consecutive requests are the pool's stratified quantiles, put
in an order drawn from the seed and the block's index. The prompt's
token ids are uniform over the vocabulary, drawn from the seed and the
request's index, so request k is the same whatever the timing.

Each client sends its next request as soon as its previous one has
finished; requests are numbered in the order they are sent, and the
even ones (``greedy: "even"``) decode greedily, the odd ones sample at
``temperature``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


def load_mix(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def log_uniform_pool(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths at the stratified quantiles (i + 1/2) / n of the
    log-uniform law on [lo, hi], rounded to whole tokens."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                   ).astype(np.int64)


@dataclass(frozen=True)
class RequestSpec:
    index: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


class Traffic:
    """Request ``k`` of a mix under ``seed`` for a model of ``vocab``
    token ids."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.pool = int(mix["pool"])
        self._prompts = log_uniform_pool(mix["prompt"]["lo"],
                                         mix["prompt"]["hi"], self.pool)
        self._outputs = log_uniform_pool(mix["output"]["lo"],
                                         mix["output"]["hi"], self.pool)
        self._blocks: Dict[int, np.ndarray] = {}

    def _order(self, block: int) -> np.ndarray:
        """Two independent orders of the pool: prompts, outputs."""
        if block not in self._blocks:
            rng = np.random.default_rng([self.seed, block, 1])
            self._blocks[block] = np.stack([rng.permutation(self.pool),
                                            rng.permutation(self.pool)])
        return self._blocks[block]

    def sizes(self, k: int):
        """(prompt length, output length) of request k."""
        order = self._order(k // self.pool)
        j = k % self.pool
        return (int(self._prompts[order[0, j]]),
                int(self._outputs[order[1, j]]))

    def request(self, k: int) -> RequestSpec:
        n_prompt, n_out = self.sizes(k)
        rng = np.random.default_rng([self.seed, k, 2])
        prompt = rng.integers(0, self.vocab, size=n_prompt).tolist()
        greedy = (k % 2 == 0) if self.mix["greedy"] == "even" else False
        return RequestSpec(k, prompt, n_out,
                           0.0 if greedy else float(self.mix["temperature"]))
