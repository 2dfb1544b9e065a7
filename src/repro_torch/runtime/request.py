"""Serving request objects and queue bookkeeping."""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

_ids = itertools.count()


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"     # refused admission (e.g. prompt > max_context)
    LENGTH_CAPPED = "length_capped"   # context grew to max_context: ended
                                      # before the next write would clobber
                                      # the last KV cache row


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no truncation
    eos_token: Optional[int] = None
    request_id: int = field(default_factory=lambda: next(_ids))
    state: RequestState = RequestState.WAITING
    output: List[int] = field(default_factory=list)
    error: Optional[str] = None       # set when state == REJECTED
    arrival_t: float = field(default_factory=time.perf_counter)
    admit_t: Optional[float] = None   # left the waiting queue (slot granted)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0              # evicted-to-recompute count (paged KV)

    @property
    def resume_tokens(self) -> List[int]:
        """Everything a (re-)prefill must feed: the prompt plus any tokens
        generated before a preemption evicted this request's KV. Equals
        the prompt for a fresh request; generation resumes from the last
        emitted token with no duplication (the final resume token is fed
        through decode, exactly like a fresh prompt's last token)."""
        return list(self.prompt) + list(self.output)

    @property
    def done(self) -> bool:
        if self.eos_token is not None and self.output \
                and self.output[-1] == self.eos_token:
            return True
        return len(self.output) >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first (None until
        finished or with fewer than two tokens)."""
        if self.first_token_t is None or self.finish_t is None:
            return None
        n = len(self.output) - 1
        if n <= 0:
            return None
        return (self.finish_t - self.first_token_t) / n
