"""Token sampling: greedy / temperature / top-k, per-slot parameters.

Greedy matches the JAX package token for token; temperature sampling
draws from a ``torch.Generator``, whose stream differs from JAX's PRNG."""
from __future__ import annotations

import torch


def sample(generator: torch.Generator, logits, temperature, top_k=0):
    """logits: [B, V]; temperature: [B] (0 => greedy per slot); top_k a
    Python int shared by the batch, or a per-slot [B] int vector
    (0 => no truncation for that slot). Returns int64 [B]."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    B, V = logits.shape
    if isinstance(top_k, int):
        if top_k > 0:
            kth = torch.topk(logits, min(top_k, V), dim=-1).values[:, -1:]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -float("inf")),
                                 logits)
    else:
        k = torch.as_tensor(top_k, device=logits.device).long().expand(B)
        ranked = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(ranked, 1, (k.clamp(1, V) - 1)[:, None])
        logits = torch.where((k[:, None] > 0) & (logits < kth),
                             torch.full_like(logits, -float("inf")), logits)
    temperature = torch.as_tensor(temperature, device=logits.device).float()
    temp = temperature.clamp(min=1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature > 0, sampled, greedy)
