"""Plain PyTorch version of causal (optionally windowed) GQA attention."""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q, k, v, causal: bool = True, window=None):
    """q: [B,S,H,D]; k/v: [B,S,Kv,D] -> [B,S,H,D]."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    g = H // Kv
    qh = q.reshape(B, S, Kv, g, D).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    logits = torch.where(mask[None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
