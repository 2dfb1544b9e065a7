"""What both reference models share: float32 set-up, the primitive
layers, the top-k mixture of experts, and the layer-by-layer forward.

Every matrix product with a weight goes through ``mm(x, w)``: plain
float32 (``matmul``) for the reference, or a lower precision for the
control that must fail the comparison (``fp8_matmul``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def strict_float32() -> None:
    """Float32 products in float32: no TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out], both float32."""
    return x @ w


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), returned in float32."""
    amax = t.abs().max().clamp(min=1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An fp8 product: both operands rounded to e4m3 with per-tensor
    scales, accumulated in float32."""
    return fp8_round(x) @ fp8_round(w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [S, heads, D] rotated by position; the pairs are (i, i + D/2)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (positions.to(torch.float64)[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads_per_block: int = 8) -> torch.Tensor:
    """Softmax attention of q [S, H, D] over k, v [S, Kv, D] (H a multiple
    of Kv: query head h reads key head h // (H / Kv)), every position
    seeing itself and the ones before it. Computed a few heads at a time
    so that the [heads, S, S] scores stay small."""
    S, H, D = q.shape
    g = H // k.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, heads_per_block):
        hs = range(h0, min(h0 + heads_per_block, H))
        qh = q[:, hs].transpose(0, 1)                       # [h, S, D]
        kh = k[:, [h // g for h in hs]].transpose(0, 1)
        vh = v[:, [h // g for h in hs]].transpose(0, 1)
        s = (qh @ kh.transpose(1, 2)) / math.sqrt(D)
        s = s.masked_fill(~mask, float("-inf"))
        out[:, hs] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, mm: MatMul) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, gate)) * mm(x, up), down)


def moe(p: Dict, x: torch.Tensor, cfg: Dict, mm: MatMul) -> torch.Tensor:
    """The mixture of experts with no token dropped: softmax over the
    router's logits, the top-k experts of each token with their
    probabilities renormalised to sum to one, each expert's SwiGLU on
    the tokens routed to it, and the shared experts (one SwiGLU of
    ``num_shared_experts`` times the width) on every token. The router
    runs in float32 whatever ``mm`` is."""
    m = cfg["moe"]
    probs = torch.softmax(x @ p["router"]["kernel"], dim=-1)
    w, idx = torch.topk(probs, m["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    ex = p["experts"]
    for e in range(ex["gate"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], ex["gate"][e], ex["up"][e], ex["down"][e], mm)
        y.index_add_(0, tok, out * w[tok, slot][:, None])
    if "shared" in p:
        s = p["shared"]
        y = y + swiglu(x, s["gate"]["kernel"], s["up"]["kernel"],
                       s["down"]["kernel"], mm)
    return y


def to_f32(tree):
    """A float32 copy of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def forward(params: Dict, cfg: Dict, layer: Callable,
            seqs: Sequence[torch.Tensor], readout_from: Sequence[int],
            mm: MatMul = matmul) -> List[torch.Tensor]:
    """Logits of each token sequence in ``seqs`` (int64 [S] on the
    weights' device) at positions ``readout_from[i]`` .. S - 1, float32
    [S - readout_from[i], V]. The layers run one at a time over every
    sequence, each layer's weights copied to float32 and dropped before
    the next, so that the float32 copies never outgrow one layer (and
    the readout's table)."""
    eps = cfg["norm_eps"]
    hs = [params["embed"]["embedding"][s].float() for s in seqs]
    pos = [torch.arange(s.numel(), device=s.device) for s in seqs]
    for lp in params["layers"]:
        p32 = to_f32(lp)
        hs = [layer(p32, h, t, cfg, mm) for h, t in zip(hs, pos)]
        del p32
    norm = params["final_norm"]["scale"].float()
    head = params["lm_head"]["kernel"].float()
    out = [mm(rmsnorm(h[r:], norm, eps), head)
           for h, r in zip(hs, readout_from)]
    del head
    return out
