"""A layer of grouped-query attention and a mixture of experts with no
shared expert (Qwen3-MoE), in plain float32, as the served model
computes it: RoPE over the whole head on queries and keys, no QK-norm
(a departure from the published model, listed in
``configs/qwen3-235b-a22b.l8.json``)."""
from __future__ import annotations

from bench.reference.common import causal_attention, moe, rmsnorm, rope


def layer(p, x, positions, cfg, mm):
    """x [S, d_model] float32 -> the layer's output at every position."""
    S = x.shape[0]
    H, Kv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    a = p["attn"]
    h = rmsnorm(x, p["ln1"]["scale"], eps)
    q = rope(mm(h, a["wq"]["kernel"]).view(S, H, D), positions, theta)
    k = rope(mm(h, a["wk"]["kernel"]).view(S, Kv, D), positions, theta)
    v = mm(h, a["wv"]["kernel"]).view(S, Kv, D)
    o = causal_attention(q, k, v)
    x = x + mm(o.reshape(S, H * D), a["wo"]["kernel"])
    h = rmsnorm(x, p["ln2"]["scale"], eps)
    return x + moe(p["moe"], h, cfg, mm)
