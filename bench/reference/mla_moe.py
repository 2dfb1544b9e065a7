"""A layer of DeepSeek-V2's latent attention (MLA) and mixture of experts
with shared experts, in plain float32, as the served model computes it.

The attention follows the served model's equations, which depart from the
published MLA (listed in ``configs/deepseek-v2-lite.json``): queries come
from one projection ``wq`` with no low-rank query path; the keys are the
up-projected latent's no-RoPE part plus one RoPE key ``kpe`` of the full
head width shared by every head (added, not concatenated); RoPE turns the
whole query head. The cache a server keeps (the latent ``h @ w_dkv`` and
the turned ``kpe``) is worked out here again from the tokens.
"""
from __future__ import annotations

from bench.reference.common import causal_attention, moe, rmsnorm, rope


def layer(p, x, positions, cfg, mm):
    """x [S, d_model] float32 -> the layer's output at every position."""
    S = x.shape[0]
    H, D, eps = cfg["num_heads"], cfg["head_dim"], cfg["norm_eps"]
    a = p["attn"]
    h = rmsnorm(x, p["ln1"]["scale"], eps)
    q = rope(mm(h, a["wq"]["kernel"]).view(S, H, D), positions,
             cfg["rope_theta"])
    latent = mm(h, a["w_dkv"]["kernel"])
    kv = mm(latent, a["w_ukv"]["kernel"]).view(S, H, 2 * D)
    k_nope, v = kv[..., :D], kv[..., D:]
    kpe = rope(mm(h, a["w_kpe"]["kernel"])[:, None, :], positions,
               cfg["rope_theta"])
    o = causal_attention(q, (k_nope + kpe).contiguous(), v.contiguous())
    x = x + mm(o.reshape(S, H * D), a["wo"]["kernel"])
    h = rmsnorm(x, p["ln2"]["scale"], eps)
    return x + moe(p["moe"], h, cfg, mm)
