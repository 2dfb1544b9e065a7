"""Model assembly (PyTorch counterpart of ``repro.models.transformer``) for
the dense and moe families: a causal transformer with GQA attention and an
MLP or MoE FFN per layer.

Parameters are nested dicts of tensors with the JAX package's nesting
(``embed.embedding``, ``layers[i].attn.wq.{kernel,bias}``,
``layers[i].moe.{router,experts,shared}``, ...), so the JAX ``Model.init``
tree converts one to one (``repro_torch.bridge``). Layers run as a Python
loop, eagerly; there is no jit counterpart.

Execution modes:
  prefill()      full-sequence + cache fill
  decode_step()  one token with cache (the cache rows are written in place)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense_init, embedding_apply,
                                       embedding_attend, embedding_init,
                                       mlp_apply, mlp_init, rmsnorm_apply,
                                       rmsnorm_init)

MOE_IMPLS = ("dense", "capacity", "dep")


@dataclass(frozen=True)
class ExecutionContext:
    """Immutable execution template: which attention and MoE paths run.

    attn_impl: "xla" (plain masked SDPA), "flash" (flash kernel for
    prefill) or "decode_kernel" (flash kernel for prefill, ragged decode
    kernel for decode — the serving default). moe_impl: "dense" or
    "capacity"; "dep" is the expert-parallel executor, not ported yet."""

    attn_impl: str = "xla"
    moe_impl: str = "capacity"

    def __post_init__(self):
        if self.attn_impl not in attn.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{attn.ATTN_IMPLS}")
        if self.moe_impl == "dep":
            raise NotImplementedError(
                "moe_impl='dep' (the DEP executor, repro/core/dep.py) is not "
                "ported yet: ROADMAP Queue 1 item 6")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in "
                             f"{MOE_IMPLS}")


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
    moe_set = set(cfg.moe_layer_indices())
    return tuple("attn_moe" if i in moe_set else "attn_mlp"
                 for i in range(cfg.num_layers))


def init_layer(gen, cfg: ModelConfig, kind: str, dtype=torch.float32):
    p: Dict[str, Any] = {
        "ln1": rmsnorm_init(cfg.d_model, gen.device, dtype),
        "attn": attn.attention_init(gen, cfg, dtype),
        "ln2": rmsnorm_init(cfg.d_model, gen.device, dtype),
    }
    if kind == "attn_mlp":
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.ffn_dim, dtype)
    elif kind == "attn_moe":
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.moe, dtype=dtype)
    else:
        raise ValueError(kind)
    return p


def _apply_moe(p, cfg: ModelConfig, h, ctx: ExecutionContext):
    if ctx.moe_impl == "dense":
        return moe_lib.moe_apply_dense(p["moe"], h, cfg.moe)
    return moe_lib.moe_apply_capacity(p["moe"], h, cfg.moe)


def apply_layer(p, cfg: ModelConfig, kind: str, x, positions, cache,
                mode: str, ctx: ExecutionContext, lengths=None):
    """Returns (x, new_cache, aux_loss). ``lengths`` is the decode-mode
    per-slot KV ledger vector shared by every attention layer."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        a, cache = attn.attention_decode(p["attn"], cfg, h, cache,
                                         impl=ctx.attn_impl, lengths=lengths)
    else:
        a, cache = attn.attention_fullseq(p["attn"], cfg, h, positions,
                                          cache, impl=ctx.attn_impl)
    x = x + a
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if kind == "attn_moe":
        y, aux = _apply_moe(p, cfg, h, ctx)
    else:
        y = mlp_apply(p["mlp"], h)
    return x + y, cache, aux


class Model:
    """Causal LM for the dense and moe families.

    ``device=None`` means the CUDA card and raises when there is none;
    the tests pass ``device="cpu"``, where every kernel wrapper takes its
    plain version."""

    def __init__(self, cfg: ModelConfig,
                 ctx: Optional[ExecutionContext] = None,
                 dtype=torch.bfloat16, device: DeviceLike = None):
        self.cfg = cfg
        self.ctx = ctx or ExecutionContext()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kinds = layer_kinds(cfg)

    # ---- init -----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (which must live on
        the model's device) with the reference's distributions: N(0,
        1/in_dim) dense kernels, zero biases, unit norm scales. Stored in
        the compute dtype."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dt = self.dtype
        params: Dict[str, Any] = {
            "embed": embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                    dt),
            "final_norm": rmsnorm_init(cfg.d_model, self.device, dt),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model,
                                           cfg.vocab_size, dtype=dt)
        params["layers"] = [init_layer(generator, cfg, kind, dt)
                            for kind in self.kinds]
        return params

    # ---- caches ------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> List[dict]:
        return [attn.init_kv_cache(self.cfg, batch, seq_len, self.dtype,
                                   self.device)
                for _ in self.kinds]

    # ---- forward pieces -----------------------------------------------------
    def _readout(self, params, x):
        """Logits in float32."""
        if self.cfg.tie_embeddings:
            return embedding_attend(params["embed"], x)
        return x.float() @ params["lm_head"]["kernel"].float()

    def prefill(self, params, tokens, seq_budget: Optional[int] = None,
                last_positions=None):
        """tokens: [B, S] (right-padded when batching several requests).
        ``last_positions`` ([B] int, optional) takes each row's logits at
        its own last real token instead of the padded bucket end. Returns
        (logits [B,1,V], caches of capacity ``seq_budget``). The readout
        runs only on the positions it returns (the reference computes all
        S and then gathers: the same values)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        caches = self.init_cache(B, seq_budget or S)
        x = embedding_apply(params["embed"], tokens, self.dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device)[None].expand(B, S)
        for i, kind in enumerate(self.kinds):
            x, caches[i], _ = apply_layer(params["layers"][i], cfg, kind, x,
                                          positions, caches[i], "prefill",
                                          self.ctx)
        if last_positions is not None:
            pos = torch.as_tensor(last_positions, device=self.device).long()
            x = x[torch.arange(B, device=self.device), pos][:, None]
        else:
            x = x[:, -1:]
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        return self._readout(params, x), caches

    def decode_step(self, params, tokens, caches, lengths=None):
        """tokens: [B, 1] -> (logits [B,1,V], caches). ``lengths`` ([B]
        int32, optional) are the per-slot context lengths from the KV
        ledger, shared by every attention layer (mask source and the
        ragged kernel's loop bound). The caches' K/V rows are written in
        place; the returned list holds the advanced indices."""
        cfg = self.cfg
        x = embedding_apply(params["embed"], tokens.to(self.device),
                            self.dtype)
        if lengths is not None:
            lengths = lengths.to(device=self.device, dtype=torch.int32)
        new_caches = []
        for i, kind in enumerate(self.kinds):
            x, nc, _ = apply_layer(params["layers"][i], cfg, kind, x, None,
                                   caches[i], "decode", self.ctx,
                                   lengths=lengths)
            new_caches.append(nc)
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        return self._readout(params, x), new_caches
