"""Model assembly (PyTorch counterpart of ``repro.models.transformer``) for
the dense, moe and vlm families (a causal transformer with GQA or MLA
attention and an MLP or MoE FFN per layer; vlm puts projected patch
embeddings in front of the tokens), the ssm family (xLSTM: mLSTM and
sLSTM blocks, whose decode cache is a recurrent state), the hybrid family
(RecurrentGemma: RG-LRU blocks and local attention over a ring KV cache,
each followed by an MLP) and the audio family (an encoder-decoder: a
bidirectional encoder over the frame embeddings, and decoder layers that
add cross-attention to the encoder's output, the ``memory``, when it is
given).

Parameters are nested dicts of tensors with the JAX package's nesting
(``embed.embedding``, ``layers[i].attn.wq.{kernel,bias}``,
``layers[i].moe.{router,experts,shared}``, ...), so the JAX ``Model.init``
tree converts one to one (``repro_torch.bridge``). Layers run as a Python
loop; the serving engine captures its whole decode step as a CUDA graph
(``runtime/decode_graph.py``), the counterpart of the reference's jit.

Execution modes:
  forward()      full-sequence logits at every position
  prefill()      full-sequence + cache fill
  decode_step()  one token with cache (attention cache rows are written in
                 place; dense or, with ``block_tables``, paged KV)
  loss()         the training loss: shift-by-one cross-entropy, read out
                 in checkpointed chunks, + the MoE aux loss

MoE layers dispatch through ``moe_impl``: "dense" (exact all-experts
oracle), "capacity" (GShard capacity dispatch, one device) or "dep" (the
FinDEP-scheduled expert-parallel walk of ``repro_torch.core.dep`` over the
context's ``DepGroups``; the schedule, an ``ExecProgram``, is passed per
call as ``plan=``). On an expert group of several ranks each rank holds
its share of the experts (``Model.init(expert_shard=)``) and everything
else whole: a DEP layer takes the rank's slice of the tokens (its data
shard, and in sequence mode its part of the sequence) and gathers every
rank's output back, so each rank computes the same residual stream.

On a mesh the sharded prefill and decode steps (``launch.steps.build``)
give the context a ``models.parallel.TensorParallel`` (``tp``): each rank
then holds its shards of every parameter by the partition specs, and the
embedding, attention, MLP, RG-LRU block and readout compute the rank's
share and combine it over the model axis (``models.parallel``); caches
are the rank's shards (``init_cache``).
"""
from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel as tp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_apply, dense_init,
                                       embedding_apply,
                                       embedding_attend, embedding_init,
                                       mlp_apply, mlp_init, rmsnorm_apply,
                                       rmsnorm_init)

MOE_IMPLS = ("dense", "capacity", "dep")


@dataclass(frozen=True)
class ExecutionContext:
    """Immutable execution template: which attention and MoE paths run,
    and the process groups of the DEP path. Schedules are not part of
    it: the plan flows through each model call.

    attn_impl: "xla" (plain masked SDPA), "flash" (flash kernel for
    prefill) or "decode_kernel" (flash kernel for prefill, ragged decode
    kernel for decode — the serving default). moe_impl: "dense",
    "capacity" or "dep", which needs ``groups`` (a
    ``repro_torch.core.dep.DepGroups``)."""

    attn_impl: str = "xla"
    moe_impl: str = "capacity"
    groups: Optional[Any] = None
    #: ``Model.loss`` checkpoints each layer (the reference's per-layer
    #: ``jax.checkpoint``): its activations are recomputed in the backward
    #: pass, the expert GEMM kernel's forward with them
    remat: bool = False
    #: each rank's tokens are already its data shard of the batch (the
    #: sharded train step): a DEP layer splits only the sequence over the
    #: expert axis, and gathers only over it
    batch_sharded: bool = False
    #: tensor parallelism over the model axis (``models.parallel``): the
    #: sharded prefill and decode steps, whose parameters and caches are
    #: each rank's shards
    tp: Optional[Any] = None

    def __post_init__(self):
        if self.attn_impl not in attn.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{attn.ATTN_IMPLS}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in "
                             f"{MOE_IMPLS}")
        if (self.moe_impl == "dep") != (self.groups is not None):
            raise ValueError("moe_impl='dep' and only it takes groups")


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family == "ssm":
        return ssm_lib.xlstm_layer_kinds(cfg)
    if cfg.family == "hybrid":
        return rglru_lib.rglru_block_pattern(cfg)
    moe_set = set(cfg.moe_layer_indices())
    return tuple("attn_moe" if i in moe_set else "attn_mlp"
                 for i in range(cfg.num_layers))


def init_layer(gen, cfg: ModelConfig, kind: str, dtype=torch.float32,
               expert_shard: Optional[Tuple[int, int]] = None,
               cross: bool = False, num_experts_padded: int = 0):
    """One layer's parameters; ``cross`` (a decoder layer of an
    encoder-decoder model) adds ``ln_x`` and the ``cross`` attention;
    ``num_experts_padded`` pads an MoE layer's expert stacks."""
    if kind in ("mlstm", "slstm"):
        init = ssm_lib.mlstm_init if kind == "mlstm" else ssm_lib.slstm_init
        return {"ln1": rmsnorm_init(cfg.d_model, gen.device, dtype),
                kind: init(gen, cfg, dtype)}
    p: Dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, gen.device, dtype)}
    # "rec" is the hybrid family's RG-LRU block, "attn" its local attention
    if kind == "rec":
        p["rglru"] = rglru_lib.rglru_init(gen, cfg, dtype)
    else:
        p["attn"] = attn.attention_init(gen, cfg, dtype)
    p["ln2"] = rmsnorm_init(cfg.d_model, gen.device, dtype)
    if kind in ("attn_mlp", "attn", "rec"):
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.ffn_dim, dtype)
    elif kind == "attn_moe":
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.moe,
                                    num_experts_padded, dtype=dtype,
                                    expert_shard=expert_shard)
    else:
        raise ValueError(kind)
    if cross:
        p["ln_x"] = rmsnorm_init(cfg.d_model, gen.device, dtype)
        p["cross"] = attn.cross_attention_init(gen, cfg, dtype)
    return p


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype=torch.bfloat16, device=None):
    """A layer's decode cache: a KV cache for attention layers (k/v, or
    MLA's latent ckv/kpe; a ring of the window under local/sliding
    attention), a float32 recurrent state
    (whatever ``dtype``) for mLSTM, sLSTM and RG-LRU layers."""
    if kind in ("attn_mlp", "attn_moe", "attn"):
        return attn.init_kv_cache(cfg, batch,
                                  attn.cache_capacity(cfg, seq_len), dtype,
                                  device)
    if kind == "rec":
        return rglru_lib.rglru_state(cfg, batch, device=device)
    if kind == "mlstm":
        return ssm_lib.mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return ssm_lib.slstm_state(cfg, batch, device=device)
    raise ValueError(kind)


def _apply_moe(p, cfg: ModelConfig, h, ctx: ExecutionContext, plan=None,
               placement=None, collect_stats: bool = False,
               capacity_scale: float = 1.0, num_experts_padded: int = 0,
               with_aux: bool = False):
    """Returns (y, aux), or (y, aux, moe.MoEStats) with
    ``collect_stats``. ``plan``, ``placement`` (the layer's
    ``dep.LayerPlacement``) and ``capacity_scale`` reach only the DEP
    path, whose aux (an all_reduce) runs only ``with_aux`` (the loss):
    serving discards it."""
    if ctx.moe_impl == "dense":
        return moe_lib.moe_apply_dense(p["moe"], h, cfg.moe,
                                       num_experts_padded,
                                       return_stats=collect_stats)
    if ctx.moe_impl == "capacity":
        return moe_lib.moe_apply_capacity(p["moe"], h, cfg.moe,
                                          num_experts_padded,
                                          return_stats=collect_stats)
    # the reference's shard_map in- and out-specs by hand: this rank's
    # slice of the tokens in, every rank's slices gathered back out, so
    # the residual stream (attention, router input, readout) stays whole
    # and replicated on every rank
    from repro_torch.core import dep as dep_lib
    groups = ctx.groups
    B, S, _ = h.shape
    split = dict(sequence=dep_lib.seq_mode(S, groups.expert_size),
                 batch_sharded=(not ctx.batch_sharded
                                and dep_lib.batch_split(B, groups)))
    out = dep_lib.moe_apply_dep(
        p["moe"], dep_lib.split_tokens(h, groups, **split), cfg.moe, groups,
        num_experts_padded, plan=plan, with_aux=with_aux,
        return_stats=collect_stats, capacity_scale=capacity_scale, **split,
        **(placement._asdict() if placement is not None else {}))
    aux = out[1] if with_aux else torch.zeros((), dtype=torch.float32,
                                              device=h.device)
    y = dep_lib.gather_tokens(out[0], groups, **split)
    return (y, aux) + tuple(out[2:])


def apply_layer(p, cfg: ModelConfig, kind: str, x, positions, cache,
                mode: str, ctx: ExecutionContext, lengths=None,
                paged=None, plan=None, placement=None, stats_sink=None,
                capacity_scale: float = 1.0, memory=None,
                num_experts_padded: int = 0, with_aux: bool = False):
    """Returns (x, new_cache, aux_loss). ``memory`` (the encoder's output,
    [B, Sk, M]) runs a decoder layer's cross-attention after its
    self-attention; a layer without ``cross``, or no memory, skips it.
    ``lengths`` is the decode-mode
    per-slot KV ledger vector shared by every attention layer; ``paged``
    is the decode step's paged-KV addresses (``attn.paged_address``, also
    shared: one table addresses every layer's page pool); ``plan`` is the
    DEP schedule of every MoE layer, ``placement`` this layer's
    ``dep.LayerPlacement`` and ``capacity_scale`` its dispatch widening.
    ``stats_sink`` is an optional list an MoE layer appends its
    ``moe.MoEStats`` to. ``num_experts_padded`` is the model's padded
    expert count; ``with_aux`` runs a DEP layer's aux loss (the loss
    asks for it; serving skips its all_reduce)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if kind in ("mlstm", "slstm"):
        if kind == "slstm":
            fn = ssm_lib.slstm_apply
        else:   # decode updates C in place
            fn = ssm_lib.mlstm_step if mode == "decode" else \
                ssm_lib.mlstm_apply
        if cache is None:
            cache = init_layer_cache(cfg, kind, x.shape[0], 0,
                                     device=x.device)
        y, cache = fn(p[kind], cfg, h, cache)
        return x + y, cache, aux
    if kind == "rec":
        if cache is None:
            cache = rglru_lib.rglru_state(cfg, x.shape[0], device=x.device)
        fn = rglru_lib.rglru_step if mode == "decode" else \
            rglru_lib.rglru_apply
        y, cache = fn(p["rglru"], cfg, h, cache, tp=ctx.tp)
        x = x + y
        h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
        return x + _mlp(p["mlp"], h, cfg.ffn_dim, ctx.tp), cache, aux
    # the hybrid family's attention blocks are local, whatever the config
    acfg = (dataclasses.replace(cfg, attention="local")
            if kind == "attn" and cfg.family == "hybrid" else cfg)
    if mode == "decode":
        a, cache = attn.attention_decode(p["attn"], acfg, h, cache,
                                         impl=ctx.attn_impl, lengths=lengths,
                                         paged=paged, tp=ctx.tp)
    else:
        a, cache = attn.attention_fullseq(p["attn"], acfg, h, positions,
                                          cache, impl=ctx.attn_impl,
                                          tp=ctx.tp)
    x = x + a
    if memory is not None and "cross" in p:
        hx = rmsnorm_apply(p["ln_x"], x, cfg.norm_eps)
        x = x + attn.cross_attention_apply(p["cross"], cfg, hx, memory,
                                           impl=ctx.attn_impl, tp=ctx.tp)
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if kind == "attn_moe":
        y, aux, *st = _apply_moe(p, cfg, h, ctx, plan, placement,
                                 collect_stats=stats_sink is not None,
                                 capacity_scale=capacity_scale,
                                 num_experts_padded=num_experts_padded,
                                 with_aux=with_aux)
        if stats_sink is not None:
            stats_sink.append(st[0])
    else:
        y = _mlp(p["mlp"], h, cfg.ffn_dim, ctx.tp)
    return x + y, cache, aux


def _mlp(p, h, ffn_dim: int, tp):
    return mlp_apply(p, h) if tp is None else tp_lib.mlp_apply(p, h, ffn_dim,
                                                              tp)


def _stack_moe_stats(sink) -> Optional[moe_lib.MoEStats]:
    """One ``moe.MoEStats`` of a stats sink: ``load`` stacked to
    [L_moe, E], ``dropped`` summed over the layers (int32). None for an
    empty sink (no MoE layer)."""
    if not sink:
        return None
    return moe_lib.MoEStats(
        load=torch.stack([s.load for s in sink]),
        dropped=torch.stack([s.dropped for s in sink]).sum(
            dtype=torch.int32))


def _layer_placement(placement, i: int):
    return placement.layer(i) if placement is not None else None


class Model:
    """Causal LM of every family; encoder-decoder when
    ``cfg.is_encoder_decoder``.

    ``device=None`` means the CUDA card and raises when there is none;
    the tests pass ``device="cpu"``, where every kernel wrapper takes its
    plain version. A model on the ``meta`` device gives shapes only
    (``launch.steps.abstract_params``: ``init`` with a
    ``layers.MetaGenerator``). ``num_experts_padded`` pads every MoE
    layer's expert dimension (padded experts are masked out of the
    router)."""

    def __init__(self, cfg: ModelConfig,
                 ctx: Optional[ExecutionContext] = None,
                 dtype=torch.bfloat16, device: DeviceLike = None,
                 num_experts_padded: int = 0):
        self.cfg = cfg
        self.ctx = ctx or ExecutionContext()
        self.device = resolve_device(device, allow_meta=True)
        self.dtype = dtype
        self.kinds = layer_kinds(cfg)
        self.E_pad = num_experts_padded or (cfg.moe.num_experts
                                            if cfg.moe else 0)

    # ---- init -----------------------------------------------------------
    def init(self, generator: torch.Generator,
             expert_shard: Optional[Tuple[int, int]] = None
             ) -> Dict[str, Any]:
        """Random parameters drawn from ``generator`` (which must live on
        the model's device) with the reference's distributions: N(0,
        1/in_dim) dense kernels, zero biases, unit norm scales. Stored in
        the compute dtype. ``expert_shard`` = (rank, mo) keeps only expert
        rank ``rank``'s ``E / mo`` rows of every MoE layer's stacked
        experts: the draws are the whole model's, in the same order, so
        the kept rows equal the one-rank model's, and each layer's other
        rows are dropped before the next layer is drawn."""
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
        cross = cfg.is_encoder_decoder
        params["layers"] = [init_layer(generator, cfg, kind, dt,
                                       expert_shard, cross, self.E_pad)
                            for kind in self.kinds]
        if cross:
            params["enc_layers"] = [
                init_layer(generator, cfg, "attn_mlp", dt)
                for _ in range(cfg.num_encoder_layers)]
            params["enc_norm"] = rmsnorm_init(cfg.d_model, self.device, dt)
        if cfg.family == "vlm":
            params["proj"] = dense_init(generator, cfg.d_model, cfg.d_model,
                                        dtype=dt)
        return params

    # ---- encoder (audio family) ------------------------------------------
    def encode(self, params, frame_embeds):
        """frame_embeds: [B, S_enc, M] from the stubbed modality frontend
        -> the memory [B, S_enc, M] in the model's dtype: the encoder
        layers (bidirectional self-attention with RoPE, then the MLP),
        then ``enc_norm``."""
        cfg = self.cfg
        x = frame_embeds.to(self.device, self.dtype)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device)[None].expand(B, S)
        bidir = dataclasses.replace(cfg, attention="full")
        for p in params["enc_layers"]:
            h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
            x = x + attn.encoder_self_attention(p["attn"], bidir, h,
                                                positions,
                                                impl=self.ctx.attn_impl,
                                                tp=self.ctx.tp)
            h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
            x = x + _mlp(p["mlp"], h, cfg.ffn_dim, self.ctx.tp)
        return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)

    def _embed_inputs(self, params, tokens, extra_embeds):
        """Token embeddings; a vlm model puts the patch embeddings,
        through ``proj``, in front of them."""
        x = self._embed(params, tokens)
        if extra_embeds is not None and self.cfg.family == "vlm":
            extra = extra_embeds.to(self.device, self.dtype)
            if self.ctx.tp is None:
                vis = dense_apply(params["proj"], extra)
            else:
                vis = tp_lib.dense_gathered(params["proj"], extra,
                                            self.cfg.d_model, self.ctx.tp)
            x = torch.cat([vis, x], dim=1)
        return x

    def _embed(self, params, tokens):
        tokens = tokens.to(self.device)
        if self.ctx.tp is None:
            return embedding_apply(params["embed"], tokens, self.dtype)
        return tp_lib.embed(params["embed"], tokens, self.cfg.vocab_size,
                            self.dtype, self.ctx.tp)

    # ---- caches ------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, dtype=None) -> List[dict]:
        """One cache per layer: KV caches in ``dtype`` (default: the
        model's) for attention layers, float32 states for recurrent ones."""
        dtype = dtype if dtype is not None else self.dtype
        if self.ctx.tp is not None:
            return self._local_caches(batch, seq_len, dtype)
        return [init_layer_cache(self.cfg, kind, batch, seq_len, dtype,
                                 self.device)
                for kind in self.kinds]

    def _local_caches(self, batch: int, seq_len: int, dtype):
        """This rank's shards of the caches on a mesh: the model-axis
        split of ``sharding.partition.cache_pspecs`` (``batch`` is already
        the rank's). A layer whose cache has a split leaf (attention's
        k/v, the RG-LRU state: all zeros at the start) gets zeros of the
        shard's shape; any other is made whole, as without a mesh (the
        recurrent states' m starts at -1e30)."""
        from repro_torch.sharding.partition import (PSpec, cache_pspecs,
                                                    local_shape)
        from repro_torch.training.tree import tree_leaves, tree_unflatten
        # a mesh of the model axis alone, for the spec builders
        axis = types.SimpleNamespace(shape={"model": self.ctx.tp.size})
        out = []
        for kind in self.kinds:
            full = init_layer_cache(self.cfg, kind, batch, seq_len, dtype,
                                    "meta")
            specs = tree_leaves(cache_pspecs(full, self.cfg, axis, batch),
                                PSpec)
            if not any(any(sp) for sp in specs):
                out.append(init_layer_cache(self.cfg, kind, batch, seq_len,
                                            dtype, self.device))
                continue
            out.append(tree_unflatten(full, [
                torch.zeros(local_shape(x.shape, sp, axis), dtype=x.dtype,
                            device=self.device)
                for x, sp in zip(tree_leaves(full), specs)]))
        return out

    # ---- forward pieces -----------------------------------------------------
    def _readout(self, params, x):
        """Logits in float32."""
        if self.ctx.tp is not None:
            return tp_lib.readout(params, x, self.cfg.vocab_size,
                                  self.cfg.tie_embeddings, self.ctx.tp)
        if self.cfg.tie_embeddings:
            return embedding_attend(params["embed"], x)
        return x.float() @ params["lm_head"]["kernel"].float()

    def _layers(self, params, tokens, extra_embeds, memory, caches,
                plan=None, placement=None, sink=None,
                capacity_scale: float = 1.0, remat: bool = False,
                with_aux: bool = False):
        """The full-sequence pass up to the final norm: an encoder-decoder
        model given frames (``extra_embeds``) and no memory encodes them
        first. ``remat`` checkpoints each decoder layer; ``with_aux`` runs
        the DEP layers' aux loss. Returns (x [B, P+S, M], new caches, each
        layer's aux)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder and memory is None \
                and extra_embeds is not None:
            memory = self.encode(params, extra_embeds)
            extra_embeds = None
        x = self._embed_inputs(params, tokens, extra_embeds)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device)[None].expand(B, S)
        auxes, new_caches = [], [None] * len(self.kinds)
        layer = apply_layer
        if remat:
            def layer(*args, **kwargs):
                return torch.utils.checkpoint.checkpoint(
                    apply_layer, *args, use_reentrant=False, **kwargs)
        for i, kind in enumerate(self.kinds):
            x, new_caches[i], aux = layer(
                params["layers"][i], cfg, kind, x, positions,
                caches[i] if caches is not None else None, "prefill",
                self.ctx, plan=plan,
                placement=_layer_placement(placement, i), stats_sink=sink,
                capacity_scale=capacity_scale, memory=memory,
                num_experts_padded=self.E_pad, with_aux=with_aux)
            auxes.append(aux)
        return x, new_caches, auxes

    def forward(self, params, tokens, extra_embeds=None, memory=None):
        """tokens: [B, S]; extra_embeds: vlm patch embeddings [B, P, M]
        (or an encoder-decoder model's frames, encoded when no memory is
        given); memory: the encoder's output. Returns (logits [B, P+S, V]
        in float32, the MoE aux loss summed over the layers); the
        reference's middle slot, the caches, is filled here only by
        ``prefill``."""
        x, _, auxes = self._layers(params, tokens, extra_embeds, memory,
                                   None)
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        return self._readout(params, x), torch.stack(auxes).sum()

    def prefill(self, params, tokens, extra_embeds=None, memory=None,
                seq_budget: Optional[int] = None,
                last_positions=None, plan=None, placement=None,
                return_moe_stats: bool = False,
                capacity_scale: float = 1.0):
        """tokens: [B, S] (right-padded when batching several requests).
        ``extra_embeds`` and ``memory`` are as in ``forward``: a vlm
        model's P patch embeddings share the cache (its capacity is
        ``seq_budget`` + P) and shift ``last_positions`` by P.
        ``last_positions`` ([B] int, optional) takes each row's logits at
        its own last real token instead of the padded bucket end. ``plan``
        is the DEP schedule of this call's MoE layers, ``placement`` the
        engine's ``dep.DevicePlacement`` (or None) and ``capacity_scale``
        their dispatch widening, all three for the DEP path only. Returns
        (logits [B,1,V], caches of capacity ``seq_budget`` (+ P)), and with
        ``return_moe_stats`` a stacked ``moe.MoEStats`` ([L_moe, E] loads,
        total dropped; None without MoE layers). The readout runs only on
        the positions it returns (the reference computes all S and then
        gathers: the same values)."""
        cfg = self.cfg
        B, S = tokens.shape
        budget, off = seq_budget or S, 0
        if extra_embeds is not None and cfg.family == "vlm":
            off = extra_embeds.shape[1]      # image positions share the cache
            budget += off
        sink = [] if return_moe_stats else None
        x, caches, _ = self._layers(params, tokens, extra_embeds, memory,
                                    self.init_cache(B, budget), plan,
                                    placement, sink, capacity_scale)
        if last_positions is not None:
            pos = torch.as_tensor(last_positions, device=self.device).long()
            if off:
                pos = pos + off
            x = x[torch.arange(B, device=self.device), pos][:, None]
        else:
            x = x[:, -1:]
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        if return_moe_stats:
            return self._readout(params, x), caches, _stack_moe_stats(sink)
        return self._readout(params, x), caches

    def decode_step(self, params, tokens, caches, memory=None,
                    lengths=None, block_tables=None, plan=None,
                    placement=None, return_moe_stats: bool = False,
                    capacity_scale: float = 1.0):
        """tokens: [B, 1] -> (logits [B,1,V], caches). ``memory`` (the
        encoder's output) runs every decoder layer's cross-attention, its
        K/V projected from the whole memory at every step, as the
        reference does; without it they are skipped. ``lengths`` ([B]
        int32, optional) are the per-slot context lengths from the KV
        ledger, shared by every attention layer (mask source and the
        ragged kernel's loop bound). ``block_tables`` (int32 [B,
        max_blocks], optional) is the paged-KV page map; one table serves
        every attention layer, since page p of each layer's pool belongs
        to the same logical block, so the step's page addresses are worked
        out once here. None = dense. ``plan``, ``placement`` and
        ``capacity_scale`` are as in ``prefill``. The caches' K/V rows and
        the mLSTM matrix states are written in place; the returned list
        holds the advanced indices and the other new recurrent states.
        ``return_moe_stats`` appends the stacked ``moe.MoEStats``."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if lengths is not None:
            lengths = lengths.to(device=self.device, dtype=torch.int32)
        paged = None
        if block_tables is not None:     # paged KV is GQA only: k/v
            first = next(c for c in caches if "k" in c)
            paged = attn.paged_address(block_tables.to(self.device),
                                       first["index"], first["k"].shape[1],
                                       lengths)
        new_caches = []
        sink = [] if return_moe_stats else None
        for i, kind in enumerate(self.kinds):
            x, nc, _ = apply_layer(
                params["layers"][i], cfg, kind, x, None, caches[i],
                "decode", self.ctx, lengths=lengths, paged=paged, plan=plan,
                placement=_layer_placement(placement, i), stats_sink=sink,
                capacity_scale=capacity_scale, memory=memory,
                num_experts_padded=self.E_pad)
            new_caches.append(nc)
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        if return_moe_stats:
            return (self._readout(params, x), new_caches,
                    _stack_moe_stats(sink))
        return self._readout(params, x), new_caches

    # ---- loss ------------------------------------------------------------
    def loss(self, params, tokens, extra_embeds=None, ce_chunk: int = 512,
             plan=None):
        """Next-token cross-entropy (shift by one) + ``router_aux_loss_coef``
        x the MoE aux loss summed over the layers, a float32 scalar. A vlm
        model's targets start past its P patch embeddings; an
        encoder-decoder model encodes its frames (``extra_embeds``) first.
        The readout runs in chunks of ``ce_chunk`` positions
        (``chunked_softmax_xent``), so the [tokens, vocab] logits are never
        whole. With ``ctx.remat`` each decoder layer is recomputed in the
        backward pass."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        x, _, auxes = self._layers(params, tokens, extra_embeds, None, None,
                                   plan=plan, remat=self.ctx.remat,
                                   with_aux=True)
        x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
        off = (extra_embeds.shape[1]
               if (extra_embeds is not None and cfg.family == "vlm") else 0)
        pred = x[:, off:off + tokens.shape[1] - 1]
        tgt = tokens[:, 1:]
        if cfg.tie_embeddings:
            W = params["embed"]["embedding"].T
        else:
            W = params["lm_head"]["kernel"]
        nll_mean = chunked_softmax_xent(pred, W, tgt, chunk=ce_chunk)
        coef = cfg.moe.router_aux_loss_coef if cfg.moe else 0.0
        return nll_mean + coef * torch.stack(auxes).sum()


def _chunk_nll(xc, readout, tc, mc):
    """The summed masked NLL of one chunk: xc [B, c, M], tc [B, c]."""
    logits = xc.float() @ readout.float()                     # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mc[None, :])


def chunked_softmax_xent(x, readout, targets, chunk: int = 512):
    """Fused linear + softmax cross-entropy over sequence chunks.

    x: [B, T, M] final hidden states; readout: [M, V]; targets: [B, T].
    The sequence is padded to a multiple of ``chunk`` (the padding
    masked out), and no more than [B, chunk, V] of float32 logits is
    live: each chunk is checkpointed, so the backward pass recomputes
    its logits. Returns the mean NLL over all B*T positions."""
    B, T, M = x.shape
    n = max((T + chunk - 1) // chunk, 1)
    Tp = n * chunk
    if Tp != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tp - T))
        targets = torch.nn.functional.pad(targets, (0, Tp - T))
    mask = (torch.arange(Tp, device=x.device) < T).float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        cut = slice(i * chunk, (i + 1) * chunk)
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll, x[:, cut], readout, targets[:, cut], mask[cut],
            use_reentrant=False)
    return total / (B * T)
