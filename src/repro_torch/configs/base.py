"""Configuration schema for models (a copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX
package. Only the model schema is copied: ``ModelConfig``, ``MoEConfig``,
``RecurrentConfig`` and ``reduced()``; the input shapes and the DEP
cluster layout come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ARCH_FAMILIES = (
    "dense",    # decoder-only transformer, (GQA) softmax attention
    "moe",      # decoder-only transformer with routed experts
    "ssm",      # xLSTM-style recurrent blocks (sLSTM + mLSTM)
    "hybrid",   # RG-LRU recurrence + local attention (RecurrentGemma)
    "vlm",      # vision-language: stub ViT frontend + dense LM backbone
    "audio",    # encoder-decoder (Seamless-M4T style); stub audio frontend
)

ATTENTION_KINDS = ("full", "sliding", "mla", "local", "none")


@dataclass(frozen=True)
class MoEConfig:
    """Routed-expert configuration (paper notation: E, top_k, N_shared, H)."""

    num_experts: int                 # E — global routed experts
    top_k: int                       # experts activated per token
    expert_ffn_dim: int              # H — hidden dim of each routed expert
    num_shared_experts: int = 0      # N_shared — dense experts on every token
    shared_ffn_dim: int = 0          # hidden dim of each shared expert
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25    # per-expert capacity = cf * tokens*topk/E
    moe_layer_start: int = 0         # first layer index that is MoE
    moe_layer_every: int = 1         # 1 => every layer from start is MoE


@dataclass(frozen=True)
class RecurrentConfig:
    """SSM / hybrid recurrence parameters."""

    kind: str = "rg_lru"             # "rg_lru" | "slstm" | "mlstm"
    lru_width: int = 0               # recurrence state width (0 -> d_model)
    conv1d_width: int = 4
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn") 1:2


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture. Field names follow the paper where possible
    (M = d_model, H = ffn hidden, E/top_k in MoEConfig, T = num_layers)."""

    name: str
    family: str                      # one of ARCH_FAMILIES
    num_layers: int                  # T
    d_model: int                     # M
    num_heads: int
    num_kv_heads: int                # GQA KV heads
    ffn_dim: int                     # dense FFN hidden (0 if pure-MoE/SSM)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    attention: str = "full"          # ATTENTION_KINDS
    sliding_window: int = 4096       # used when attention == "sliding"/"local"
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    # --- enc-dec (audio) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # --- multimodal stub frontends (vlm/audio carve-out) ---
    frontend_tokens: int = 0         # patch/frame embeddings prepended
    # --- MLA (DeepSeek-V2 style latent attention) ---
    mla_kv_lora_rank: int = 0
    mla_q_lora_rank: int = 0
    # citation for the exact config
    source: str = ""

    def __post_init__(self):
        if self.family not in ARCH_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.attention not in ATTENTION_KINDS:
            raise ValueError(f"unknown attention {self.attention!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    # ---- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def uses_attention(self) -> bool:
        return self.attention != "none"

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        M, Hd = self.d_model, self.head_dim
        q = self.num_heads * Hd
        kv = self.num_kv_heads * Hd
        attn = M * q + 2 * M * kv + q * M
        if self.mla_kv_lora_rank:
            attn = M * self.mla_kv_lora_rank * 2 + self.mla_kv_lora_rank * (
                2 * self.num_heads * Hd) + q * M
        dense_ffn = 3 * M * self.ffn_dim if self.ffn_dim else 0
        per_layer = attn + dense_ffn
        n = self.num_layers * per_layer
        if self.moe is not None:
            moe_ffn = 3 * M * self.moe.expert_ffn_dim * self.moe.num_experts
            moe_ffn += 3 * M * self.moe.shared_ffn_dim * self.moe.num_shared_experts
            moe_ffn += M * self.moe.num_experts  # router
            n_moe_layers = len(self.moe_layer_indices())
            n += n_moe_layers * moe_ffn
            n -= n_moe_layers * dense_ffn  # MoE layers replace dense FFN
        if self.recurrent is not None:
            w = self.recurrent.lru_width or M
            n += self.num_layers * (2 * M * w + 2 * w)
        emb = self.vocab_size * M * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            n += self.num_encoder_layers * per_layer
        return n + emb

    def moe_layer_indices(self):
        if self.moe is None:
            return []
        m = self.moe
        return [i for i in range(self.num_layers)
                if i >= m.moe_layer_start
                and (i - m.moe_layer_start) % m.moe_layer_every == 0]

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            ffn_dim=min(self.ffn_dim, 512) if self.ffn_dim else 0,
            vocab_size=min(self.vocab_size, 1024),
            head_dim=0,
            sliding_window=min(self.sliding_window, 64),
            num_encoder_layers=min(self.num_encoder_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 16),
            mla_kv_lora_rank=min(self.mla_kv_lora_rank, 64),
            mla_q_lora_rank=min(self.mla_q_lora_rank, 64),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_ffn_dim=min(self.moe.expert_ffn_dim, 128),
                shared_ffn_dim=min(self.moe.shared_ffn_dim, 128),
            )
        if self.recurrent is not None:
            kw["recurrent"] = dataclasses.replace(
                self.recurrent,
                lru_width=min(self.recurrent.lru_width, 256)
                if self.recurrent.lru_width else 0,
            )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)
