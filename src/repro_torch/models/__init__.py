"""Model substrate of the port: layers, attention, MoE, assembly."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import (ExecutionContext, Model,
                                            layer_kinds)


def build_model(cfg: ModelConfig, ctx: Optional[ExecutionContext] = None,
                dtype=torch.bfloat16, device: DeviceLike = None,
                num_experts_padded: int = 0) -> Model:
    """``device=None`` means the CUDA card (raises without one).
    ``num_experts_padded`` is ``Model``'s."""
    return Model(cfg, ctx=ctx, dtype=dtype, device=device,
                 num_experts_padded=num_experts_padded)


def frontend_shape(cfg: ModelConfig, shape: ShapeConfig):
    """The stubbed modality frontend's output shape (vlm patch embeddings,
    audio frames), or None for a text-only family: the reference's one
    allowed stub, precomputed embeddings in place of a ViT or a speech
    encoder's feature extractor."""
    if cfg.family == "vlm":
        n = cfg.frontend_tokens or 256
        return (shape.global_batch, n, cfg.d_model)
    if cfg.family == "audio":
        # ~6.25 frames/sec after the conv feature extractor; scale with seq
        n = cfg.frontend_tokens or max(64, min(shape.seq_len // 8, 4096))
        return (shape.global_batch, n, cfg.d_model)
    return None


__all__ = ["build_model", "frontend_shape", "ExecutionContext", "Model",
           "layer_kinds"]
