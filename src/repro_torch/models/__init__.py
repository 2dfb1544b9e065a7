"""Model substrate of the port: layers, attention, MoE, assembly."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (ExecutionContext, Model,
                                            layer_kinds)


def build_model(cfg: ModelConfig, ctx: Optional[ExecutionContext] = None,
                dtype=torch.bfloat16, device: DeviceLike = None) -> Model:
    """``device=None`` means the CUDA card (raises without one)."""
    return Model(cfg, ctx=ctx, dtype=dtype, device=device)


__all__ = ["build_model", "ExecutionContext", "Model", "layer_kinds"]
