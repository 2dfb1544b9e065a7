"""Architecture registry of the port, the reference's: the ten assigned
architectures (among them the vlm ``internvl2-1b`` and the
encoder-decoder ``seamless-m4t-large-v2``, whose modality frontends are
stubbed by ``models.frontend_shape``), the paper's two MoE backbones
(DeepSeek-V2-Lite with MLA, and Qwen3-MoE with 128 experts, on one card
at reduced depth), and the input shapes."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ARCH_FAMILIES, SHAPES,
                                      DepClusterConfig, ModelConfig,
                                      MoEConfig, RecurrentConfig, ShapeConfig)

# arch-id -> module name
_ARCH_MODULES = {
    "llama3-405b": "llama3_405b",
    "xlstm-1.3b": "xlstm_1_3b",
    "command-r-35b": "command_r_35b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "starcoder2-3b": "starcoder2_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-1b": "internvl2_1b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-1.5b": "qwen2_1_5b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's backbones (also the planner's Table-5/7 shapes)
    "deepseek-v2-lite": "deepseek_v2_lite",
    "qwen3-moe": "qwen3_moe",
}

ASSIGNED_ARCHS = tuple(list(_ARCH_MODULES)[:10])
PAPER_ARCHS = ("deepseek-v2-lite", "qwen3-moe")
ALL_ARCHS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ALL_ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCH_FAMILIES", "ASSIGNED_ARCHS", "PAPER_ARCHS", "ALL_ARCHS",
           "SHAPES", "DepClusterConfig", "ModelConfig", "MoEConfig",
           "RecurrentConfig", "ShapeConfig", "get_config", "get_smoke_config",
           "get_shape"]
