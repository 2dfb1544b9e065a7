"""Architecture registry of the port: the architectures it serves so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ARCH_FAMILIES, ModelConfig, MoEConfig,
                                      RecurrentConfig)

# arch-id -> module name
_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-1.5b": "qwen2_1_5b",
}

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


__all__ = ["ARCH_FAMILIES", "ALL_ARCHS", "ModelConfig", "MoEConfig",
           "RecurrentConfig", "get_config", "get_smoke_config"]
