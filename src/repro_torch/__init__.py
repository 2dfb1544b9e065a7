"""PyTorch + CUDA port of the FinDEP serving system.

The JAX package ``repro`` is the reference; this package imports nothing
of it. Plain tensor code is PyTorch, and every kernel the reference wrote
in Pallas for the TPU is a kernel written by hand in CUDA C++ for Hopper
(``repro_torch/csrc``), with a plain PyTorch version beside it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None,
                   allow_meta: bool = False) -> torch.device:
    """The device an entry point runs on. ``None`` means the card: it
    raises when no CUDA device is present, so that nothing silently runs
    on the CPU. Only an explicit ``"cpu"`` selects the plain versions.
    ``"meta"`` (shapes, no data) is accepted only with ``allow_meta``,
    which the spec builders of ``launch.steps`` and the model they build
    pass; no serving or training entry point does."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if device.type == "meta" and allow_meta:
        return device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def generator_for(device: torch.device, seed: int) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


__all__ = ["DeviceLike", "resolve_device", "generator_for"]
