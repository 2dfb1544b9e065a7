"""Step builders of the port: the eager counterparts of the reference's
``make_prefill_step`` and ``make_serve_step`` (``repro.launch.steps``),
with no shardings, and the stubbed modality frontend's inputs.

  * ``frontend_inputs``    the stub's N(0, 1) patch or frame embeddings of
    ``models.frontend_shape``, drawn from an explicit generator;
  * ``make_prefill_step``  an encoder-decoder model encodes the frames and
    prefills with the memory; a vlm model prefills with the patch
    embeddings in front of the tokens;
  * ``make_serve_step``    ONE greedy decode step against the caches (and
    the encoder's memory).

The train step, the shardings and the mesh specs of the reference's
``input_specs`` are not ported (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import frontend_shape
from repro_torch.models.transformer import Model


def frontend_inputs(cfg: ModelConfig, batch: int, seq_len: int,
                    generator: torch.Generator, device: DeviceLike = None,
                    dtype=torch.bfloat16):
    """The stub frontend's output for ``batch`` rows of a ``seq_len``-token
    shape: N(0, 1) embeddings of ``frontend_shape`` drawn in float32 from
    ``generator`` (which must live on ``device``) and stored in
    ``dtype``; None for a text-only family. ``device=None`` means the
    card and raises without one."""
    shape = frontend_shape(cfg, ShapeConfig("frontend", seq_len, batch,
                                            "prefill"))
    if shape is None:
        return None
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device}, inputs on "
                         f"{device}")
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def make_prefill_step(model: Model):
    """``prefill_step(params, tokens, extra=None) -> (logits [B,1,V],
    caches)``: ``extra`` is the frontend's output; an encoder-decoder
    model encodes it and prefills the decoder with the memory."""
    def prefill_step(params, tokens, extra=None):
        memory = None
        if model.cfg.is_encoder_decoder and extra is not None:
            memory = model.encode(params, extra)
            extra = None
        return model.prefill(params, tokens, extra_embeds=extra,
                             memory=memory)
    return prefill_step


def make_serve_step(model: Model):
    """``serve_step(params, tokens, caches, memory=None) -> (next tokens
    [B, 1] int64, caches)``: one decode step and its greedy token."""
    def serve_step(params, tokens, caches, memory=None):
        logits, caches = model.decode_step(params, tokens, caches,
                                           memory=memory)
        return logits[:, -1].argmax(-1)[:, None], caches
    return serve_step
