"""Step builders of the port: the eager counterparts of the reference's
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``
(``repro.launch.steps``), with no shardings, and the stubbed modality
frontend's inputs.

  * ``frontend_inputs``    the stub's N(0, 1) patch or frame embeddings of
    ``models.frontend_shape``, drawn from an explicit generator;
  * ``make_prefill_step``  an encoder-decoder model encodes the frames and
    prefills with the memory; a vlm model prefills with the patch
    embeddings in front of the tokens;
  * ``make_serve_step``    ONE greedy decode step against the caches (and
    the encoder's memory);
  * ``make_train_step``    ``Model.loss``'s gradients (``loss_and_grads``,
    accumulated over micro-batches) and one AdamW update in place.

The sharded train step, the shardings and the mesh specs of the
reference's ``input_specs`` are not ported (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import frontend_shape
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import AdamWConfig, apply_updates
from repro_torch.training.tree import tree_leaves, tree_unflatten


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


def loss_and_grads(model: Model, params, tokens, extra=None,
                   accum_steps: int = 1, accum_dtype=torch.float32,
                   ce_chunk: Optional[int] = None):
    """(loss, grads) of ``model.loss`` over the batch, the reference's
    ``value_and_grad``: ``grads`` has the structure of ``params`` (float
    leaves), each leaf in its parameter's dtype (zeros where the loss
    does not reach it). With ``accum_steps`` > 1 the batch is split into
    that many micro-batches in row order, each one's gradients added into
    ``accum_dtype`` accumulators and divided by ``accum_steps`` (the
    reference's scan), as is the loss. ``params`` is left as it is: its
    leaves are differentiated through detached aliases."""
    wrt = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, wrt)

    def grads_of(tok, ex):
        with torch.enable_grad():
            if ce_chunk is not None:
                loss = model.loss(tree, tok, extra_embeds=ex,
                                  ce_chunk=ce_chunk)
            else:
                loss = model.loss(tree, tok, extra_embeds=ex)
            got = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), [torch.zeros_like(a) if g is None else g
                               for a, g in zip(wrt, got)]

    tokens = torch.as_tensor(tokens).to(model.device)
    if accum_steps <= 1:
        loss, grads = grads_of(tokens, extra)
    else:
        mb = tokens.shape[0] // accum_steps
        acc = [torch.zeros(a.shape, dtype=accum_dtype, device=a.device)
               for a in wrt]
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(accum_steps):
            rows = slice(i * mb, (i + 1) * mb)
            loss_i, g_i = grads_of(tokens[rows],
                                   extra[rows] if extra is not None
                                   else None)
            for a, g in zip(acc, g_i):
                a.add_(g.to(accum_dtype))
            loss = loss + loss_i
            del g_i
        grads = [a / accum_steps for a in acc]
        loss = loss / accum_steps
    return loss, tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    accum_steps: int = 1, accum_dtype=torch.float32,
                    ce_chunk: Optional[int] = None):
    """``train_step(params, opt_state, tokens, extra=None) -> (params,
    opt_state, {"loss", "grad_norm"})``: ``loss_and_grads``, then AdamW
    (the reference's default: bf16 states), which updates ``params`` and
    the states in place. The model trains on the card under
    ``attn_impl="xla"`` and ``moe_impl`` "capacity" or "dense", the
    reference's own training configuration: the expert GEMM kernel has a
    backward, and every other kernel wrapper refuses a tensor that
    requires a gradient."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=torch.bfloat16)

    def train_step(params, opt_state, tokens, extra=None):
        loss, grads = loss_and_grads(model, params, tokens, extra,
                                     accum_steps, accum_dtype, ce_chunk)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
