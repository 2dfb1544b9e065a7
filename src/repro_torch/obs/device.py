"""Executed task spans of one DEP MoE layer (PyTorch counterpart of
``repro.obs.device``).

The host-lane replay (``obs.replay``) gives the attributor executed
spans without a card, but they are *synthetic*: modelled durations run
on worker threads. This module produces spans from the real executor:
it runs ``core.dep.moe_apply_dep`` eagerly on an expert group under a
``TraceRecorder``.

On a CUDA device the recorder is in device mode: every task is timed on
the card by a ``torch.cuda.Event`` pair on the stream that runs it, A2E
and E2A on the comm stream around their ``all_to_all_single``, EXP,
SHARED and REP on the compute stream around their kernels, all measured
from a base event recorded on the compute stream before the walk. The
walk is not serialised (the reference fences every task), so the spans
show the overlap of the two streams as it happened. An event pair times
the stream, idle gaps included: so the layer runs once untraced first
(the kernels loaded, the allocator's blocks cached), and a spin kernel
holds the compute stream while the host enqueues the traced walk, so
that the card runs it back to back and no span holds a wait for the
host (``DeviceTrace.host_ahead`` says whether the hold lasted). On the
CPU the spans are the host emission spans of the walk
(``perf_counter``), in program order.

The reference's ``device_mesh`` builds a ("data", "model") mesh over the
local devices; its counterpart here is a ``DepGroups`` over the default
process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, generator_for, resolve_device
from repro_torch.configs.base import MoEConfig
from repro_torch.obs.trace import Span, TraceRecorder, use_tracer

#: capacity factor generous enough that the proxy layer drops nothing —
#: drops are routing noise the span trace should not depend on
_PROXY_CF = 8.0

#: cycles of the spin kernel that holds the compute stream while the host
#: enqueues a traced walk: about 0.5 s on an H100 at 1.98 GHz. A 20 ms hold
#: was too short on a loaded host: the card caught up with a full-width
#: layer's walk (the forced r1 = 2 x r2 = 4 program) before it was enqueued
_HOLD_CYCLES = 1_000_000_000


def device_mesh(min_devices: int = 2):
    """The ``DepGroups`` of a (data x expert) layout over the default
    process group, the expert axis taking 2 ranks and data the rest, or
    None when it cannot host a DEP exchange (no process group, fewer than
    ``min_devices`` ranks or an odd count). Collective when it builds
    groups: every rank calls it."""
    from repro_torch.core.dep import DepGroups
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if n < min_devices or n % 2:
        return None
    return DepGroups.build(n // 2, 2)


@dataclass
class DeviceTrace:
    """Executed spans from one eager DEP layer run."""

    spans: List[Span]          # cat="task" spans in walk order
    out: torch.Tensor          # the layer output [Bl, Sl, M]
    recorder: TraceRecorder
    wall_s: float
    untraced: Callable[[], torch.Tensor]   # the same call, no tracer
    # on a CUDA device: whether the card was still held when the host had
    # enqueued the whole walk (None on the CPU)
    host_ahead: Optional[bool] = None
    # host seconds from the tracer's start to the walk's last enqueue
    enqueue_s: float = 0.0


def trace_dep_execution(program, groups, *, mode: str = "sequence",
                        d_model: int = 32,
                        mcfg: Optional[MoEConfig] = None,
                        dtype=torch.float32, seed: int = 0,
                        device: DeviceLike = None, params=None,
                        x: Optional[torch.Tensor] = None) -> DeviceTrace:
    """Run one DEP MoE layer for real on ``groups`` (this rank's
    ``DepGroups``) under ``program`` and return its per-task spans: on a
    CUDA device timed on the card (``spans`` are the recorder's
    ``device_spans``), on the CPU the host emission spans.

    By default the layer is the reference's scaled-down proxy (small
    ``d_model``, 2 experts per expert rank, generous capacity) drawn from
    ``seed``, and ``x`` is this rank's [2, S, d_model] shard, S = 4 in
    "sequence" mode and 1 in "replicated" (decode) mode. ``params`` (this
    rank's layer: its experts, the router and shared experts) with its
    ``mcfg``, and ``x``, trace a given layer instead, e.g. a full-width
    one on the card. ``device=None`` means the card."""
    from repro_torch.core.dep import moe_apply_dep, seq_mode
    from repro_torch.models.moe import moe_init

    if mode not in ("sequence", "replicated"):
        raise ValueError(f"mode must be 'sequence' or 'replicated', got "
                         f"{mode!r}")
    device = resolve_device(device)
    mo = groups.expert_size
    if params is None:
        E_pad = 2 * mo
        if mcfg is None:
            mcfg = MoEConfig(num_experts=E_pad, top_k=2,
                             expert_ffn_dim=2 * d_model,
                             num_shared_experts=1, shared_ffn_dim=d_model,
                             capacity_factor=_PROXY_CF)
        gen = generator_for(device, seed)
        params = moe_init(gen, d_model, mcfg, E_pad, dtype=dtype)
        lo = groups.expert_rank * (E_pad // mo)
        params["experts"] = {k: v[lo:lo + E_pad // mo]
                             for k, v in params["experts"].items()}
        if x is None:
            S = 4 if mode == "sequence" else 1
            x = torch.randn((2, S, d_model), generator=gen, device=device,
                            dtype=torch.float32).to(dtype)
    else:
        if mcfg is None or x is None:
            raise ValueError("a given layer needs its mcfg and x")
        E_pad = params["experts"]["gate"].shape[0] * mo

    def call():
        # x is this rank's slice of a global batch over the data axes,
        # and in "sequence" mode of a global sequence over the expert axis
        out, _ = moe_apply_dep(
            params, x, mcfg, groups, E_pad, plan=program, with_aux=False,
            sequence=seq_mode(x.shape[1] * (mo if mode == "sequence" else 1),
                              mo),
            batch_sharded=groups.world_size > mo)
        return out

    def untraced():
        with use_tracer(None):
            return call()

    untraced()                             # warm-up
    rec = TraceRecorder(device=device.type == "cuda")
    if rec.device:
        torch.cuda._sleep(_HOLD_CYCLES)
        rec.device_base(torch.cuda.current_stream(device))
    t0 = rec.clock()
    with use_tracer(rec):
        out = call()
    enqueue_s = rec.clock() - t0
    host_ahead = None
    if rec.device:
        host_ahead = not rec.base_reached()
        spans = rec.resolve_device_spans()   # waits for the card
    else:
        spans = rec.task_spans(emitted=True)
    wall = rec.clock() - t0
    return DeviceTrace(spans=spans, out=out, recorder=rec, wall_s=wall,
                       untraced=untraced, host_ahead=host_ahead,
                       enqueue_s=enqueue_s)
