"""DEP execution on ``torch.distributed`` (PyTorch counterpart of
``repro.core.dep``): the paper's A2E/E2A as r2-chunked ``all_to_all``
collectives over the expert axis.

Each rank runs this module's functions on its own shard, as the
reference's ``shard_map`` body runs on each device: attention is data
parallel over the data axes, routed experts are expert parallel over the
expert axis (``E_pad / mo`` stacked experts per rank), and the router and
shared experts are replicated. ``DepGroups`` carries the process groups.
The two communication phases are

  A2E  [E_pad, c, M] -> [E_loc, mo·c, M]   (peers concatenated on the
       capacity axis in rank order)
  E2A  [E_loc, mo·c, M] -> [E_pad, c, M]

each one ``all_to_all_single`` over a contiguous [mo, E_loc, c, M] view,
with a permute on the receiving (A2E) or sending (E2A) side.

The executor WALKS the task-graph IR: ``moe_apply_dep`` lowers the
resolved plan to an ``ExecProgram`` (or takes one) and runs one handler
per task of ``program.walk()`` — GATE → router dispatch, A2E/E2A → chunk
all_to_all (buffer slice and all_reduce combine in replicated decode
mode), EXP → the expert GEMM kernel's wrapper, SHARED → a shared-expert
row segment, REP → the replicated hot experts on local rows. Streams
(r1 > 1) are a capacity split of one router dispatch, so
``interleave="streams"`` and ``"off"`` compute the same values in
another order.

On a CUDA device A2E and E2A run on a communication stream and EXP and
SHARED on the caller's (compute) stream; an event per (micro-batch,
chunk) and direction orders the two, the comm stream is forked from the
compute stream at its first wait and joined back into it at the end of
the call, so a CUDA graph capture records both streams. Every tensor
either stream touches is made on the compute stream and held until the
join. On the CPU (gloo) the walk runs in order on the one stream.

Under a ``repro_torch.obs`` tracer (``use_tracer``) the walk records one
host span per task it runs, as the reference's walk does; a device-mode
tracer also times each task on the card with a CUDA event pair, A2E and
E2A on the comm stream around their ``all_to_all_single`` (after the
wait for the compute stream), the other tasks on the compute stream.
With no tracer the walk is the bare loop.

A placement (``repro_torch.placement.Placement``) reaches the walk as
device tensors made once per placement, outside any step
(``DevicePlacement``): a step, and so a CUDA graph, copies nothing from
the host for it.

Two dispatch modes, as in the reference, chosen by the caller from the
layer's GLOBAL sequence length (``seq_mode``):
  * "sequence" (prefill; any call at an expert group of one rank): each
    peer routes its own slice of the sequence and the buffers are
    exchanged with all_to_all;
  * "replicated" (decode with fewer positions than peers): tokens are
    replicated over the expert axis; each peer runs only its experts and
    the combine is one all_reduce.
On top of either, the data axes shard the batch when it divides over them
(``batch_split``). ``split_tokens`` takes a rank's slice of a layer's
[B, S, M] input and ``gather_tokens`` rebuilds the whole output from the
ranks' slices, the reference's ``shard_map`` in- and out-specs done by
hand.

Sharded weights: each rank holds its ``E_pad / mo`` experts.
``permute_experts`` moves rows between the ranks for a new placement and
``DevicePlacement.build`` fetches the replicated hot experts from the
ranks that own them.

Under autograd (the sharded train step) every exchange of the walk is
differentiable: an A2E or E2A all_to_all's backward is the reverse
all_to_all of the gradient (``reverse_exchange``), an all_reduce's (the
replicated-decode combine, the aux loss's device mean) is the all_reduce
of the gradient, and ``gather_tokens``' is the sum over the token group
of the gradient, sliced back to the rank's part. Each rank then holds
the gradient of the sum over the ranks of their losses: the train step
divides its loss by the world size.
"""
from __future__ import annotations

import os
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig
from repro_torch.core import taskgraph as tg
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp_apply
# module-level so the no-tracer walk pays no per-call import lookup
from repro_torch.obs.trace import active_tracer
from repro_torch.placement import Placement


@dataclass(eq=False)
class DepGroups:
    """One rank's process groups for DEP: the expert axis (``expert``,
    where this rank is ``expert_rank`` of ``expert_size``), the data axes
    (``data``, where it is ``data_rank``) and every device (``world``, for
    the aux loss and the token gather). ``backend`` is the groups'
    ("nccl" or "gloo"); ``control`` is a gloo group over the world for
    the serving engine's lock-step headers (host tensors; the world
    itself under gloo), None at world size 1. The comm stream and the
    events that order it against the compute stream are made once, at
    their first use on a CUDA device, and reused by every call (an engine
    shares them across steps and graph captures)."""

    expert: object
    expert_rank: int
    expert_size: int
    data: object
    world: object
    world_size: int
    data_rank: int = 0
    backend: str = "gloo"
    control: object = None
    _stream: Optional[torch.cuda.Stream] = field(default=None, repr=False)
    _events: Dict[Tuple[str, int], torch.cuda.Event] = field(
        default_factory=dict, repr=False)

    @classmethod
    def build(cls, data_size: int, expert_size: int) -> "DepGroups":
        """The groups of a (data x expert) layout over the default process
        group, which must hold ``data_size * expert_size`` ranks; rank
        ``d * expert_size + m`` is expert peer ``m`` of data shard ``d``
        (the device order of a ("data", "model") mesh). Every rank must
        call this, in the same order (``new_group`` is collective)."""
        world = dist.group.WORLD
        n = dist.get_world_size()
        if n != data_size * expert_size:
            raise ValueError(f"world of {n} ranks is not {data_size} x "
                             f"{expert_size}")
        rank = dist.get_rank()
        d, m = divmod(rank, expert_size)
        backend = str(dist.get_backend())
        expert = data = world
        if data_size > 1 and expert_size > 1:
            for dd in range(data_size):
                g = dist.new_group([dd * expert_size + mm
                                    for mm in range(expert_size)])
                if dd == d:
                    expert = g
            for mm in range(expert_size):
                g = dist.new_group([dd * expert_size + mm
                                    for dd in range(data_size)])
                if mm == m:
                    data = g
        control = None
        if n > 1:
            control = (world if backend == "gloo"
                       else dist.new_group(list(range(n)), backend="gloo"))
        return cls(expert=expert, expert_rank=m, expert_size=expert_size,
                   data=data, world=world, world_size=n, data_rank=d,
                   backend=backend, control=control)

    @classmethod
    def single(cls, backend: str) -> "DepGroups":
        """An expert group of one rank: initializes the default process
        group over an in-process store (no network) unless one exists.
        Under NCCL the communicator is made now, on the current card, not
        at the first collective of a serve."""
        if not dist.is_initialized():
            device = (torch.device("cuda", torch.cuda.current_device())
                      if backend == "nccl" else None)
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, device_id=device)
        return cls.build(1, dist.get_world_size())

    @classmethod
    def from_file_store(cls, directory: str, rank: int, data_size: int,
                        expert_size: int, backend: str) -> "DepGroups":
        """This process as rank ``rank`` of a (``data_size`` x
        ``expert_size``) layout: initializes the default process group
        over a ``file://`` store in ``directory`` (made if missing; every
        rank names the same one, fresh for each run; no TCP port is opened
        for the store) and builds the groups.
        ``backend`` is the caller's choice: "nccl" when each rank has a
        card of its own (the current CUDA device), "gloo" on the CPU or
        when ranks share a card."""
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        n = data_size * expert_size
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else None)
        os.makedirs(directory, exist_ok=True)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.abspath(directory)}/store",
            rank=rank, world_size=n, device_id=device)
        return cls.build(data_size, expert_size)

    @classmethod
    def from_mesh(cls, mesh, model_axis: str = "model") -> "DepGroups":
        """This rank's groups on a ``DeviceMesh`` over the whole default
        process group whose last axis is the model axis
        (``launch.mesh.make_host_mesh``'s ("data", "model"),
        ``make_production_mesh``'s ("pod", "data", "model")): the model
        axis is the expert axis and every other axis, flattened major
        first, the data axis; no ``control`` group (the launch steps need
        no lock step)."""
        names = tuple(mesh.mesh_dim_names)
        if len(names) < 2 or names[-1] != model_axis:
            raise ValueError(f"a (..., data, {model_axis!r}) mesh, not "
                             f"{names}")
        n = mesh.size()
        if n != dist.get_world_size():
            raise ValueError(f"mesh of {n} ranks, world of "
                             f"{dist.get_world_size()}")
        coord = mesh.get_coordinate()
        mo = mesh.size(len(names) - 1)
        if len(names) == 2:
            data = mesh.get_group(names[0])
            data_rank = coord[0]
        else:
            # one group per model coordinate, made by every rank in the
            # same order; this rank keeps its own
            ranks = mesh.mesh.reshape(-1, mo)
            data = None
            for m in range(mo):
                g = dist.new_group(ranks[:, m].tolist())
                if m == coord[-1]:
                    data = g
            data_rank = dist.get_rank() // mo
        return cls(expert=mesh.get_group(model_axis),
                   expert_rank=coord[-1], expert_size=mo, data=data,
                   world=dist.group.WORLD, world_size=n,
                   data_rank=data_rank,
                   backend=str(dist.get_backend()))

    def expert_peer(self, m: int) -> int:
        """The global rank of expert peer ``m`` of this rank's data
        shard."""
        return self.data_rank * self.expert_size + m

    def stream(self, device: torch.device) -> Optional[torch.cuda.Stream]:
        """The comm stream on a CUDA ``device``; None on the CPU."""
        if device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def event(self, name: str, index: int) -> torch.cuda.Event:
        ev = self._events.get((name, index))
        if ev is None:
            ev = self._events[(name, index)] = torch.cuda.Event()
        return ev


class LayerPlacement(NamedTuple):
    """One MoE layer's placement arguments of ``moe_apply_dep``: the
    ``Placement``, its logical -> buffer-row ``expert_map`` [E_pad] and
    replicated experts' rows ``hot_rows`` [n_hot] (int64, on the layer's
    device; None without replicas) and the layer's ``hot_weights``."""

    placement: Placement
    expert_map: torch.Tensor
    hot_rows: Optional[torch.Tensor]
    hot_weights: Optional[dict]


@dataclass(frozen=True, eq=False)
class DevicePlacement:
    """A ``Placement`` with the device tensors the DEP walk reads, made
    once when the placement is installed (``build``): ``expert_map`` and
    ``hot_rows`` as in ``LayerPlacement``, and per layer of the model the
    replicated experts' weights gathered from that layer's stacked
    (already permuted) experts, None for a layer without them. Compared
    by identity: a decode graph keyed on it holds its tensors."""

    placement: Placement
    expert_map: torch.Tensor
    hot_rows: Optional[torch.Tensor]
    hot_weights: Tuple[Optional[dict], ...]

    @classmethod
    def build(cls, placement: Placement, layers, device: torch.device,
              groups: Optional[DepGroups] = None) -> "DevicePlacement":
        """``layers`` is the model's ``params["layers"]`` list, whose
        stacked experts are already in ``placement``'s physical order:
        every row on an expert group of one rank, this rank's
        ``E_pad / mo`` rows of ``groups``' expert axis otherwise. A hot
        expert's weights then come from the peer that owns its row, one
        broadcast over the expert group per owner, tensor and layer
        (every peer calls this, in the same order)."""
        perm = placement.perm
        expert_map = torch.tensor(perm, dtype=torch.long, device=device)
        hot_rows = None
        hot = [None] * len(layers)
        if placement.hot_experts:
            rows = [perm[e] for e in placement.replicated]
            hot_rows = torch.tensor(rows, dtype=torch.long, device=device)
            for i, layer in enumerate(layers):
                experts = layer.get("moe", {}).get("experts")
                if experts is not None:
                    hot[i] = {k: _hot_rows(v, rows, groups)
                              for k, v in experts.items()}
        return cls(placement, expert_map, hot_rows, tuple(hot))

    def layer(self, index: int) -> LayerPlacement:
        return LayerPlacement(self.placement, self.expert_map,
                              self.hot_rows, self.hot_weights[index])


def _hot_rows(stack: torch.Tensor, rows, groups: Optional[DepGroups]):
    """The physical ``rows`` of a stacked expert tensor, [len(rows), ...]:
    taken from ``stack`` itself on an expert group of one rank; else each
    row from the peer that holds it (``stack`` being this rank's
    ``E_loc`` rows), broadcast once per owning peer."""
    if groups is None or groups.expert_size == 1:
        return stack.index_select(
            0, torch.tensor(rows, dtype=torch.long, device=stack.device))
    E_loc = stack.shape[0]
    out = stack.new_empty((len(rows),) + tuple(stack.shape[1:]))
    for owner in sorted({r // E_loc for r in rows}):
        mine = [j for j, r in enumerate(rows) if r // E_loc == owner]
        buf = stack.new_empty((len(mine),) + tuple(stack.shape[1:]))
        if owner == groups.expert_rank:
            buf.copy_(stack[[rows[j] % E_loc for j in mine]])
        dist.broadcast(buf, src=groups.expert_peer(owner),
                       group=groups.expert)
        out[mine] = buf
    return out


def permute_experts(layers, gather, groups: Optional[DepGroups],
                    device: torch.device) -> None:
    """Move every MoE layer's stacked expert rows in place so that
    physical row ``p`` afterwards holds what row ``gather[p]`` held
    (``gather`` over all ``E_pad`` rows). Each tensor keeps its storage
    (``copy_`` / ``index_copy_``), so captured graphs keep their operands.
    On an expert group of several ranks each rank holds rows
    ``[m·E_loc, (m+1)·E_loc)``: it sends the rows that leave it and
    receives the rows that arrive, one ``all_to_all_single`` over the
    expert group per tensor (every peer calls this, in the same order)."""
    mo = 1 if groups is None else groups.expert_size
    E_loc = len(gather) // mo
    me = 0 if groups is None else groups.expert_rank
    send_rows, in_splits, out_splits, dst = [], [], [], []
    for q in range(mo):               # what this rank sends to peer q
        rows = [gather[p] - me * E_loc for p in range(q * E_loc,
                                                      (q + 1) * E_loc)
                if gather[p] // E_loc == me]
        send_rows += rows
        in_splits.append(len(rows))
    for src in range(mo):             # what arrives from peer src
        rows = [p - me * E_loc for p in range(me * E_loc, (me + 1) * E_loc)
                if gather[p] // E_loc == src]
        dst += rows
        out_splits.append(len(rows))
    send_idx = torch.tensor(send_rows, dtype=torch.long, device=device)
    dst_idx = torch.tensor(dst, dtype=torch.long, device=device)
    for layer in layers:
        for t in layer.get("moe", {}).get("experts", {}).values():
            flat = t.view(E_loc, -1)
            moved = flat.index_select(0, send_idx)
            if mo > 1:
                recv = torch.empty_like(moved)
                dist.all_to_all_single(recv, moved, out_splits, in_splits,
                                       group=groups.expert)
                moved = recv
            flat.index_copy_(0, dst_idx, moved)


class _Streams:
    """Orders the comm stream against the compute stream (the current
    one) with the groups' events; does nothing on the CPU.
    ``timed_kinds`` are the tasks whose handlers time their own device
    span (on the comm stream) under a device-mode tracer."""

    def __init__(self, groups: Optional[DepGroups], device: torch.device,
                 timed_kinds=()):
        self.groups = groups
        self.comm = groups.stream(device) if groups is not None else None
        self.compute = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self.timed_kinds = timed_kinds

    def to_comm(self, name: str, index: int) -> None:
        """The comm stream's next work waits for the compute stream's."""
        if self.comm is not None:
            ev = self.groups.event(name, index)
            ev.record(self.compute)
            self.comm.wait_event(ev)

    def to_compute(self, name: str, index: int) -> None:
        """The compute stream's next work waits for the comm stream's."""
        if self.comm is not None:
            ev = self.groups.event(name, index)
            ev.record(self.comm)
            self.compute.wait_event(ev)

    def on_comm(self):
        return (torch.cuda.stream(self.comm) if self.comm is not None
                else nullcontext())


def reverse_exchange(grad: torch.Tensor, shape, group) -> torch.Tensor:
    """The backward of an A2E or E2A exchange: the gradient of the
    received [mo, ...] tensor goes back to the peers it came from, one
    ``all_to_all_single`` over the expert group (chunk p to peer p, peer
    p's chunk into slot p), giving the gradient of the sent tensor of
    ``shape``. It runs on the stream autograd gives the node, the
    compute stream of the forward call, after the gradient's producer."""
    out = grad.new_empty(shape)
    dist.all_to_all_single(out, grad.contiguous(), group=group)
    return out


class _Exchange(torch.autograd.Function):
    """One A2E or E2A all_to_all of the walk: ``run(recv, send)`` issues
    the forward exchange into ``recv`` (allocated here, on the caller's
    stream; the walk's ``run`` moves the collective to its comm stream);
    the backward is ``reverse_exchange``."""

    @staticmethod
    def forward(ctx, send, shape, group, run):
        ctx.group, ctx.shape = group, send.shape
        recv = send.new_empty(shape)
        run(recv, send)
        return recv

    @staticmethod
    def backward(ctx, grad):
        return reverse_exchange(grad, ctx.shape, ctx.group), None, None, None


class _AllReduce(torch.autograd.Function):
    """A sum over ``group`` in place; its backward sums the gradient over
    the group the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a fresh tensor, overwritten) summed over ``group``, as a
    differentiable op."""
    return _AllReduce.apply(x, group)


def seq_mode(seq_len: int, expert_size: int) -> bool:
    """The reference's dispatch-mode rule for a GLOBAL sequence length:
    sequence mode when the sequence splits evenly over the expert axis,
    replicated-token mode otherwise."""
    return seq_len % expert_size == 0 and seq_len >= expert_size


def batch_split(batch: int, groups: DepGroups) -> bool:
    """The reference's batch rule (``batch_pspec``): the data axes shard
    a GLOBAL batch that divides over them; otherwise every data shard
    holds the whole batch."""
    dp = groups.world_size // groups.expert_size
    return dp > 1 and batch % dp == 0


def split_tokens(h: torch.Tensor, groups: DepGroups, sequence: bool,
                 batch_sharded: bool) -> torch.Tensor:
    """This rank's slice of a layer's global [B, S, M] tokens: its data
    shard of the batch when ``batch_sharded``, and in sequence mode its
    ``S / mo`` positions along the sequence."""
    B, S, _ = h.shape
    if batch_sharded:
        Bl = B // (groups.world_size // groups.expert_size)
        h = h[groups.data_rank * Bl:(groups.data_rank + 1) * Bl]
    if sequence and groups.expert_size > 1:
        Sl = S // groups.expert_size
        h = h[:, groups.expert_rank * Sl:(groups.expert_rank + 1) * Sl]
    return h


def gather_tokens(y: torch.Tensor, groups: DepGroups, sequence: bool,
                  batch_sharded: bool) -> torch.Tensor:
    """The global [B, S, M] output from every rank's ``split_tokens``
    slice [Bl, Sl, M]: one ``all_gather`` over the ranks that shard the
    tokens (``_token_group``; nothing when no other rank holds other
    tokens), whose (data, expert) rank order puts each slice back in
    place."""
    group = _token_group(groups, sequence, batch_sharded)
    if group is None:
        return y
    over_data = batch_sharded and groups.world_size > groups.expert_size
    over_expert = sequence and groups.expert_size > 1
    n_d = groups.world_size // groups.expert_size if over_data else 1
    n_m = groups.expert_size if over_expert else 1
    part = (groups.data_rank if over_data else 0,
            groups.expert_rank if over_expert else 0)
    return _GatherTokens.apply(y.contiguous(), group, n_d, n_m, part)


class _GatherTokens(torch.autograd.Function):
    """``gather_tokens``' all_gather; its backward sums the whole
    gradient over the token group and keeps this rank's part."""

    @staticmethod
    def forward(ctx, y, group, n_d, n_m, part):
        Bl, Sl, M = y.shape
        ctx.group, ctx.part, ctx.local = group, part, (Bl, Sl)
        parts = [torch.empty_like(y) for _ in range(n_d * n_m)]
        dist.all_gather(parts, y, group=group)
        return torch.stack(parts).view(n_d, n_m, Bl, Sl, M) \
            .transpose(1, 2).reshape(n_d * Bl, n_m * Sl, M)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        (d, m), (Bl, Sl) = ctx.part, ctx.local
        return (grad[d * Bl:(d + 1) * Bl, m * Sl:(m + 1) * Sl],
                None, None, None, None)


def as_exec_program(plan) -> tg.ExecProgram:
    """The executor's program for ``plan``: an ``ExecProgram`` passes
    through; a bare ``TaskGraph`` is wrapped with ``interleave="off"``; a
    ``Plan`` is lowered from its (r2, order, m_e) slice; None means the
    unchunked single-stream r2=1 schedule."""
    if plan is None:
        return tg.ExecProgram(tg.lower_exec(1, "AASS", 1))
    if isinstance(plan, tg.ExecProgram):
        return plan
    if isinstance(plan, tg.TaskGraph):
        return tg.ExecProgram(plan)
    r2 = max(int(getattr(plan, "r2", 1) or 1), 1)
    m_e = getattr(plan, "m_e", 1) or 1
    return tg.ExecProgram(tg.lower_exec(r2, getattr(plan, "order", "AASS"),
                                        max(int(m_e), 1)))


def as_exec_graph(plan) -> tg.TaskGraph:
    """The executor's task graph for ``plan`` (see ``as_exec_program``;
    this is its ``.graph`` view for callers that only need structure)."""
    return as_exec_program(plan).graph


def _shared_part(shared_fn, shared_x, k: int, n_seg: int):
    """The shared-expert GEMM for segment ``k`` of ``n_seg``: each (mb,
    boundary) SHARED task owns one equal row range of the local batch,
    the last one the remainder. Rows are independent, so the segments
    concatenate back to the whole-batch product."""
    if n_seg == 1:
        return shared_fn(shared_x)
    seg = shared_x.shape[0] // n_seg
    lo = k * seg
    hi = shared_x.shape[0] if k == n_seg - 1 else (k + 1) * seg
    return shared_fn(shared_x[lo:hi])


def _walk_chunk_stream(program, handlers, streams=None,
                       tracer=None) -> None:
    """Run the program's executed order: ``handlers`` maps task kind ->
    callable(task) returning the task's value; kinds without a handler
    are skipped (SHARED for a model without a shared expert, GATE and
    ATTN, which the caller runs). A bare ``TaskGraph`` means its
    single-stream ``interleave="off"`` walk.

    When a ``repro_torch.obs`` tracer is scoped (``use_tracer``) around
    the caller (or given as ``tracer``), each handler call is wrapped in
    a host task span (``emit=True``), and with ``fence=True`` the walker
    waits for the task's stream before closing it. A device-mode tracer
    also times each task on the card (``streams``, the walk's
    ``_Streams``, on a CUDA device): the compute stream's tasks by an
    event pair around the handler, after a base event recorded before
    the walk; A2E and E2A of the sequence walk time their own
    all_to_all on the comm stream (``_graph_expert_alltoall``). With no
    active tracer (the default) this is the bare loop."""
    if isinstance(program, tg.TaskGraph):
        program = tg.ExecProgram(program)
    tracer = tracer if tracer is not None else active_tracer()
    if tracer is None:
        for task in program.walk():
            h = handlers.get(task.kind)
            if h is not None:
                h(task)
        return
    compute = streams.compute if streams is not None else None
    comm = streams.comm if streams is not None else None
    own = streams.timed_kinds if streams is not None else ()
    tracer.device_base(compute)
    clock = tracer.clock
    for task in program.walk():
        h = handlers.get(task.kind)
        if h is None:
            continue
        t0 = clock()
        if task.kind in own:
            out = h(task)
            tracer.maybe_fence(out, comm)
        else:
            with tracer.device_task(task, compute):
                out = h(task)
            tracer.maybe_fence(out, compute)
        tracer.task_span(task, t0, clock(), emit=True)


def _a2e_layout(recv: torch.Tensor) -> torch.Tensor:
    """A2E's receive side: [mo, E_loc, c, M] (peer p's chunk for this
    rank's experts at index p) -> [E_loc, mo·c, M], peers concatenated on
    the capacity axis in rank order."""
    mo, E_loc, c, M = recv.shape
    return recv.permute(1, 0, 2, 3).reshape(E_loc, mo * c, M)


def _e2a_layout(out: torch.Tensor, mo: int) -> torch.Tensor:
    """E2A's send side: [E_loc, mo·c, M] -> a contiguous [mo, E_loc, c, M]
    whose index p goes back to peer p."""
    E_loc, C, M = out.shape
    return out.reshape(E_loc, mo, C // mo, M).permute(1, 0, 2, 3) \
              .contiguous()


def _graph_expert_alltoall(program: tg.ExecProgram, buffers, expert_params,
                           groups: DepGroups, shared_fn=None, shared_x=None,
                           hot_weights=None, hot_rows=None):
    """Sequence-mode walk: buffers [E_pad, C_loc, M] per peer ->
    (outputs [E_pad, C_loc, M] back in dispatch layout, shared_out or
    None). Task (stream i, chunk j) covers capacity columns
    [(i·r2+j)·c, (i·r2+j+1)·c); the results reassemble in fixed (i, j)
    order, so the values do not depend on the stream count or the walk
    order. ``hot_weights``/``hot_rows`` run the REP task: the replicated
    hot experts' FFN on this peer's own dispatch rows, spliced over the
    rows the wire round trip returned for them (each row depends only on
    itself and its expert's weights, so the splice is bitwise the wire's
    result)."""
    graph = program.graph
    E_pad, C_loc, M = buffers.shape
    r1, r2 = graph.r1, graph.r2
    chunk = C_loc // (r1 * r2)
    n_seg = graph.shared_segments          # per stream
    rep_chunk = C_loc // r1                # REP slice width per stream
    mo = groups.expert_size
    E_loc = E_pad // mo
    streams = _Streams(groups, buffers.device, timed_kinds=(tg.A2E, tg.E2A))
    tracer = active_tracer()
    held = []                              # alive until the join
    dispatched = {}
    ffn_out = {}
    outs = {}
    shared_parts = {}
    hot_out = {}

    def exchange(task, name, index, send, shape):
        def run(recv, send):
            held.extend((send, recv))
            streams.to_comm(name, index)
            with streams.on_comm(), (
                    nullcontext() if tracer is None
                    else tracer.device_task(task, streams.comm, "comm")):
                dist.all_to_all_single(recv, send, group=groups.expert)
        return _Exchange.apply(send, shape, groups.expert, run)

    def on_a2e(t):     # [E_pad, c, M] -> [E_loc, mo*c, M]
        i = t.mb * r2 + t.chunk
        send = buffers[:, i * chunk:(i + 1) * chunk].contiguous()
        recv = exchange(t, "a2e_send", i, send, (mo, E_loc, chunk, M))
        streams.to_compute("a2e_recv", i)
        dispatched[(t.mb, t.chunk)] = recv
        return recv

    def on_shared(t):
        if shared_fn is not None:
            out = shared_parts[(t.mb, t.chunk)] = _shared_part(
                shared_fn, shared_x, t.mb * n_seg + t.chunk, r1 * n_seg)
            return out

    def on_exp(t):
        x = _a2e_layout(dispatched.pop((t.mb, t.chunk)))
        out = ffn_out[(t.mb, t.chunk)] = moe_lib.expert_ffn(expert_params,
                                                            x)
        return out

    def on_e2a(t):     # [E_loc, mo*c, M] -> [E_pad, c, M]
        i = t.mb * r2 + t.chunk
        send = _e2a_layout(ffn_out.pop((t.mb, t.chunk)), mo)
        recv = exchange(t, "e2a_send", i, send, send.shape)
        outs[(t.mb, t.chunk)] = recv.view(E_pad, chunk, M)
        return recv

    def on_rep(t):     # hot-expert FFN on the locally resident rows
        rows = buffers[hot_rows][:, t.mb * rep_chunk:(t.mb + 1) * rep_chunk]
        out = hot_out[t.mb] = moe_lib.expert_ffn(hot_weights, rows)
        return out

    handlers = {tg.A2E: on_a2e, tg.SHARED: on_shared,
                tg.EXP: on_exp, tg.E2A: on_e2a}
    if hot_weights is not None:
        handlers[tg.REP] = on_rep
    _walk_chunk_stream(program, handlers, streams, tracer)
    if hot_weights is not None and not hot_out:
        # a graph lowered without a REP task: still run the hot FFN
        hot_out[0] = moe_lib.expert_ffn(hot_weights, buffers[hot_rows])
    streams.to_compute("join", 0)
    shared_out = (torch.cat([shared_parts[k] for k in sorted(shared_parts)])
                  if shared_parts else None)
    out = torch.cat([outs[k] for k in sorted(outs)], dim=1)
    if hot_out:
        out[hot_rows] = torch.cat([hot_out[k] for k in sorted(hot_out)],
                                  dim=1)
    del held
    return out, shared_out


def _graph_replicated_experts(program: tg.ExecProgram, local_buf,
                              expert_params, shared_fn=None, shared_x=None):
    """Replicated-token decode walk: each peer runs only its local
    experts' chunks; A2E tasks are buffer slices (the transport is the
    one all_reduce after the walk) and SHARED tasks interleave per the
    solved order. The same (stream, chunk) split and fixed-order
    reassembly as the sequence walk."""
    graph = program.graph
    cap = local_buf.shape[1]
    r1, r2 = graph.r1, graph.r2
    chunk = cap // (r1 * r2)
    n_seg = graph.shared_segments
    sliced = {}
    outs = {}
    shared_parts = {}

    def on_a2e(t):
        i = t.mb * r2 + t.chunk
        out = sliced[(t.mb, t.chunk)] = local_buf[:, i * chunk:(i + 1)
                                                  * chunk]
        return out

    def on_shared(t):
        if shared_fn is not None:
            out = shared_parts[(t.mb, t.chunk)] = _shared_part(
                shared_fn, shared_x, t.mb * n_seg + t.chunk, r1 * n_seg)
            return out

    def on_exp(t):
        out = outs[(t.mb, t.chunk)] = moe_lib.expert_ffn(
            expert_params, sliced.pop((t.mb, t.chunk)))
        return out

    tracer = active_tracer()
    _walk_chunk_stream(program, {tg.A2E: on_a2e, tg.SHARED: on_shared,
                                 tg.EXP: on_exp},
                       None if tracer is None
                       else _Streams(None, local_buf.device), tracer)
    shared_out = (torch.cat([shared_parts[k] for k in sorted(shared_parts)])
                  if shared_parts else None)
    out = torch.cat([outs[k] for k in sorted(outs)], dim=1)
    return out, shared_out


def _token_group(groups: DepGroups, sequence: bool, batch_sharded: bool):
    """The group over which this rank's tokens are one shard of the
    layer's: the data axes (when they shard the batch) and, in sequence
    mode, the expert axis; None when no other rank holds other tokens.
    The reference's ``psum`` over ``tok_axes``."""
    over_data = batch_sharded and groups.world_size > groups.expert_size
    over_expert = sequence and groups.expert_size > 1
    if over_data and over_expert:
        return groups.world
    if over_data:
        return groups.data
    return groups.expert if over_expert else None


def moe_apply_dep(params, x, mcfg: MoEConfig, groups: DepGroups,
                  num_experts_padded: int = 0, plan=None, placement=None,
                  hot_weights=None, expert_map=None, hot_rows=None,
                  with_aux: bool = True, return_stats: bool = False,
                  capacity_scale: float = 1.0, *, sequence: bool,
                  batch_sharded: bool):
    """Schedule-driven MoE layer on one rank. ``x`` [Bl, Sl, M] is this
    rank's tokens in the reference's layout (``split_tokens``): its data
    shard when ``batch_sharded`` (``batch_split`` of the global batch),
    and in sequence mode its slice of the sequence over the expert axis.
    ``params["experts"]`` holds this rank's ``E_pad / mo`` experts; the
    router and ``params["shared"]`` are replicated. ``plan`` is an
    ``ExecProgram`` (see ``Plan.exec_program``), a ``TaskGraph``, a
    ``Plan`` or None (the unchunked r2=1 schedule).

    ``sequence`` is the dispatch mode, ``seq_mode`` of the layer's
    GLOBAL sequence length, which the caller knows and ``x`` does not
    (a global S = 4 at mo = 4 gives each peer one position: sequence
    mode all the same). At a group of one rank every call is in sequence
    mode; in replicated decode x holds every position, on every peer of
    the expert group. ``placement`` (a
    ``Placement`` over the padded experts) re-homes each logical expert
    to the buffer row of ``placement.perm``; its replicated hot experts
    run the REP task on ``hot_weights`` ([n_hot, ...] in
    ``placement.replicated`` order, held by every rank) in sequence mode.
    ``expert_map`` and ``hot_rows`` are the placement's device tensors
    (``DevicePlacement``), which the caller passes with it.
    ``capacity_scale`` widens the dispatch capacity (1.0: the uniform
    sizing). Returns (y [Bl, Sl, M], aux), aux being the device mean of
    the load balance loss, or None with ``with_aux=False`` (which skips
    its all_reduce); with ``return_stats`` also a ``moe.MoEStats`` of the
    layer's tokens on every rank (``load`` in logical expert ids, summed
    with ``dropped`` over the ranks that shard the tokens). Every
    exchange is differentiable (the module docstring), so the layer
    trains: the expert GEMM through ``MoEGemmFunction``."""
    Bl, Sl, M = x.shape
    mo = groups.expert_size
    E_pad = num_experts_padded or mcfg.num_experts
    if E_pad % mo:
        raise ValueError(f"{E_pad} experts do not divide over {mo} ranks")
    program = as_exec_program(plan)
    if placement is not None and placement.is_uniform:
        placement = None        # the plain path IS this placement
    if placement is not None and (placement.num_experts != E_pad
                                  or placement.num_ranks != mo):
        raise ValueError(f"placement of {placement.num_experts} experts on "
                         f"{placement.num_ranks} ranks, layer of {E_pad} "
                         f"on {mo}")
    if placement is not None:
        if expert_map is None:
            raise ValueError("a placement needs its device tensors "
                             "(DevicePlacement)")
        if not (placement.hot_experts and sequence):
            hot_rows = hot_weights = None
        elif hot_weights is None:
            raise ValueError("a placement with replicated experts needs "
                             "their hot_weights")
    else:
        expert_map = hot_rows = hot_weights = None
    xf = x.reshape(-1, M)
    T_loc = xf.shape[0]
    # the GATE task: router dispatch into capacity buffers aligned so
    # each of the r1·r2 (stream, chunk) slices is a multiple of the m_e
    # the solver modeled; capacity only rounds up
    cap = moe_lib.expert_capacity(T_loc, mcfg, E_pad,
                                  multiple_of=program.capacity_multiple,
                                  scale=capacity_scale)
    info = moe_lib.moe_dispatch({"router": params["router"]}, xf, mcfg, cap,
                                E_pad, expert_map=expert_map)
    stats = None
    if return_stats:
        group = _token_group(groups, sequence, batch_sharded)
        if group is not None:
            dist.all_reduce(info.load, group=group)
            dist.all_reduce(info.dropped, group=group)
        stats = moe_lib.MoEStats(load=info.load, dropped=info.dropped)
    shared = params.get("shared")
    shared_fn = None if shared is None else (lambda xs: mlp_apply(shared,
                                                                 xs))
    if sequence:
        out, shared_out = _graph_expert_alltoall(
            program, info.buffers, params["experts"], groups,
            shared_fn=shared_fn, shared_x=xf, hot_weights=hot_weights,
            hot_rows=hot_rows)
        y = moe_lib.moe_combine(info, out, T_loc, x.dtype)
    else:
        # each peer combines only ITS experts' rows into the dense [T, M]
        # output; the transport is one all_reduce of that
        E_loc = E_pad // mo
        lo = groups.expert_rank * E_loc
        local_out, shared_out = _graph_replicated_experts(
            program, info.buffers[lo:lo + E_loc], params["experts"],
            shared_fn=shared_fn, shared_x=xf)
        full = local_out.new_zeros((E_pad,) + local_out.shape[1:])
        full[lo:lo + E_loc] = local_out
        y = all_reduce_sum(moe_lib.moe_combine(info, full, T_loc, x.dtype),
                           groups.expert)
    if shared_out is not None:
        y = y + shared_out
    aux = None
    if with_aux:
        # device mean: exact over distinct shards, unbiased under
        # replication
        aux = all_reduce_sum(info.aux.clone(), groups.world) \
            / groups.world_size
    y = y.reshape(Bl, Sl, M)
    return (y, aux, stats) if return_stats else (y, aux)
