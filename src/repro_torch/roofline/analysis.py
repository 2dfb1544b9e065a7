"""Roofline terms of one step, counted from the ops it dispatches (the
counterpart of ``repro.roofline.analysis``).

    compute term    = FLOPs_per_device   / peak FLOP/s of their dtype
    memory term     = HBM_bytes_per_device / HBM bandwidth
    collective term = wire_bytes_per_device / link bandwidth

The reference reads XLA's ``cost_analysis`` of a compiled program and
parses its HLO for collectives. The port's steps run eagerly, one op at a
time, so ``StepCounter`` (a ``TorchDispatchMode``) counts every op the
step dispatches on one rank:

  * FLOPs: ``torch.utils.flop_counter``'s registered formulas for the
    aten ops (matmuls, convolutions, attention; elementwise ops count
    none), plus each hand-written kernel's ``*_work`` formula, which the
    kernel wrappers report through ``repro_torch.kernels.counted`` (the
    ops of a plain version are hidden from the counter, so a CPU count is
    the function's work, not the plain loop's);
  * HBM bytes: each aten op's inputs read once and outputs written once.
    Ops whose output aliases an input (views, ``reshape``, ``transpose``,
    ``expand``) count 0; a write-only op (``copy_``, ``fill_``) does not
    read its destination; a gather (``index``, ``embedding``) reads the
    rows it returns, a scatter (``index_put_``) the rows it writes, not
    the whole table; allocations (``empty``) count 0;
  * collectives by kind: the count and the wire bytes of each ``c10d``
    op (in-place and functional forms), from its tensors' bytes and its
    group's size, by ``wire_bytes``;
  * peak live bytes: the storages the step allocates (not its
    arguments), each held until it is freed.

It counts the same on ``meta``, CPU and CUDA tensors. An autograd
backward is counted through the same mode. A tensor subclass (a DTensor)
is passed on to its own dispatch, whose ops on the local shards the
counter then sees.

No ``scan_corrections``: XLA counts a ``While`` body once, so the
reference adds the trip counts of its scans (chunked attention, the xLSTM
time loop) by formula and extrapolates depth from two probes. The port
dispatches every op of every layer and every kernel call, so the count
of the full-depth step is direct.

Hardware constants: NVIDIA H100 SXM 80 GB, published peaks, dense, at
the 700 W limit.
"""
from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense (the
# sparsity figures halved): BF16 989.4 TFLOP/s, TF32 494.7 TFLOP/s, FP32
# (SIMT, no tensor cores) 66.9 TFLOP/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
TF32_FLOPS = 495e12
# the same data sheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12
# NVLink 4 inside one 8-card HGX H100 host: 900 GB/s a card, both ways
# together, so 450e9 each way
NVLINK_BW = 450e9
# a group that spans hosts: DGX H100 gives each card one ConnectX-7 port
# of 400 Gb/s, 50e9 bytes a second each way
NET_BW = 50e9
#: cards of one host joined by NVLink
HOST_CARDS = 8

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes per device of one collective over a group of ``n`` (the
    reference's per-kind formulas, ``parse_collectives``): all-gather
    result·(N−1)/N, reduce-scatter operand·(N−1)/N, all-reduce (ring)
    2·operand·(N−1)/N, all-to-all operand·(N−1)/N, permute operand.
    ``nbytes`` is the result for an all-gather, the operand otherwise."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * frac
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


#: ops that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "uniform_", "normal_",
               "random_", "bernoulli_", "exponential_"}
#: ops that read only the rows they return (a gather) or write only the
#: rows they are given (a scatter)
_GATHER = {"index", "embedding", "index_select", "gather", "take"}
_SCATTER = {"index_put_", "index_put", "_index_put_impl_", "index_copy_",
            "index_copy", "scatter_", "scatter", "index_add_",
            "index_add", "scatter_add_", "scatter_add", "masked_scatter_"}
#: ops with a scratch operand whose size depends on the device (CUDA
#: leaves log_sigmoid's buffer empty, the CPU and meta fill it): op ->
#: ("out" or "in", the operand's index), left out of the op's bytes
_DEVICE_SCRATCH = {"log_sigmoid_forward": ("out", 1),
                   "log_sigmoid_backward": ("in", 2)}
#: allocations: no byte moves
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}

# c10d op name -> (kind, the argument whose tensors give its bytes: an
# all-gather's outputs (its result), every other kind's operand)
_C10D = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0), "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("collective-permute", 0), "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_coalesced":
               "all-reduce", "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast":
               "collective-permute"}


def _process_group(args):
    import torch.distributed as dist
    for a in tree_leaves(args):
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in a._type().qualified_name():
            return dist.ProcessGroup.unbox(a)
    return None


def _spans_hosts(pg) -> bool:
    """Whether ``pg``'s ranks lie on more than one ``HOST_CARDS``-card
    host (global ranks packed host by host)."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(pg)
    return len({r // HOST_CARDS for r in ranks}) > 1


@dataclass
class Counts:
    """One step's totals on one device."""
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    #: wire bytes over NVLink (a group inside one host) and over the
    #: network (a group that spans hosts)
    nvlink_bytes: float = 0.0
    network_bytes: float = 0.0
    peak_live_bytes: int = 0
    aten_ops: int = 0

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())

    @property
    def collective_wire_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return dict(flops=self.flops, flops_by_dtype=dict(self.flops_by_dtype),
                    hbm_bytes=self.hbm_bytes,
                    kernels={k: dict(v) for k, v in self.kernels.items()},
                    collective_counts=dict(self.collective_counts),
                    collective_bytes=dict(self.collective_bytes),
                    nvlink_bytes=self.nvlink_bytes,
                    network_bytes=self.network_bytes,
                    peak_live_bytes=self.peak_live_bytes,
                    aten_ops=self.aten_ops)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class StepCounter(TorchDispatchMode):
    """Counts the work of the ops dispatched under it (module docstring):
    ``with StepCounter() as c: step(...)``, then ``c.counts``. The kernel
    wrappers report to the innermost active counter. ``log`` also keeps
    ``c.ops``: how many times each (op, FLOPs, bytes) was counted, to
    tell two counts apart."""

    def __init__(self, log: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.counts = Counts()
        self.ops = collections.Counter() if log else None
        self._paused = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0

    # ---- entry -------------------------------------------------------------
    def __enter__(self):
        from repro_torch import kernels
        kernels._COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch import kernels
        kernels._COUNTERS.remove(self)
        return super().__exit__(*exc)

    # ---- the kernel wrappers' side ---------------------------------------
    def add_kernel(self, name: str, flops: float, nbytes: float,
                   dtype) -> None:
        k = self.counts.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self._add_flops(dtype, flops)
        self.counts.hbm_bytes += nbytes

    def paused(self):
        counter = self

        class _Pause:
            def __enter__(self):
                counter._paused += 1

            def __exit__(self, *exc):
                counter._paused -= 1
        return _Pause()

    def track(self, out) -> None:
        """Hold the storages of ``out`` (a wrapper's outputs) as live."""
        for t in _tensors(out):
            self._hold(t)

    # ---- counting ----------------------------------------------------------
    def _add_flops(self, dtype, flops: float) -> None:
        if flops:
            key = _dtype_name(dtype)
            self.counts.flops_by_dtype[key] = \
                self.counts.flops_by_dtype.get(key, 0.0) + float(flops)

    def _hold(self, t: torch.Tensor) -> None:
        # a storage's Python object lives exactly as long as the storage
        # (PyTorch preserves it), so a finalizer on it marks the free
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._release, key)
        if self._live_bytes > self.counts.peak_live_bytes:
            self.counts.peak_live_bytes = self._live_bytes

    def _release(self, key: int) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self._live_bytes -= n

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._opname
        if func.namespace == "c10d":
            if name not in _C10D:
                return
            kind, which = _C10D[name]
            pg = _process_group(args)
            n = pg.size()
            nbytes = sum(_nbytes(t) for t in _tensors(args[which]))
        else:
            if name not in _FUNCTIONAL:
                return
            import torch.distributed.distributed_c10d as c10d
            kind = _FUNCTIONAL[name]
            group_name = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            pg = c10d._resolve_process_group(group_name)
            n = pg.size()
            src = out if kind == "all-gather" else args[0]
            nbytes = sum(_nbytes(t) for t in _tensors(src))
        wire = wire_bytes(kind, nbytes, n)
        c = self.counts
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + wire
        if n > 1 and _spans_hosts(pg):
            c.network_bytes += wire
        else:
            c.nvlink_bytes += wire

    def _op_bytes(self, func, args, kwargs, out) -> float:
        name = func._opname
        if name in _ALLOC:
            return 0.0
        schema = func._schema
        outs = _tensors(out)
        # a view (output aliasing an input, not written): no bytes move
        if schema.returns and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in schema.returns):
            return 0.0
        ins = _tensors((args, kwargs))
        if name in _DEVICE_SCRATCH:
            side, i = _DEVICE_SCRATCH[name]
            if side == "out":
                outs = outs[:i] + outs[i + 1:]
            else:
                ins = ins[:i] + ins[i + 1:]
        if name in _GATHER:
            index = sum(_nbytes(t) for t in ins[1:]
                        if not t.is_floating_point())
            return 2.0 * sum(_nbytes(t) for t in outs) + index
        if name in _SCATTER:
            rest = ins[1:]
            return float(sum(_nbytes(t) for t in rest)
                         + sum(_nbytes(t) for t in rest
                               if t.is_floating_point()))
        if name in _WRITE_ONLY:
            ins = ins[1:]
        return float(sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        if any(issubclass(t, FakeTensor) for t in types):
            # a subclass's own shape propagation, not work
            return func(*args, **kwargs)
        if any(t is not torch.Tensor and not issubclass(t, torch.nn.Parameter)
               for t in types):
            return NotImplemented       # the subclass dispatches its shards
        out = func(*args, **kwargs)
        if self._paused:
            return out
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, kwargs, out)
            return out
        c = self.counts
        c.aten_ops += 1
        packet = func._overloadpacket
        fl = 0
        if packet in self._flop_registry:
            fl = self._flop_registry[packet](*args, **kwargs, out_val=out)
            floats = [t for t in _tensors(args) if t.is_floating_point()]
            self._add_flops(floats[0].dtype if floats else torch.float32, fl)
        nbytes = self._op_bytes(func, args, kwargs, out)
        c.hbm_bytes += nbytes
        if self.ops is not None:
            self.ops[(str(func), fl, nbytes)] += 1
        schema = func._schema
        for r, t in zip(schema.returns, out if isinstance(out, (tuple, list))
                        else (out,)):
            if isinstance(t, torch.Tensor) and r.alias_info is None:
                self._hold(t)
        return out


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    name: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6*N*D (active params) global
    useful_ratio: float          # MODEL_FLOPS / (FLOPs * chips)
    counts: Optional[Counts] = None
    peak_memory_bytes: float = 0.0

    @property
    def bound_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_row(self) -> dict:
        return dict(name=self.name,
                    compute_ms=self.compute_s * 1e3,
                    memory_ms=self.memory_s * 1e3,
                    collective_ms=self.collective_s * 1e3,
                    dominant=self.dominant,
                    useful_ratio=self.useful_ratio,
                    peak_mem_gb=self.peak_memory_bytes / 1e9)


def compute_seconds(counts: Counts, peak_flops=None) -> float:
    """Each dtype's FLOPs over its peak: f32 at the SIMT rate, or at the
    TF32 tensor-core rate while ``torch.backends.cuda.matmul.allow_tf32``
    is on (the counted f32 FLOPs are matmuls)."""
    peaks = {_dtype_name(k): v for k, v in (peak_flops or PEAK_FLOPS).items()}
    if torch.backends.cuda.matmul.allow_tf32:
        peaks["float32"] = TF32_FLOPS
    return sum(f / peaks.get(dt, peaks["bfloat16"])
               for dt, f in counts.flops_by_dtype.items())


def collective_seconds(counts: Counts, nvlink_bw: float = NVLINK_BW,
                       net_bw: float = NET_BW) -> float:
    return counts.nvlink_bytes / nvlink_bw + counts.network_bytes / net_bw


def analyze(name: str, counts: Counts, model_flops_global: float, chips: int,
            peak_flops=None, hbm_bw: float = HBM_BW,
            nvlink_bw: float = NVLINK_BW, net_bw: float = NET_BW) -> Roofline:
    """The roofline of one device's ``counts`` (a ``StepCounter``'s), in
    place of the reference's compiled artifact; its peak memory is the
    step's peak live bytes (the arguments not among them)."""
    flops = counts.flops
    compute_s = compute_seconds(counts, peak_flops)
    memory_s = counts.hbm_bytes / hbm_bw
    coll_s = collective_seconds(counts, nvlink_bw, net_bw)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    useful = model_flops_global / max(flops * chips, 1.0)
    return Roofline(name=name, flops_per_device=flops,
                    bytes_per_device=counts.hbm_bytes,
                    collective_bytes=counts.collective_wire_bytes,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dominant,
                    model_flops=model_flops_global, useful_ratio=useful,
                    counts=counts, peak_memory_bytes=counts.peak_live_bytes)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 * N_active * D tokens (training: *3 for fwd+bwd...
    we follow the assignment: 6*N*D counts fwd+bwd; for inference steps we
    use 2*N*D forward-only)."""
    n_active = cfg.active_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
