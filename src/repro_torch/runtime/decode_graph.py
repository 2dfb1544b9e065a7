"""The engine's decode step, run eagerly or replayed as a CUDA graph: the
port's counterpart of the reference's jitted decode
(``self._decode_jit = jax.jit(self._decode_step, static_argnames=...)``,
``repro/runtime/engine.py:339``).

``decode_step`` is the step: ``Model.decode_step`` over every slot, the
commit of the new states into the KV manager's own tensors, sampling, and
the next tokens written back into the token buffer. It reads its inputs
from static buffers and rebinds nothing, so every address it touches
stays fixed and a CUDA graph captures it as it is. The engine runs the
same function eagerly when the graph is off and on the CPU, so the CPU
tests cover what the card captures.

``DecodeGraphs`` keeps one captured graph per ``GraphKey``: the sampling
variant and, under DEP, the ``ExecProgram`` the MoE layers walk, the
expert placement and the dispatch capacity scale, so plans that lower to
the same program share a graph and the captures are bounded by the
distinct programs; and whether the step returns the MoE layers' routing
statistics, as outputs of the step at fixed addresses, which the engine
reads after the step's token readback. The engine warms the graphs up once, before any
cache is live: the step runs eagerly on caches it then drops, for the
keys it can name up front, which loads the kernel library and makes the
libraries' handles and workspaces and the DEP communicator, comm stream
and events. Every key, those first seen mid-serve included, is then
captured at its first use with no eager run: a capture records the step
and runs nothing, so it touches no live state. A replay does not pass
through the kernels' Python wrappers, so it adds the launches its capture
made to their counts (``kernels.add_launch_counts``); the warm-up and
capture calls themselves are taken back out of the counts.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from functools import partial
from typing import (Any, Callable, Dict, Iterable, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch import kernels
from repro_torch.runtime.sampler import sample


class GraphKey(NamedTuple):
    """The static key of one captured decode step, laid out like the
    reference's ``static_argnames`` ("plan", "use_topk", "placement",
    "cap_scale", "collect_stats"): ``plan`` is the DEP ``ExecProgram``
    (hashable; None when DEP is off); ``placement`` the engine's
    ``core.dep.DevicePlacement`` (compared by identity, so a graph holds
    the tensors it was captured on; None without one); ``cap_scale`` the
    DEP dispatch capacity scale; ``collect_stats`` whether the step also
    returns the stacked MoE statistics. The defaults capture the step of
    an engine that tracks no expert load."""

    use_topk: bool
    plan: Optional[Any] = None
    placement: Optional[Any] = None
    cap_scale: float = 1.0
    collect_stats: bool = False


class StagedBuffer:
    """A device tensor at a fixed address, filled from a host mirror that
    is pinned on a CUDA device, so that the copy does not wait. The next
    ``load`` waits for the previous copy before it rewrites the mirror."""

    def __init__(self, shape, dtype, device: torch.device):
        cuda = device.type == "cuda"
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        self._host = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        self._host_np = self._host.numpy()
        self._copied = torch.cuda.Event() if cuda else None

    def load(self, values) -> torch.Tensor:
        """Copy ``values`` (a list, an array or a CPU tensor of the
        buffer's shape) into the device tensor, which it returns."""
        if isinstance(values, torch.Tensor):
            values = values.numpy()
        if self._copied is not None:
            self._copied.synchronize()
        self._host_np[...] = values
        self.tensor.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.tensor


def commit_states(caches, new_caches) -> None:
    """End a step in the KV manager's own tensors: copy each tensor the
    step returned anew (attention indices, sLSTM and RG-LRU states, conv
    tails, the mLSTM n and m) into the one it replaces. K/V rows and the
    mLSTM matrix state C are written in place, so they are the same
    tensors and are not copied."""
    for old, new in zip(caches, new_caches):
        for name, t in old.items():
            if new[name] is not t:
                t.copy_(new[name])


def decode_step(model, params, caches, tokens, lengths, table, temps,
                top_ks, generator, key: GraphKey):
    """One engine decode step over every slot. ``tokens`` ([N, 1] int64),
    ``lengths`` ([N] int32), ``table`` (int32 [N, max_blocks] under paged
    KV, else None), ``temps`` and ``top_ks`` are the engine's static
    buffers; ``key`` the step's static arguments. The step reads no value
    on the host and ends with the states in ``caches``' own tensors and
    the sampled tokens in ``tokens``. Returns (next tokens int64 [N],
    logits [N, 1, V]), and with ``key.collect_stats`` also the MoE
    layers' statistics packed for one host copy (``MoEStats.packed``:
    float32 [L_moe * E + 1])."""
    logits, new_caches, *stats = model.decode_step(
        params, tokens, caches, lengths=lengths, block_tables=table,
        plan=key.plan, placement=key.placement, capacity_scale=key.cap_scale,
        return_moe_stats=key.collect_stats)
    commit_states(caches, new_caches)
    nxt = sample(generator, logits[:, -1], temps,
                 top_ks if key.use_topk else 0)
    tokens.copy_(nxt[:, None])
    if stats:
        return nxt, logits, stats[0].packed()
    return nxt, logits


def bind_step(model, params, kv, tokens, lengths, temps, top_ks,
              generator, paged: bool) -> Callable[[GraphKey], Tuple]:
    """``decode_step`` bound to one engine's model, KV manager and static
    buffers, as a function of the key: what a graph captures and what the
    eager path runs. It holds no reference to the engine, so an engine
    with graphs is freed as soon as it is dropped (through a reference
    cycle its weights and caches would stay on the card until the garbage
    collector ran)."""
    def step(key: GraphKey):
        table = kv.table_array() if paged else None
        return decode_step(model, params, kv.caches, tokens, lengths, table,
                           temps, top_ks, generator, key)
    return step


#: the decode graphs' capture stream of each device, shared by every
#: engine as ``torch.cuda.graph`` shares its default capture stream: each
#: stream that runs cuBLAS holds a 32 MiB workspace for the life of the
#: process, so a stream per engine would leak that much per engine
_CAPTURE_STREAMS: Dict[torch.device,
                       Tuple[torch.cuda.Stream, threading.Lock]] = {}


def capture_stream(
        device: torch.device) -> Tuple[torch.cuda.Stream, threading.Lock]:
    """The capture stream of ``device`` and the lock that every engine's
    work on it (warm-ups, captures) holds: a capture records whatever runs
    on its stream, so two engines capturing from two threads at once
    would record into each other's graphs."""
    entry = _CAPTURE_STREAMS.get(device)
    if entry is None:
        entry = _CAPTURE_STREAMS[device] = (torch.cuda.Stream(device),
                                            threading.Lock())
    return entry


class CudaGraph:
    """One CUDA graph of an engine's decode step. An engine's graphs share
    one memory pool and one capture stream, and the sampling generator is
    registered with each, so that a replay draws as the eager step
    would."""

    def __init__(self, pool, stream: torch.cuda.Stream,
                 generator: torch.Generator):
        self._graph = torch.cuda.CUDAGraph()
        self._pool = pool
        self._stream = stream
        self._generator = generator

    def capture(self, fn: Callable[[], Any]) -> Any:
        self._graph.register_generator_state(self._generator)
        with torch.cuda.graph(self._graph, pool=self._pool,
                              stream=self._stream):
            out = fn()
        return out

    def replay(self) -> None:
        self._graph.replay()


class _Captured(NamedTuple):
    graph: Any
    outputs: Tuple
    launches: Dict[str, int]     # kernel launches of one replay


@contextmanager
def _uncounted():
    """Take the kernel launches made in the block back out of the
    wrappers' counts; the dict it yields holds them after the block."""
    before = kernels.launch_counts()
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        after = kernels.launch_counts()
        made.update({name: after[name] - before[name] for name in after})
        kernels.add_launch_counts({name: -n for name, n in made.items()})


class DecodeGraphs:
    """The captured decode steps of one engine, one per key. ``step(key)``
    runs the step and returns its outputs; ``new_graph()`` makes an object
    with ``capture(fn)`` (records ``fn`` and returns its outputs) and
    ``replay()``: ``CudaGraph`` on the card. ``stream`` is the capture
    stream, where the warm-up runs too, and ``lock`` the lock held while
    either runs (``capture_stream``'s). ``stats`` (the engine's
    ``EngineStats``) counts captures, replays and their set-up time.

    A key is captured at its first call and replayed from then on, that
    call included. A capture that fails raises: there is no eager retry.
    """

    def __init__(self, step: Callable[[GraphKey], Tuple],
                 new_graph: Callable[[], Any], stats,
                 stream: torch.cuda.Stream = None,
                 lock: Optional[threading.Lock] = None):
        self._step = step
        self._new_graph = new_graph
        self._stream = stream
        self._lock = lock if lock is not None else nullcontext()
        self.stats = stats
        self.graphs: Dict[GraphKey, _Captured] = {}

    @contextmanager
    def _on_capture_stream(self):
        if self._stream is None:
            yield
            return
        current = torch.cuda.current_stream()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield
        current.wait_stream(self._stream)

    def warm_up(self, keys: Iterable[GraphKey]) -> None:
        """Run each key's step once, eagerly, on the capture stream, as
        PyTorch asks before a capture: the first calls build and load the
        kernel library, create the libraries' handles and workspaces and,
        under DEP, the communicator, the comm stream and its events. The
        launches are not counted. The step changes the state it runs on,
        so the caller runs this on state that it then drops."""
        t0 = time.perf_counter()
        with self._lock, _uncounted(), self._on_capture_stream():
            for key in keys:
                self._step(key)
            self._sync()
        self.stats.graph_s += time.perf_counter() - t0

    def __call__(self, key: GraphKey) -> Tuple:
        captured = self.graphs.get(key)
        if captured is None:
            captured = self._capture(key)
        captured.graph.replay()
        kernels.add_launch_counts(captured.launches)
        self.stats.graph_replays += 1
        return captured.outputs

    def drop(self, keys: Iterable[GraphKey]) -> None:
        """Release the graphs of ``keys``, which no later step meets (an
        older placement's): their memory goes back to the pool."""
        for key in keys:
            del self.graphs[key]

    def _capture(self, key: GraphKey) -> _Captured:
        t0 = time.perf_counter()
        graph = self._new_graph()
        with self._lock:
            with _uncounted() as launches:
                outputs = graph.capture(partial(self._step, key))
            self._sync()
        captured = _Captured(graph, outputs, launches)
        self.graphs[key] = captured
        self.stats.graph_captures += 1
        self.stats.graph_s += time.perf_counter() - t0
        return captured

    def _sync(self) -> None:
        if self._stream is not None:
            torch.cuda.synchronize(self._stream.device)
