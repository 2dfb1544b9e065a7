"""Lock step of the serving engine's ranks on an expert group of several
ranks (one engine process per rank).

The reference serves a mesh from one controller; the port runs one
process per rank, and every collective of a model call must be issued
by every rank in the same order. Whatever a rank decides from its own
clock or measurements (a drift re-solve of a plan, a background
re-placement, a sampled token) could split the ranks. So rank 0 decides
and the other ranks follow a small header that rank 0 broadcasts over
the groups' gloo ``control`` group (host tensors; no device sync):

  * the MoE program of each model call (``ExecProgram``: r1, r2, order,
    m_e, the hot-expert count and placement epoch, the interleave and
    its priority hints, which fix where the SHARED tasks run), the
    prefill chunk and the dispatch capacity scale;
  * on the decode call's header, the calibration field
    (``profiling.refresh.CalibStep``: start a re-calibration's local
    sweeps, run comm sample i of so many bytes, or end the job), so a
    step that runs no sample sends nothing more;
  * the placement to install, if any;
  * the admitted and rejected request ids: every rank runs its own
    scheduler, and a rank whose decision differs from rank 0's raises;
  * the sampled tokens, after the token readback.

A header is a fixed-size int64 vector: its length, then its values; the
values past it (the priority hints of a program of many chunks) follow
in a second broadcast of their own size, which every rank knows from the
length. At world size 1 (``LockStep(None)``) every call returns its
argument and no collective is issued.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.taskgraph import ExecProgram, lower_exec
from repro_torch.placement import Placement

#: int64 values of a header's first broadcast (its length first)
HEADER_INTS = 512
#: values of a decode header's calibration field
CALIB_INTS = 3

_ORDERS = ("ASAS", "AASS")
_INTERLEAVES = ("off", "streams")


def float_bits(x: float) -> int:
    """A float64 as the int64 of its bits (exact both ways)."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def bits_float(v: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(v)))[0]


def encode_program(program: Optional[ExecProgram]) -> List[int]:
    """[0] for no program, else its lowering scalars, interleave and
    hints (-1 for none)."""
    if program is None:
        return [0]
    g = program.graph
    hints = program.hints
    return ([1, g.r1, g.r2, _ORDERS.index(g.order), g.m_e, g.hot_experts,
             g.placement_epoch, _INTERLEAVES.index(program.interleave),
             -1 if hints is None else len(hints)] + list(hints or ()))


def decode_program(v: Sequence[int]) -> Tuple[Optional[ExecProgram],
                                              Sequence[int]]:
    """``encode_program``'s inverse; returns (program, the values after
    it). The graph is lowered as ``Plan.exec_program`` lowers it, so the
    program equals (and hashes as) the one rank 0 encoded."""
    if not v[0]:
        return None, v[1:]
    r1, r2, order, m_e, hot, epoch, il, n = v[1:9]
    hints = None if n < 0 else tuple(v[9:9 + n])
    graph = lower_exec(r2, _ORDERS[order], m_e, hot_experts=hot,
                       placement_epoch=epoch, r1=r1)
    return (ExecProgram(graph, _INTERLEAVES[il], hints),
            v[9 + max(n, 0):])


def encode_placement(pl: Optional[Placement]) -> List[int]:
    if pl is None:
        return [0]
    return ([1, pl.num_experts, pl.num_ranks, pl.epoch, len(pl.replicated)]
            + list(pl.assignment) + list(pl.replicated))


def decode_placement(v: Sequence[int]) -> Optional[Placement]:
    if not v[0]:
        return None
    E, ranks, epoch, n_rep = v[1:5]
    return Placement(num_experts=E, num_ranks=ranks,
                     assignment=tuple(v[5:5 + E]),
                     replicated=tuple(v[5 + E:5 + E + n_rep]), epoch=epoch)


class LockStep:
    """Rank 0's decisions on every rank of ``groups`` (a
    ``core.dep.DepGroups`` with a ``control`` group; None: a group of
    one rank, where nothing is sent). ``size`` is the first broadcast's
    length in int64 values (at least ``HEADER_INTS``; the same on every
    rank); ``headers`` counts the broadcasts."""

    def __init__(self, groups=None, size: int = HEADER_INTS):
        self.group = None if groups is None else groups.control
        self.rank = 0 if self.group is None else dist.get_rank()
        self.size = max(int(size), HEADER_INTS)
        self.headers = 0          # broadcasts issued

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def follow(self, values: Sequence[int]) -> List[int]:
        """Rank 0's ``values`` (the other ranks' are ignored)."""
        values = [int(x) for x in values]
        if self.group is None:
            return values
        room = self.size - 1
        buf = torch.zeros(self.size, dtype=torch.int64)
        if self.lead:
            buf[0] = len(values)
            head = values[:room]
            buf[1:1 + len(head)] = torch.tensor(head, dtype=torch.int64)
        dist.broadcast(buf, src=0, group=self.group)
        self.headers += 1
        n = int(buf[0])
        got = buf[1:1 + min(n, room)].tolist()
        if n > room:
            rest = (torch.tensor(values[room:], dtype=torch.int64)
                    if self.lead else torch.zeros(n - room, dtype=torch.int64))
            dist.broadcast(rest, src=0, group=self.group)
            self.headers += 1
            got += rest.tolist()
        return got

    def agree(self, what: str, values: Sequence[int]) -> List[int]:
        """Rank 0's ``values``, which must equal this rank's: a rank that
        decided otherwise raises rather than follow."""
        got = self.follow(values)
        if got != [int(x) for x in values]:
            raise RuntimeError(
                f"rank {self.rank} left lock step: its {what} {list(values)}"
                f", rank 0's {got}")
        return got

    def follow_object(self, obj):
        """Rank 0's ``obj`` (pickled; for set-up, such as a profile)."""
        if self.group is None:
            return obj
        box = [obj if self.lead else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self.headers += 1
        return box[0]

    def follow_call(self, program: Optional[ExecProgram], chunk: int,
                    cap_scale: float) -> Tuple[Optional[ExecProgram], int,
                                               float]:
        """Rank 0's (program, prefill chunk, capacity scale) of a model
        call."""
        if self.group is None:
            return program, chunk, cap_scale
        v = self.follow([chunk, float_bits(cap_scale)]
                        + encode_program(program))
        got, _ = decode_program(v[2:])
        return got, v[0], bits_float(v[1])

    def follow_decode(self, program: Optional[ExecProgram],
                      cap_scale: float, calib: Sequence[int]
                      ) -> Tuple[Optional[ExecProgram], float,
                                 Tuple[int, ...]]:
        """Rank 0's (program, capacity scale, calibration field) of a
        decode call: ``follow_call``'s header with the ``CALIB_INTS``
        values of ``calib`` ahead of the program, in the one broadcast."""
        calib = tuple(int(x) for x in calib)
        if len(calib) != CALIB_INTS:
            raise ValueError(f"a calibration field of {len(calib)} values, "
                             f"not {CALIB_INTS}")
        if self.group is None:
            return program, cap_scale, calib
        v = self.follow([0, float_bits(cap_scale)] + list(calib)
                        + encode_program(program))
        got, _ = decode_program(v[2 + CALIB_INTS:])
        return got, bits_float(v[1]), tuple(v[2:2 + CALIB_INTS])

    def follow_placement(self, pl: Optional[Placement]
                         ) -> Optional[Placement]:
        """Rank 0's placement to install (None: none)."""
        if self.group is None:
            return pl
        return decode_placement(self.follow(encode_placement(pl)))
