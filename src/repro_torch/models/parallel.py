"""Tensor parallelism over the model axis for the sharded prefill and
decode steps (``launch.steps.build`` with a mesh): what GSPMD derives
from the reference's partition specs, written out by hand.

Each rank holds its shards of the parameters by
``sharding.partition.params_pspecs`` (anything FSDP splits over the data
axes is gathered before the step, ``launch.steps.local_params``) and
computes its own share:

  * a column-parallel projection gives the rank its columns; where the
    next op needs columns the rank does not hold (attention heads that do
    not divide the axis, the RG-LRU gates' whole input) they are
    ``all_gather``-ed, activations and never weights;
  * a row-parallel projection (``wo``, ``down``, ``out``) takes the
    rank's slice of its input and its product is summed over the axis
    (``all_reduce``);
  * the vocab-split embedding looks up the rank's rows and sums; the
    vocab-split readout gathers the logits;
  * the residual stream is whole on every rank of the model axis, as the
    reference's is replicated over it; MoE layers run the DEP walk.

A parameter the specs leave whole (its dims do not divide the axis) is
used whole, with no collective. ``TensorParallel`` is a frozen part of
the model's ``ExecutionContext``: the model-axis group, its size, this
rank's place on it, and whether the attention caches of the step are
split along the sequence (``seq_cache``: the KV heads do not divide the
axis and the capacity does, ``sharding.partition.cache_pspecs``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import dense_apply


@dataclass(frozen=True)
class TensorParallel:
    group: Any
    size: int
    rank: int
    seq_cache: bool = False

    @classmethod
    def from_mesh(cls, mesh, seq_cache: bool = False,
                  model_axis: str = "model") -> "TensorParallel":
        dim = tuple(mesh.mesh_dim_names).index(model_axis)
        return cls(group=mesh.get_group(dim), size=mesh.size(dim),
                   rank=mesh.get_coordinate()[dim], seq_cache=seq_cache)

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of ``n`` split evenly over the axis."""
        w = n // self.size
        return self.rank * w, (self.rank + 1) * w

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        """``x`` (fresh: overwritten) reduced over the model axis."""
        if self.size == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank
        order."""
        if self.size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=-1)


def take_columns(p, x, n: int, lo: int, hi: int,
                 tp: TensorParallel) -> torch.Tensor:
    """Columns [lo, hi) of ``dense_apply(p, x)`` whose whole width is
    ``n``: the rank's own when its column block holds them, else gathered
    from every rank's block."""
    y = dense_apply(p, x)
    cols = y.shape[-1]
    if cols == n:
        return y[..., lo:hi]
    a = tp.rank * cols
    if a <= lo and hi <= a + cols:
        return y[..., lo - a:hi - a]
    return tp.gather_last(y)[..., lo:hi]


def row_parallel(p, x, full_in: int, tp: TensorParallel) -> torch.Tensor:
    """``dense_apply(p, x)`` of a row-parallel projection (no bias): ``x``
    holds the whole input or exactly the rank's rows; a split projection
    takes the rank's slice of a whole input and sums over the axis."""
    rows = p["kernel"].shape[0]
    if rows == full_in:
        return dense_apply(p, x)
    if x.shape[-1] == full_in:
        lo, hi = tp.block(full_in)
        x = x[..., lo:hi]
    return tp.all_reduce(dense_apply(p, x))


def mlp_apply(p, x, ffn_dim: int, tp: TensorParallel) -> torch.Tensor:
    """The SwiGLU MLP with column-parallel gate/up and row-parallel down:
    the rank's slice of the hidden units, summed over the axis."""
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    return row_parallel(p["down"], F.silu(g) * u, ffn_dim, tp)


def embed(p, tokens, vocab: int, dtype, tp: TensorParallel):
    """The vocab-split lookup: the rank's rows of the table (ids outside
    them give zeros), summed over the axis (one non-zero term a token, so
    the sum is exact)."""
    table = p["embedding"]
    if table.shape[0] == vocab:
        return table[tokens.long()].to(dtype)
    lo, hi = tp.block(vocab)
    ids = tokens.long() - lo
    hit = (ids >= 0) & (ids < hi - lo)
    rows = table[ids.clamp(0, hi - lo - 1)].to(dtype)
    return tp.all_reduce(torch.where(hit[..., None], rows,
                                     torch.zeros_like(rows)))


def readout(params, x, vocab: int, tied: bool, tp: TensorParallel):
    """Logits in float32 from the vocab-split readout (``lm_head``'s
    columns, or the tied embedding's rows), gathered over the axis."""
    if tied:
        w = params["embed"]["embedding"]
        logits = x.float() @ w.float().T
    else:
        logits = x.float() @ params["lm_head"]["kernel"].float()
    if logits.shape[-1] == vocab:
        return logits
    return tp.gather_last(logits)


def dense_gathered(p, x, n: int, tp: TensorParallel) -> torch.Tensor:
    """A column-parallel projection's whole output (width ``n``)."""
    return take_columns(p, x, n, 0, n, tp)


__all__ = ["TensorParallel", "dense_gathered", "embed", "mlp_apply",
           "readout", "row_parallel", "take_columns"]
