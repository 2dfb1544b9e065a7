"""Parameter, batch and cache partition rules per architecture family
(a copy of ``repro.sharding.partition``'s spec logic), and their
counterparts as ``torch.distributed.tensor`` placements on a
``DeviceMesh``.

The rules are name-based over the parameter tree's key paths, which the
port's tree shares with the reference's (``layers.[i].attn.wq.kernel``):

  dense / moe / vlm / audio (attention stacks):
    column-parallel (shard output dim over "model"): wq wk wv w_ukv gate up
        ffn_up w_gates w_if skip lm_head proj
    row-parallel   (shard input dim over "model"):  wo down out ffn_down
    expert-parallel (shard expert dim):             experts.{gate,up,down}
    vocab-sharded:                                  embed.embedding
    replicated: norms, biases of row-parallel, router, small MLA latents
  ssm (xLSTM): weights replicated, batch data-parallel.
  hybrid (RG-LRU): column-parallel in-projections, sharded state,
    row-parallel out.

A spec (``PSpec``) has one entry per tensor dimension: an axis name, a
tuple of axis names, or None, as a ``jax.sharding.PartitionSpec`` has
(a one-name tuple reads as the name). A mesh is anything with the axis
sizes: a ``DeviceMesh`` (``mesh_dim_names`` and ``shape``), or an object
whose ``shape`` maps axis names to sizes, as the reference's meshes do.
``placements`` turns a spec into one ``Shard(d)`` / ``Replicate()`` per
mesh dimension; ``distribute_params`` lays a whole parameter tree out as
DTensors by its placements.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training.tree import (tree_leaves, tree_paths,
                                       tree_unflatten)

COL = ("wq", "wk", "wv", "w_ukv", "gate", "up", "ffn_up", "w_gates",
       "w_if", "skip", "lm_head", "proj", "in_x", "in_gate", "w_a", "w_i")
ROW = ("wo", "down", "out", "ffn_down")
# "shared" experts replicate: in DEP they belong to the (data-parallel) AG
REPL = ("w_dkv", "w_kpe", "router", "r_gates", "conv", "shared")


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 1:
            return entry[0]
        return entry or None
    return entry


class PSpec(tuple):
    """The port's ``PartitionSpec``: a tuple of per-dimension entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canon(e) for e in entries))

    def __repr__(self):
        return "PSpec(" + ", ".join(map(repr, self)) + ")"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                        # a torch DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _spec_for(names: Tuple[str, ...], leaf, cfg: ModelConfig,
              model_axis: str) -> PSpec:
    nd = leaf.ndim
    joined = set(names)

    def pad_left(spec_tail):
        """Left-pad with None for any stacking/extra leading dims."""
        pad = nd - len(spec_tail)
        return PSpec(*([None] * pad + list(spec_tail)))

    if "embedding" in joined:
        return pad_left([model_axis, None])
    # SSM family: replicate everything but the embedding/readout
    if cfg.family == "ssm":
        if any(n in joined for n in ("lm_head",)):
            return pad_left([None, model_axis])
        return PSpec(*([None] * nd))
    if "experts" in joined:
        return pad_left([model_axis, None, None])
    for n in names:
        if n in REPL:
            return PSpec(*([None] * nd))
    for n in names:
        if n in ROW and nd >= 2:
            return pad_left([model_axis, None])
    for n in names:
        if n in COL:
            if nd >= 2:
                return pad_left([None, model_axis])
            return pad_left([model_axis])           # col-parallel bias
    return PSpec(*([None] * nd))


def sanitize_spec(spec: PSpec, shape, mesh) -> PSpec:
    """Drop axis assignments whose mesh extent does not divide the dim —
    jit in_shardings require exact divisibility (no GSPMD padding)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        out.append(entry if dim % prod == 0 else None)
    return PSpec(*out)


FSDP_THRESHOLD_ELEMS = 8 * 1024 * 1024    # shard-further above 16MB bf16


def apply_fsdp(spec: PSpec, shape, mesh, fsdp_axis: str = "data",
               threshold_elems: int = FSDP_THRESHOLD_ELEMS) -> PSpec:
    """ZeRO-3-style 2D weight sharding: when a parameter is still larger
    than FSDP_THRESHOLD_ELEMS per device after tensor sharding, shard its
    largest unsharded dim over the data axis too (gathered just before
    use). Intra-pod only — never over "pod"."""
    if mesh is None or fsdp_axis not in _axis_names(mesh) or len(shape) < 2:
        return spec
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    shards = 1
    for e in entries:
        if e is None:
            continue
        for a in ((e,) if isinstance(e, str) else e):
            shards *= sizes[a]
    elems = 1
    for d in shape:
        elems *= d
    if elems // shards <= threshold_elems:
        return spec
    df = sizes[fsdp_axis]
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[dim] is None and shape[dim] % df == 0:
            entries[dim] = fsdp_axis
            return PSpec(*entries)
    return spec


# Never FSDP the readout/embedding: sharding their contracting dim makes
# the partitioner gather the [tokens, vocab] logits instead of the (small)
# weight.
FSDP_EXCLUDE = ("embedding", "lm_head")


def params_pspecs(params, cfg: ModelConfig, model_axis: str = "model",
                  mesh=None, fsdp: bool = True,
                  fsdp_threshold_elems: int = FSDP_THRESHOLD_ELEMS):
    """A ``PSpec`` tree matching ``params`` (tensors, meta tensors, or
    anything with ``ndim`` and ``shape``)."""
    def one(names, leaf):
        spec = _spec_for(names, leaf, cfg, model_axis)
        spec = sanitize_spec(spec, leaf.shape, mesh)
        if fsdp and not any(n in FSDP_EXCLUDE for n in names):
            spec = apply_fsdp(spec, leaf.shape, mesh,
                              threshold_elems=fsdp_threshold_elems)
        return spec
    return tree_unflatten(params, [one(names, x)
                                   for names, x in tree_paths(params)])


def params_shardings(params, cfg: ModelConfig, mesh,
                     model_axis: str = "model"):
    """The DTensor layout of ``params`` on ``mesh`` (a ``DeviceMesh``, or
    anything with the axis sizes): each leaf's ``placements`` of its
    ``params_pspecs`` spec — the counterpart of the reference's tree of
    ``NamedSharding``s."""
    return tree_placements(params_pspecs(params, cfg, model_axis, mesh),
                           mesh)


def batch_pspec(global_batch: int, mesh,
                exclude: Tuple[str, ...] = ("model",)) -> PSpec:
    """Shard the batch dim over as many data axes as divide it."""
    sizes = axis_sizes(mesh)
    axes = []
    prod = 1
    for a in sizes:
        if a in exclude:
            continue
        if global_batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return PSpec(tuple(axes) or None)


def batch_axes(spec: PSpec) -> Tuple[str, ...]:
    """The axes a ``batch_pspec`` shards the batch over (none for
    ``PSpec(None)``)."""
    entry = spec[0] if len(spec) else None
    return (entry,) if isinstance(entry, str) else (entry or ())


def cache_pspecs(cache, cfg: ModelConfig, mesh, global_batch: int,
                 model_axis: str = "model", stacked: bool = False):
    """KV caches: batch over data axes, kv-heads over model (else the
    sequence when it divides); SSM states: batch over data axes, width
    over model for RG-LRU. ``stacked`` marks caches with a leading
    layer-group dimension (left-padded with None)."""
    bspec = batch_pspec(global_batch, mesh)
    b_axes = bspec[0] if bspec != PSpec(None) else None
    lead = [None] if stacked else []
    mo = axis_sizes(mesh)[model_axis]

    def spec(names, leaf):
        nd = leaf.ndim - (1 if stacked else 0)
        if nd <= 0:                         # cache index scalar
            return PSpec(*lead) if stacked else PSpec()
        if any(n in ("k", "v") for n in names) and nd == 4:
            C, kv = leaf.shape[-3], leaf.shape[-2]
            if kv % mo == 0:    # kv-head sharding when it divides
                return PSpec(*lead, b_axes, None, model_axis, None)
            if C % mo == 0:     # else sequence-sharded
                return PSpec(*lead, b_axes, model_axis, None, None)
            return PSpec(*lead, b_axes, None, None, None)
        if any(n in ("ckv", "kpe") for n in names) and nd == 3:
            return PSpec(*lead, b_axes, None, None)
        if "h" in names and nd == 2 and cfg.family == "hybrid":
            return PSpec(*lead, b_axes, model_axis)
        # ssm states / conv states: batch-sharded only
        return PSpec(*(lead + [b_axes] + [None] * (nd - 1)))

    return tree_unflatten(cache, [spec(names, x)
                                  for names, x in tree_paths(cache)])


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: PSpec, mesh) -> tuple:
    """One placement per mesh dimension: ``Shard(d)`` where tensor dim
    ``d``'s entry names that mesh axis, else ``Replicate()``. A tuple
    entry must name its axes in mesh order (the major axis first, as
    ``Shard`` nests them)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_placements(specs, mesh):
    """``placements`` of every spec of a ``PSpec`` tree, in its
    structure."""
    return tree_unflatten(specs, [placements(s, mesh)
                                  for s in tree_leaves(specs, PSpec)],
                          PSpec)


def distribute_params(params, pls, mesh):
    """Lay a whole parameter tree out as DTensors on ``mesh`` (a
    ``DeviceMesh``) by ``pls``, the tree of each leaf's placements
    (``tree_placements`` of its specs; a sharded ``StepBundle``'s
    ``placements[0]``): every rank passes the same full tree and keeps
    its shard of each leaf (a copy; the full tensors may be dropped
    afterwards)."""
    from torch.distributed.tensor import DTensor
    out = []
    for x, pl in zip(tree_leaves(params), tree_leaves(pls, tuple)):
        out.append(DTensor.from_local(local_shard(x, pl, mesh), mesh, pl,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride()))
    return tree_unflatten(params, out)


def local_shape(shape, spec: PSpec, mesh) -> Tuple[int, ...]:
    """The shape of one shard of a ``shape`` tensor laid out by ``spec``
    on ``mesh`` (anything with the axis sizes): each dim over the product
    of the axes its entry names."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[d] //= sizes[a]
    return tuple(out)


def local_shard(x: torch.Tensor, pl, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``pl`` (even
    division, which ``sanitize_spec`` guarantees): mesh dimensions in
    order, each a chunk of the previous one's."""
    from torch.distributed.tensor import Shard
    local = x
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does "
                                 f"not divide over {n}")
            local = local.chunk(n, dim=p.dim)[coord[i]]
    return local.contiguous().clone()


# ---------------------------------------------------------------------------
# the sharded train step's gather
# ---------------------------------------------------------------------------

class _GatherShards(torch.autograd.Function):
    """A rank's shard -> the tensor its placements lay out, gathered over
    every mesh dimension but ``keep``; the backward sums the gradient
    over each of those dimensions (the same rank groups) and keeps the
    rank's shard, so each rank's leaf gradient is the sum over the mesh
    of the ranks' gradients of the gathered tensor. Only ``all_gather``
    and ``all_reduce``: both run on gloo (CPU and CUDA tensors) and
    NCCL."""

    @staticmethod
    def forward(ctx, local, mesh, pl, keep):
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        ctx.mesh, ctx.pl, ctx.keep = mesh, pl, keep
        x = local
        for i in reversed(range(len(pl))):
            if i == keep or not isinstance(pl[i], Shard) \
                    or mesh.size(i) == 1:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(mesh.size(i))]
            dist.all_gather(parts, x, group=mesh.get_group(i))
            x = torch.cat(parts, dim=pl[i].dim)
        return x if x is not local else local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        mesh, pl, keep = ctx.mesh, ctx.pl, ctx.keep
        coord = mesh.get_coordinate()
        g = grad
        for i in range(len(pl)):
            if i == keep or mesh.size(i) == 1:
                continue
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.get_group(i))
            if isinstance(pl[i], Shard):
                g = g.chunk(mesh.size(i), dim=pl[i].dim)[coord[i]]
        return g, None, None, None


def gather_shards(local: torch.Tensor, mesh, pl, keep: Optional[int] = None
                  ) -> torch.Tensor:
    """The whole tensor of the shard ``local`` laid out by ``pl`` on
    ``mesh``, as a differentiable op (``_GatherShards``); ``keep`` is a
    mesh dimension not gathered (an expert leaf's model axis: each rank
    runs its own experts)."""
    return _GatherShards.apply(local, mesh, tuple(pl), keep)


__all__ = ["COL", "ROW", "REPL", "FSDP_EXCLUDE", "FSDP_THRESHOLD_ELEMS",
           "PSpec", "apply_fsdp", "axis_sizes", "batch_axes", "batch_pspec",
           "cache_pspecs", "distribute_params", "gather_shards",
           "local_shape", "local_shard", "params_pspecs", "params_shardings",
           "placements", "sanitize_spec", "tree_placements"]
