"""Step builders and abstract input specs for every (arch x input shape)
(the counterpart of ``repro.launch.steps``).

  * ``build(cfg, shape, mesh=None)``  -> a ``StepBundle``: the step
    function, its abstract arguments (tensors on the ``meta`` device, the
    counterpart of ``ShapeDtypeStruct``: shapes and dtypes, nothing
    allocated), the model it runs, ``accum_steps`` and, with a mesh, the
    arguments' DTensor placements. There is no ``lower()``: the port's
    steps run eagerly (the serving engine captures its decode step as a
    CUDA graph instead).
  * train shapes give ``make_train_step`` (loss + grads + AdamW), or with
    a ``DeviceMesh`` the sharded ``make_sharded_train_step``;
  * prefill shapes give ``make_prefill_step``, or with a mesh
    ``make_sharded_prefill_step``;
  * decode shapes give ``make_serve_step`` (ONE new token against a KV
    cache of seq_len capacity: ring-buffer capped for sliding/local
    attention; ``adapt_for_shape`` turns full attention into a sliding
    window of ``LONG_CONTEXT_WINDOW`` at ``long_500k``), or with a mesh
    ``make_sharded_serve_step``.

Besides: ``frontend_inputs``, the stubbed modality frontend's inputs, and
the planner wiring of a launch (``cluster_from_mesh``, ``launch_policy``,
``resolve_launch_plan``), which reads only a mesh's axis sizes.

The sharded train step lays the parameters out as DTensors by
``sharding.partition.params_pspecs``. Each step gathers every non-expert
leaf whole through a differentiable gather whose backward sums the
gradient over the mesh and keeps the rank's shard; the expert leaves
stay each rank's ``E / mo`` rows (gathered only over the data axis when
FSDP shards them) and run through the DEP walk (``core.dep``), whose
exchanges are differentiable. Each rank's batch is its ``batch_pspec``
shard; the loss each rank differentiates is its own over the world size,
so the summed gradients are those of the global mean loss. AdamW then
updates each rank's shards in place.

The sharded prefill and decode steps lay every argument out as the
reference's specs give its device at the inference FSDP threshold:
parameters by ``params_pspecs``, tokens by ``batch_pspec``, caches by
``cache_pspecs``. Each rank computes its own share, as GSPMD lowers the
reference: the model runs with a ``models.parallel.TensorParallel``
(heads, hidden units and vocab split over the model axis, combined by
``all_reduce``/``all_gather`` of activations), the MoE layers walk DEP,
and a cache whose KV heads do not divide the model axis is split along
the sequence and decoded by ``attention.decode_core_seqsharded``. A leaf
FSDP splits over the data axes is gathered at the start of the step
(``local_params``). The steps take the rank's parameter shards (DTensors
or local tensors), the GLOBAL tokens (each rank takes its rows) and the
rank's cache shards, and return the rank's rows and cache shards.
Sharded serving with an engine is ``ServingEngine(ep_group=)``'s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model, frontend_shape
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import ExecutionContext, Model, \
    layer_kinds
from repro_torch.sharding.partition import (PSpec, axis_sizes, batch_axes,
                                            batch_pspec, cache_pspecs,
                                            gather_shards, local_shard,
                                            params_pspecs, placements,
                                            tree_placements)
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            apply_updates)
from repro_torch.training.tree import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def experts_padded(cfg: ModelConfig, mesh, model_axis: str = "model") -> int:
    if cfg.moe is None:
        return 0
    if mesh is None:
        return cfg.moe.num_experts
    return round_up(cfg.moe.num_experts, axis_sizes(mesh)[model_axis])


LONG_CONTEXT_WINDOW = 8192


def adapt_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k decode requires sub-quadratic attention: SSM/hybrid/sliding
    archs run natively; full-attention archs switch to the sliding-window
    decode variant (ring KV cache, window 8192; an MLA arch drops its
    latent, ``mla_kv_lora_rank=0``, which changes its parameter tree)."""
    if (shape.name == "long_500k" and shape.mode == "decode"
            and cfg.uses_attention and not cfg.subquadratic):
        return dataclasses.replace(cfg, attention="sliding",
                                   sliding_window=LONG_CONTEXT_WINDOW,
                                   mla_kv_lora_rank=0)
    return cfg


def pattern_group(cfg: ModelConfig) -> Tuple[str, ...]:
    """Smallest repeating unit of layer kinds (the reference's scanned
    stacking unit)."""
    kinds = layer_kinds(cfg)
    for size in range(1, len(kinds) + 1):
        if len(kinds) % size == 0 and \
                kinds == kinds[:size] * (len(kinds) // size):
            return kinds[:size]
    return kinds


def pattern_len(cfg: ModelConfig) -> int:
    try:
        return len(pattern_group(cfg))
    except Exception:
        return 1


def probe_config(cfg: ModelConfig, units: int) -> ModelConfig:
    """Reduced-depth variant for count-accurate probing: ``units`` repeats
    of the layer pattern, encoder scaled proportionally. All other dims are
    the full config's — counts are linear in units, so two probes determine
    the exact (intercept, slope) for the full depth."""
    plen = pattern_len(cfg)
    kw = dict(num_layers=units * plen)
    if cfg.is_encoder_decoder and cfg.num_encoder_layers:
        ratio = cfg.num_encoder_layers / cfg.num_layers
        kw["num_encoder_layers"] = max(1, round(units * plen * ratio))
    return dataclasses.replace(cfg, **kw)


def _data_parallel(global_batch: int, mesh) -> int:
    """The number of batch shards ``batch_pspec`` makes."""
    sizes = axis_sizes(mesh)
    dp = 1
    for a in batch_axes(batch_pspec(global_batch, mesh)):
        dp *= sizes[a]
    return dp


def default_accum_steps(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        target_tokens_per_device: int = 16384) -> int:
    """Micro-batch count bounding per-device activation tokens."""
    if shape.mode != "train" or mesh is None:
        return 1
    dp = _data_parallel(shape.global_batch, mesh)
    tokens_per_dev = shape.global_batch // dp * shape.seq_len
    want = max(1, tokens_per_dev // target_tokens_per_device)
    # largest accum <= want that divides the per-device batch
    b_dev = shape.global_batch // dp
    accum = 1
    for k in range(1, b_dev + 1):
        if b_dev % k == 0 and k <= want:
            accum = k
    return accum


@dataclass
class StepBundle:
    """A step function and its abstract arguments (``meta`` tensors, in
    the step's argument order). ``placements``, with a mesh, holds each
    argument's DTensor placements (a tree of per-leaf placement tuples,
    or None for an argument that is not laid out on the mesh:
    ``distribute_params`` lays the parameters out by ``placements[0]``,
    and the step takes each rank's rows of the inputs by theirs)."""

    name: str
    step_fn: Callable
    abstract_args: Tuple
    model: Model
    accum_steps: int = 1
    placements: Optional[Tuple] = None


def _mesh_size(mesh) -> int:
    size = getattr(mesh, "size", None)
    if callable(size):                           # a torch DeviceMesh
        return size()
    if size is not None:
        return size
    n = 1
    for v in axis_sizes(mesh).values():
        n *= v
    return n


def cluster_from_mesh(mesh, dtype_bytes: int = 2, model_axis: str = "model"):
    """Map a launch mesh onto the planner's DEP cluster view: the expert
    group is the ``model`` axis and the attention group is the
    data-parallel extent. ``mesh`` is a ``DeviceMesh`` or any object with
    ``shape`` (axis name -> size) and ``size``."""
    from repro_torch.configs.base import DepClusterConfig
    shape = axis_sizes(mesh)
    n = _mesh_size(mesh)
    if n < 2:
        raise ValueError("DEP needs >= 2 devices (an attention group AND "
                         f"an expert group); mesh has {n}")
    # a mesh whose model axis spans every device leaves no room for the
    # attention group under the cluster's disjoint-groups accounting
    eg = min(shape.get(model_axis, 1), n - 1)
    ag = max(min(n // eg, n - eg), 1)
    return DepClusterConfig(num_devices=n, ag=ag, eg=eg,
                            dtype_bytes=dtype_bytes)


def launch_policy(cfg: ModelConfig, mesh, policy: str = "findep",
                  profile=None, mem_cap_samples: int = 64,
                  static_seq_len: Optional[int] = None,
                  profile_store=None):
    """A ``repro_torch.sched`` SchedulePolicy for a static launch by name.

    ``profile`` is a HardwareProfile, a registry name, or a name stored in
    ``profile_store`` (a ``ProfileStore`` or its root path), such as a
    fit the engine's ``calibrate=True`` stored on the card. The default,
    kept for parity with the reference, is its analytic TPU v5e profile
    (``core.perf_model.TPU_V5E``): a plan for the H100 needs the measured
    profile passed in."""
    from repro_torch.core.perf_model import (HardwareProfile, TPU_V5E,
                                             get_profile)
    from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
    from repro_torch.sched import make_policy
    if isinstance(profile, HardwareProfile):
        hw = profile
    elif profile is None:
        hw = TPU_V5E
    else:
        hw = None
        if profile_store is not None:
            from repro_torch.profiling import ProfileStore
            store = (profile_store
                     if isinstance(profile_store, ProfileStore)
                     else ProfileStore(profile_store))
            try:
                hw = store.load_profile(profile)
            except KeyError:
                hw = None
        if hw is None:
            hw = get_profile(profile)
    planner = FinDEPPlanner(cfg, cluster_from_mesh(mesh), hw,
                            PlannerConfig(mem_cap_samples=mem_cap_samples))
    return make_policy(policy, planner, static_seq_len=static_seq_len)


def resolve_launch_plan(cfg: ModelConfig, mesh, policy, seq_len: int,
                        mode: str = "prefill",
                        batch_per_device: Optional[int] = None,
                        profile=None, profile_store=None):
    """The schedule a static pipeline runs for one shape. ``policy`` is a
    SchedulePolicy or a name ("findep" etc.); None when the config or mesh
    cannot be DEP-scheduled."""
    if not cfg.is_moe or mesh is None:
        return None
    if isinstance(policy, str):
        policy = launch_policy(cfg, mesh, policy, profile=profile,
                               static_seq_len=seq_len,
                               profile_store=profile_store)
    phase = "decode" if mode == "decode" else "prefill"
    return policy.resolve(phase, seq_len, batch_per_device)


def make_model(cfg: ModelConfig, mesh=None, moe_impl: Optional[str] = None,
               remat: bool = False, dtype=torch.bfloat16,
               device: DeviceLike = None, attn_impl: str = "xla",
               batch_sharded: bool = False, tp=None) -> Model:
    """The model of a launch. With a ``DeviceMesh`` an MoE config runs
    DEP over the mesh's groups (``DepGroups.from_mesh``) and its experts
    are padded to divide the model axis. ``batch_sharded`` marks each
    rank's tokens as its data shard (the sharded steps); ``tp`` (a
    ``models.parallel.TensorParallel``) makes every parameter the rank's
    shard (the sharded prefill and decode steps). ``device=None`` means
    the card; ``"meta"`` gives a model for shapes only."""
    if moe_impl is None:
        moe_impl = "dep" if (mesh is not None and cfg.is_moe) else "capacity"
    groups = None
    if moe_impl == "dep":
        if mesh is None:
            raise ValueError("moe_impl='dep' needs a mesh")
        from repro_torch.core.dep import DepGroups
        groups = DepGroups.from_mesh(mesh)
    ctx = ExecutionContext(attn_impl=attn_impl, moe_impl=moe_impl,
                           groups=groups, remat=remat,
                           batch_sharded=batch_sharded, tp=tp)
    return build_model(cfg, ctx=ctx, dtype=dtype, device=device,
                       num_experts_padded=experts_padded(cfg, mesh))


def _meta_twin(model: Model, dtype=torch.float32) -> Model:
    return Model(model.cfg, ExecutionContext(), dtype=dtype, device="meta",
                 num_experts_padded=model.E_pad)


def abstract_params(model: Model, dtype=torch.bfloat16):
    """The parameter tree's shapes as ``meta`` tensors, drawing nothing:
    float32 leaves in ``dtype``, others as they are (the reference's
    ``eval_shape`` of ``init``, whose leaves are all float32)."""
    shapes = _meta_twin(model).init(MetaGenerator())
    return tree_map(lambda s: s.to(dtype) if s.dtype == torch.float32
                    else s, shapes)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# input specs per mode
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Abstract model inputs (``meta`` tensors of the global shapes) for
    one input shape: int32 ``tokens``, and the stub frontend's ``extra``
    (or, decoding an encoder-decoder model, its ``memory``).
    ``input_pspecs`` gives their specs on a mesh."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    specs["tokens"] = _meta((B, S) if shape.mode in ("train", "prefill")
                            else (B, 1), torch.int32)
    fs = frontend_shape(cfg, shape)
    if fs is not None:
        if cfg.is_encoder_decoder and shape.mode == "decode":
            # decode consumes precomputed encoder memory
            specs["memory"] = _meta((B, fs[1], cfg.d_model), dtype)
        else:
            specs["extra"] = _meta(fs, dtype)
    return specs


def _input_pspec(ndim: int, global_batch: int, mesh) -> PSpec:
    b = batch_pspec(global_batch, mesh)
    lead = b[0] if b != PSpec(None) else None
    return PSpec(lead, *([None] * (ndim - 1)))


def input_pspecs(specs: Dict[str, Any], shape: ShapeConfig, mesh):
    """The ``PSpec`` of each of ``input_specs``' inputs on ``mesh``: the
    batch over ``batch_pspec``'s axes, every other dim whole
    (``shard_batch`` takes a rank's rows by the same spec)."""
    return {k: _input_pspec(v.ndim, shape.global_batch, mesh)
            for k, v in specs.items()}


def decode_cache_specs(model: Model, cfg: ModelConfig, shape: ShapeConfig,
                       dtype=torch.bfloat16):
    """The decode caches of ``shape`` as ``meta`` tensors: a vlm's budget
    adds its ``frontend_tokens``. ``sharding.partition.cache_pspecs``
    gives their specs on a mesh."""
    B, S = shape.global_batch, shape.seq_len
    budget = S
    if cfg.family == "vlm":
        budget += cfg.frontend_tokens
    return _meta_twin(model).init_cache(B, budget, dtype)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

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
    ``attn_impl="xla"``, the reference's own training configuration: the
    expert GEMM kernel and the DEP walk have a backward, and every other
    kernel wrapper refuses a tensor that requires a gradient. A sharded
    step is ``make_sharded_train_step``'s."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=torch.bfloat16)

    def train_step(params, opt_state, tokens, extra=None):
        loss, grads = loss_and_grads(model, params, tokens, extra,
                                     accum_steps, accum_dtype, ce_chunk)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def _mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over every rank of ``mesh`` (in place)."""
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    return t


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` [B, ...]: its shard under
    the placements of ``input_pspecs`` (the data axes ``batch_pspec``
    names, major first, pick the rank's contiguous block of ``B / dp``
    rows), which a sharded ``StepBundle`` carries for its inputs."""
    return local_shard(x, placements(_input_pspec(x.ndim, x.shape[0], mesh),
                                     mesh), mesh)


def sharded_loss_and_grads(model: Model, params, mesh, tokens, extra=None,
                           accum_steps: int = 1, accum_dtype=torch.float32,
                           ce_chunk: Optional[int] = None,
                           model_axis: str = "model", plan=None):
    """(global mean loss, grads) of ``model.loss`` over a mesh. ``params``
    is a tree of DTensors (``distribute_params``); ``tokens`` (and
    ``extra``) is this rank's batch shard. Every non-expert leaf is
    gathered whole and every expert leaf over all but the model axis
    (``gather_shards``), once per micro-batch; the rank differentiates
    its loss over the world size, so that the gather's and the DEP
    walk's backward sums give each rank its shards' gradients of the
    global mean loss. ``grads`` are DTensors with the parameters'
    placements, in ``accum_dtype`` when ``accum_steps`` > 1 (the
    parameter's dtype otherwise). ``plan`` is the MoE layers' DEP
    schedule."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.partition import gather_shards
    model_dim = tuple(mesh.mesh_dim_names).index(model_axis)
    paths = tree_paths(params)
    wrt = [p.to_local().detach().requires_grad_() for _, p in paths]
    world = mesh.size()

    def grads_of(tok, ex):
        with torch.enable_grad():
            full = [gather_shards(w, mesh, p.placements,
                                  model_dim if "experts" in names else None)
                    for w, (names, p) in zip(wrt, paths)]
            tree = tree_unflatten(params, full)
            kw = {} if ce_chunk is None else {"ce_chunk": ce_chunk}
            loss = model.loss(tree, tok, extra_embeds=ex, plan=plan, **kw)
            got = torch.autograd.grad(loss / world, wrt, allow_unused=True)
        return loss.detach(), [torch.zeros_like(a) if g is None else g
                               for a, g in zip(wrt, got)]

    tokens = torch.as_tensor(tokens).to(model.device)
    if accum_steps <= 1:
        loss, grads = grads_of(tokens, extra)
    else:
        mb = tokens.shape[0] // accum_steps
        grads = [torch.zeros(a.shape, dtype=accum_dtype, device=a.device)
                 for a in wrt]
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(accum_steps):
            rows = slice(i * mb, (i + 1) * mb)
            loss_i, g_i = grads_of(tokens[rows],
                                   extra[rows] if extra is not None
                                   else None)
            for a, g in zip(grads, g_i):
                a.add_(g.to(accum_dtype))
            loss = loss + loss_i
            del g_i
        grads = [a / accum_steps for a in grads]
        loss = loss / accum_steps
    loss = _mesh_sum(loss.float().clone(), mesh) / world
    out = [DTensor.from_local(g, mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())
           for g, (_, p) in zip(grads, paths)]
    return loss, tree_unflatten(params, out)


def make_sharded_train_step(model: Model, mesh,
                            opt_cfg: Optional[AdamWConfig] = None,
                            accum_steps: int = 1, accum_dtype=torch.float32,
                            ce_chunk: Optional[int] = None, plan=None):
    """``train_step(params, opt_state, tokens, extra=None) -> (params,
    opt_state, {"loss", "grad_norm"})`` on a ``DeviceMesh``: ``params``
    and the AdamW states are DTensor trees (``distribute_params``,
    ``init_opt_state``), ``tokens`` the GLOBAL batch, of which each rank
    takes its ``batch_pspec`` shard. ``sharded_loss_and_grads``, then
    AdamW on each rank's shards in place; the grad norm is the whole
    tree's (``global_norm`` counts each shard once). The model is
    ``make_model(cfg, mesh, batch_sharded=True)``'s."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=torch.bfloat16)
    if not model.ctx.batch_sharded:
        raise ValueError("the sharded train step needs a model whose "
                         "context has batch_sharded=True")

    def train_step(params, opt_state, tokens, extra=None):
        tok = shard_batch(tokens, mesh)
        ex = shard_batch(extra, mesh) if extra is not None else None
        loss, grads = sharded_loss_and_grads(model, params, mesh, tok, ex,
                                             accum_steps, accum_dtype,
                                             ce_chunk, plan=plan)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# the sharded prefill and decode steps
# ---------------------------------------------------------------------------

def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _model_dim(mesh, model_axis: str = "model") -> int:
    return tuple(mesh.mesh_dim_names).index(model_axis)


def local_params(params, pls, mesh, model_axis: str = "model"):
    """The rank's parameters for a sharded prefill or decode step: each
    leaf's shard (a DTensor's local tensor, or the tensor itself) laid out
    by ``pls`` (``StepBundle.placements[0]``), gathered over every mesh
    dimension but the model axis (what FSDP splits over the data axes is
    gathered just before use)."""
    keep = _model_dim(mesh, model_axis)
    return tree_unflatten(params, [
        gather_shards(_local(p), mesh, pl, keep)
        for p, pl in zip(tree_leaves(params), tree_leaves(pls, tuple))])


def local_abstract(tree, pls, mesh):
    """``meta`` tensors of the rank's shards of the abstract (global)
    ``tree`` laid out by ``pls`` (the tree of each leaf's placements)."""
    from torch.distributed.tensor import Shard
    out = []
    for x, pl in zip(tree_leaves(tree), tree_leaves(pls, tuple)):
        shape = list(x.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.size(i)
        out.append(_meta(tuple(shape), x.dtype))
    return tree_unflatten(tree, out)


def arg_bytes(bundle: "StepBundle", mesh) -> int:
    """Bytes of one rank's arguments of a sharded ``bundle``: its shard
    of every abstract argument by the bundle's placements (the
    reference's ``memory_analysis().argument_size_in_bytes``; the
    optimizer's step counter is whole on every rank)."""
    n = 0
    for arg, pls in zip(bundle.abstract_args, bundle.placements):
        if isinstance(arg, OptState):
            n += arg.step.numel() * arg.step.element_size()
            pairs = ((arg.mu, pls.mu), (arg.nu, pls.nu))
        else:
            pairs = ((arg, pls),)
        for tree, pl in pairs:
            for x in tree_leaves(local_abstract(tree, pl, mesh)):
                n += x.numel() * x.element_size()
    return n


def make_sharded_prefill_step(model: Model, mesh, pls, plan=None):
    """``prefill_step(params, tokens, extra=None) -> (logits [Bl,1,V],
    the rank's cache shards)`` on a mesh: ``params`` are the rank's
    shards (DTensors or local tensors) laid out by ``pls``, ``tokens``
    (and ``extra``) the GLOBAL batch, of which the rank takes its rows.
    ``plan`` is the MoE layers' DEP schedule."""
    def prefill_step(params, tokens, extra=None):
        with torch.no_grad():
            p = local_params(params, pls, mesh)
            tok = shard_batch(tokens, mesh)
            ex = shard_batch(extra, mesh) if extra is not None else None
            memory = None
            if model.cfg.is_encoder_decoder and ex is not None:
                memory = model.encode(p, ex)
                ex = None
            return model.prefill(p, tok, extra_embeds=ex, memory=memory,
                                 plan=plan)
    return prefill_step


def sharded_decode(model: Model, mesh, pls, params, tokens, caches,
                   memory=None, plan=None):
    """One decode step on a mesh -> (logits [Bl,1,V] of the rank's rows,
    the rank's cache shards, written in place): ``params`` the rank's
    shards, ``tokens`` (and ``memory``) the GLOBAL batch, ``caches`` the
    rank's shards."""
    with torch.no_grad():
        p = local_params(params, pls, mesh)
        tok = shard_batch(tokens, mesh)
        mem = shard_batch(memory, mesh) if memory is not None else None
        return model.decode_step(p, tok, tree_map(_local, caches),
                                 memory=mem, plan=plan)


def make_sharded_serve_step(model: Model, mesh, pls, plan=None):
    """``serve_step(params, tokens, caches, memory=None) -> (next tokens
    [Bl, 1] int64 of the rank's rows, the rank's cache shards)``:
    ``sharded_decode`` and its greedy token."""
    def serve_step(params, tokens, caches, memory=None):
        logits, caches = sharded_decode(model, mesh, pls, params, tokens,
                                        caches, memory, plan)
        return logits[:, -1].argmax(-1)[:, None], caches
    return serve_step


def _seq_cache(cfg: ModelConfig, capacity: int, mo: int) -> bool:
    """Whether ``cache_pspecs`` splits the attention caches of a step of
    ``capacity`` along the sequence (the KV heads do not divide the model
    axis and the capacity does; MLA caches are never split)."""
    from repro_torch.models.attention import cache_capacity, is_ring
    if not cfg.uses_attention or cfg.mla_kv_lora_rank:
        return False
    acfg = (dataclasses.replace(cfg, attention="local")
            if cfg.family == "hybrid" else cfg)
    C = cache_capacity(acfg, capacity) if is_ring(acfg) else capacity
    return cfg.num_kv_heads % mo != 0 and C % mo == 0


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------

def build(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
          dtype=torch.bfloat16, opt_cfg: Optional[AdamWConfig] = None,
          moe_impl: Optional[str] = None, remat: Optional[bool] = None,
          accum_steps: Optional[int] = None,
          attn_impl: Optional[str] = None, ce_chunk: Optional[int] = None,
          device: DeviceLike = None, plan=None) -> StepBundle:
    """The ``StepBundle`` of ``cfg`` (adapted to ``shape`` by the caller,
    as the reference's callers do) at ``shape``, with a ``DeviceMesh`` its
    sharded step. ``plan`` is the MoE layers' DEP schedule on a mesh (a
    ``Plan``, an ``ExecProgram`` or None for the unchunked one).
    ``device=None`` means the card; the abstract arguments are ``meta``
    tensors (global shapes) whatever it is."""
    if remat is None:
        remat = shape.mode == "train"
    if accum_steps is None:
        accum_steps = default_accum_steps(cfg, shape, mesh)
    if plan is not None and hasattr(plan, "exec_program"):
        plan = plan.exec_program()
    tp = None
    if mesh is not None and shape.mode != "train":
        from repro_torch.models.parallel import TensorParallel
        budget = shape.seq_len + (cfg.frontend_tokens
                                  if cfg.family == "vlm" else 0)
        mo = axis_sizes(mesh)["model"]
        tp = TensorParallel.from_mesh(mesh, _seq_cache(cfg, budget, mo))
    model = make_model(cfg, mesh, moe_impl=moe_impl, remat=remat,
                       dtype=dtype, device=device,
                       attn_impl=attn_impl or "xla",
                       batch_sharded=mesh is not None, tp=tp)
    params_abs = abstract_params(model, dtype)
    # FSDP policy: train shards aggressively (opt states dominate);
    # inference keeps weights resident unless truly huge
    fsdp_threshold = (8 * 1024 * 1024 if shape.mode == "train"
                      else 64 * 1024 * 1024)
    pspecs = params_pspecs(params_abs, cfg, mesh=mesh,
                           fsdp_threshold_elems=fsdp_threshold)
    inputs = input_specs(cfg, shape, dtype)
    ppl = tree_placements(pspecs, mesh) if mesh is not None else None
    ipl = (tree_placements(input_pspecs(inputs, shape, mesh), mesh)
           if mesh is not None else None)
    name = f"{cfg.name}:{shape.name}:{shape.mode}"

    if shape.mode == "train":
        opt_cfg = opt_cfg or AdamWConfig(state_dtype=torch.bfloat16)
        st = opt_cfg.state_dtype
        opt_abs = OptState(step=_meta((), torch.int32),
                           mu=tree_map(lambda p: _meta(p.shape, st or
                                                       p.dtype), params_abs),
                           nu=tree_map(lambda p: _meta(p.shape, st or
                                                       p.dtype), params_abs))
        args = [params_abs, opt_abs, inputs["tokens"]]
        if "extra" in inputs:
            args.append(inputs["extra"])
        if mesh is None:
            fn = make_train_step(model, opt_cfg, accum_steps=accum_steps,
                                 ce_chunk=ce_chunk)
            return StepBundle(name=name, step_fn=fn,
                              abstract_args=tuple(args), model=model,
                              accum_steps=accum_steps)
        fn = make_sharded_train_step(model, mesh, opt_cfg,
                                     accum_steps=accum_steps,
                                     ce_chunk=ce_chunk, plan=plan)
        pls = [ppl, OptState(step=None, mu=ppl, nu=ppl), ipl["tokens"]]
        if "extra" in inputs:
            pls.append(ipl["extra"])
        return StepBundle(name=name, step_fn=fn, abstract_args=tuple(args),
                          model=model, accum_steps=accum_steps,
                          placements=tuple(pls))

    if shape.mode == "prefill":
        args = [params_abs, inputs["tokens"]]
        if "extra" in inputs:
            args.append(inputs["extra"])
        if mesh is None:
            return StepBundle(name=name, step_fn=make_prefill_step(model),
                              abstract_args=tuple(args), model=model)
        pls = [ppl, ipl["tokens"]] + ([ipl["extra"]] if "extra" in inputs
                                      else [])
        return StepBundle(name=name,
                          step_fn=make_sharded_prefill_step(model, mesh, ppl,
                                                            plan),
                          abstract_args=tuple(args), model=model,
                          placements=tuple(pls))

    # decode
    caches_abs = decode_cache_specs(model, cfg, shape, dtype)
    args = [params_abs, inputs["tokens"], caches_abs]
    if "memory" in inputs:
        args.append(inputs["memory"])
    if mesh is None:
        return StepBundle(name=name, step_fn=make_serve_step(model),
                          abstract_args=tuple(args), model=model)
    cpl = tree_placements(cache_pspecs(caches_abs, cfg, mesh,
                                       shape.global_batch), mesh)
    pls = [ppl, ipl["tokens"], cpl] + ([ipl["memory"]] if "memory" in inputs
                                       else [])
    return StepBundle(name=name,
                      step_fn=make_sharded_serve_step(model, mesh, ppl, plan),
                      abstract_args=tuple(args), model=model,
                      placements=tuple(pls))
