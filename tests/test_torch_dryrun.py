"""The port's dry run (``launch.dryrun``, ``launch.recount``) and its
production mesh (``launch.mesh.make_production_mesh``), on the CPU.
Every fake-group run is a subprocess.

  * ``run_one`` on the 16x16 mesh for ``qwen2-moe-a2.7b x decode_32k``
    (the heads split over the model axis) and ``qwen3-moe x
    decode_32k`` (four KV heads: the cache split along the sequence)
    completes with the reference's record keys, and its
    ``arg_bytes_per_device`` equals the bytes of rank 0's shards by the
    reference's own partition specs (parameters, tokens, caches);
  * ``arg_bytes_per_device`` against the reference's
    ``memory_analysis().argument_size_in_bytes`` of the same bundle
    (prefill, decode, train) on a 2x4 mesh: the reference compiled on
    eight forced host devices, the port's on a fake group of eight;
  * the full-depth count against the reference's linear extrapolation
    from ``probe_config`` at 1x and 2x the layer pattern, exactly, on a
    homogeneous stack (qwen2-moe-a2.7b's 24 MoE layers);
  * ``make_production_mesh``: the axes and sizes of both meshes, a live
    fake group of the other size replaced, a real group of another size
    refused; ``recount_one`` re-derives the count fields and only them;
    the entry point prints a record.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KEYS = ("arch", "shape", "mesh", "mode", "ok", "accum_steps",
        "arg_bytes_per_device", "temp_bytes_per_device",
        "peak_gb_per_device", "flops_per_device", "hbm_bytes_per_device",
        "collective_bytes_per_device", "collective_counts",
        "collective_bytes_by_kind", "compute_ms", "memory_ms",
        "collective_ms", "dominant", "model_flops", "useful_flops_ratio")


def _python(code: str, *args, devices: int = 0):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout: int = 600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


_RUN_ONE = r"""
import json
from repro_torch.launch import dryrun, recount
recs = [dryrun.run_one(a, "decode_32k", verbose=False)
        for a in ("qwen2-moe-a2.7b", "qwen3-moe")]
again = recount.recount_one(dict(recs[0], flops_per_device=-1.0,
                                 arg_bytes_per_device=-7), False)
print(json.dumps([recs, again]))
"""

# rank 0's argument bytes by the reference's partition specs, on an
# abstract 16x16 mesh (no device)
_REFERENCE_ARG_BYTES = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AbstractMesh
from repro.configs import get_config, get_shape
from repro.launch import steps
from repro.sharding.partition import batch_pspec, cache_pspecs, \
    params_pspecs

mesh = AbstractMesh((16, 16), ("data", "model"))


def local_bytes(sds, spec):
    shape = list(sds.shape)
    for d, e in enumerate(tuple(spec)):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            shape[d] //= mesh.shape[a]
    return int(np.prod(shape)) * jnp.dtype(sds.dtype).itemsize


out = {}
for arch in ("qwen2-moe-a2.7b", "qwen3-moe"):
    shape = get_shape("decode_32k")
    cfg = steps.adapt_for_shape(get_config(arch), shape)
    model = steps.make_model(cfg, mesh, scan_layers=False)
    params = steps.abstract_params(model)
    specs = params_pspecs(params, cfg, mesh=mesh,
                          fsdp_threshold_elems=64 * 1024 * 1024)
    n = sum(local_bytes(p, s) for p, s in zip(jax.tree.leaves(params),
                                              jax.tree.leaves(specs)))
    caches = steps.decode_cache_specs(model, cfg, shape, None)
    cspecs = cache_pspecs(caches, cfg, mesh, shape.global_batch)
    n += sum(local_bytes(c, s) for c, s in zip(
        jax.tree.leaves(caches), jax.tree.leaves(
            cspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    dp = 16 if batch_pspec(shape.global_batch, mesh)[0] else 1
    n += shape.global_batch // dp * 4
    out[arch] = n
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """Every subprocess of this file, started at once."""
    arg = json.dumps(_CASES)
    return {"run_one": _python(_RUN_ONE),
            "reference_arg_bytes": _python(_REFERENCE_ARG_BYTES),
            "reference_memory": _python(_REFERENCE_MEMORY, arg, devices=8),
            "port_memory": _python(_PORT_MEMORY, arg),
            "probes": _python(_PROBES), "meshes": _python(_MESHES),
            "entry": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "granite-moe-1b-a400m", "--shape", "long_500k",
                 "--multi-pod"], env=dict(os.environ, PYTHONPATH=SRC),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}


@pytest.fixture(scope="module")
def production(runs):
    return _result(runs["run_one"]), _result(runs["reference_arg_bytes"])


def test_run_one_on_the_production_mesh(production):
    (recs, _), want = production
    for rec in recs:
        assert rec["ok"] and rec["mesh"] == "16x16"
        assert all(k in rec for k in KEYS), set(KEYS) - set(rec)
        assert "lower_s" not in rec and rec["count_s"] > 0
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["arg_bytes_per_device"] == want[rec["arch"]], rec["arch"]
    heads, seq = recs
    # heads split: each rank attends its own heads with the decode kernel
    assert heads["kernel_work"]["decode_attention"]["calls"] == 24
    # the sequence split: no decode kernel, the distributed softmax's
    # all_reduce (MAX, the sum, the values) in every layer
    assert "decode_attention" not in seq["kernel_work"]
    assert seq["collective_counts"]["all-reduce"] >= 3 * 48


def test_recount_rederives_only_the_count_fields(production):
    (recs, again), _ = production
    assert again["flops_per_device"] == recs[0]["flops_per_device"]
    assert again["collective_counts"] == recs[0]["collective_counts"]
    assert again["arg_bytes_per_device"] == -7


# ---------------------------------------------------------------------------
# arg bytes against the reference's memory_analysis on a 2x4 mesh
# ---------------------------------------------------------------------------

_CASES = (("qwen2-moe-a2.7b", "prefill", 64, 4),
          ("qwen2-moe-a2.7b", "decode", 64, 4),
          ("qwen2-moe-a2.7b", "train", 32, 4),
          ("recurrentgemma-9b", "decode", 128, 2),
          ("internvl2-1b", "prefill", 32, 2))

_REFERENCE_MEMORY = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import steps

cases = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = []
for arch, mode, S, B in cases:
    cfg = get_smoke_config(arch)
    b = steps.build(cfg, ShapeConfig("s", S, B, mode), mesh=mesh,
                    scan_layers=False)
    out.append(b.lower().compile().memory_analysis()
               .argument_size_in_bytes)
print(json.dumps(out))
"""

_PORT_MEMORY = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps

cases = json.loads(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                  mesh_dim_names=("data", "model"))
out = []
for arch, mode, S, B in cases:
    b = steps.build(get_smoke_config(arch), ShapeConfig("s", S, B, mode),
                    mesh=mesh, device="meta")
    out.append(steps.arg_bytes(b, mesh))
print(json.dumps(out))
"""


def test_arg_bytes_match_reference_memory_analysis(runs):
    want = _result(runs["reference_memory"])
    assert _result(runs["port_memory"]) == want


# ---------------------------------------------------------------------------
# the full-depth count against the probes' extrapolation
# ---------------------------------------------------------------------------

_PROBES = r"""
import dataclasses, json
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh

mesh = make_production_mesh()
out = {}
for name in ("decode_32k", "prefill_32k"):
    shape = get_shape(name)
    cfg = steps.adapt_for_shape(get_config("qwen2-moe-a2.7b"), shape)
    counts = []
    for c in (steps.probe_config(cfg, 1), steps.probe_config(cfg, 2), cfg):
        b = steps.build(c, shape, mesh, attn_impl="decode_kernel",
                        device="meta")
        counts.append(dryrun.count_step(b, mesh)[0].as_dict())
    out[name] = [counts, cfg.num_layers / steps.pattern_len(cfg)]
print(json.dumps(out))
"""


def test_full_depth_equals_probe_extrapolation(runs):
    res = _result(runs["probes"])
    for name, ((c1, c2, full), units) in res.items():
        assert units == 24.0

        def lin(a, b):
            return a + (b - a) * (units - 1.0)
        assert full["flops"] == lin(c1["flops"], c2["flops"]), name
        assert full["hbm_bytes"] == lin(c1["hbm_bytes"], c2["hbm_bytes"])
        for k in full["kernels"]:
            for f in ("calls", "flops", "bytes"):
                assert full["kernels"][k][f] == lin(c1["kernels"][k][f],
                                                    c2["kernels"][k][f])
        for kind, n in full["collective_counts"].items():
            assert n == lin(c1["collective_counts"].get(kind, 0),
                            c2["collective_counts"].get(kind, 0)), kind
            assert full["collective_bytes"][kind] == pytest.approx(
                lin(c1["collective_bytes"].get(kind, 0.0),
                    c2["collective_bytes"].get(kind, 0.0)), rel=1e-12)


# ---------------------------------------------------------------------------
# make_production_mesh and the entry point
# ---------------------------------------------------------------------------

_MESHES = r"""
import json
import torch.distributed as dist
from repro_torch.launch.mesh import make_production_mesh
one = make_production_mesh()
res = [list(one.mesh_dim_names), list(one.shape), dist.get_backend()]
two = make_production_mesh(multi_pod=True)     # replaces the fake group
res += [list(two.mesh_dim_names), list(two.shape), dist.get_world_size(),
        list(two.get_coordinate())]
dist.destroy_process_group()
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0", rank=0,
                        world_size=1)
try:
    make_production_mesh()
    res.append("no error")
except RuntimeError as e:
    res.append(str(e))
print(json.dumps(res))
"""


def test_make_production_mesh(runs):
    res = _result(runs["meshes"])
    assert res[:3] == [["data", "model"], [16, 16], "fake"]
    assert res[3:7] == [["pod", "data", "model"], [2, 16, 16], 512,
                        [0, 0, 0]]
    assert "gloo" in res[7] and "256" in res[7]


def test_dryrun_entry_point_prints_a_record(runs):
    rec = _result(runs["entry"])
    assert rec["ok"] and rec["mesh"] == "2x16x16"
    assert all(k in rec for k in KEYS)
