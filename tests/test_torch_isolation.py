"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX, nothing of the JAX package ``repro`` and no ``ml_dtypes`` (which
ships with JAX and is missing where the port runs on the card), and
their entry points run on the card unless the caller asks for the
CPU. The launch layer (``launch/steps.py``, ``launch/mesh.py``,
``sharding/``) imports and builds its specs with those blocked, and only
its spec builders reach the ``meta`` device; ``roofline/``,
``launch/dryrun.py`` and ``launch/recount.py`` import with them blocked
and count a step on the production mesh."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

_BLOCKED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
for must in ("repro_torch.launch.steps", "repro_torch.launch.mesh",
             "repro_torch.sharding", "repro_torch.sharding.partition",
             "repro_torch.roofline", "repro_torch.roofline.analysis",
             "repro_torch.launch.dryrun", "repro_torch.launch.recount",
             "repro_torch.models.parallel"):
    assert must in names, must
print("imported", len(names), "modules")
"""

#: the launch layer's modules, each imported alone with the blocker and
#: run on the ``meta`` device (specs only, nothing allocated)
_LAUNCH_LAYER = r"""
import importlib, sys

BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
mod = importlib.import_module(sys.argv[1])
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import steps
from repro_torch.sharding import partition
shape = SHAPES["long_500k"]
cfg = steps.adapt_for_shape(get_config("qwen2-moe-a2.7b"), shape)
b = steps.build(cfg, shape, device="meta")
mesh = type("M", (), {"shape": {"data": 16, "model": 16}})()
specs = partition.params_pspecs(b.abstract_args[0], cfg, mesh=mesh)
caches = partition.cache_pspecs(b.abstract_args[2], cfg, mesh, 1)
assert b.abstract_args[2][0]["k"].shape[1] == steps.LONG_CONTEXT_WINDOW
if mod.__name__ in ("repro_torch.launch.dryrun", "repro_torch.launch.recount",
                    "repro_torch.roofline"):
    # the dry run itself: a fake group, the production mesh, the counter
    from repro_torch.launch import dryrun
    rec = dryrun.run_one("qwen2-moe-a2.7b", "long_500k", verbose=False)
    assert rec["ok"] and rec["flops_per_device"] > 0
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("ok", mod.__name__)
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(SMOKE)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.steps",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.sharding.partition",
                                    "repro_torch.roofline",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.recount"])
def test_launch_layer_runs_with_jax_and_repro_blocked(module):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _LAUNCH_LAYER, module],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"ok {module}" in res.stdout


def test_meta_only_for_the_spec_builders():
    """``meta`` reaches the model the spec builders make, and no entry
    point: ``resolve_device`` refuses it unless asked, and so does the
    engine."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import ServingEngine
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="meta"):
        ServingEngine(get_smoke_config("qwen2-moe-a2.7b"), device="meta")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path}: {name}"


def test_entry_points_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("qwen2-moe-a2.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("qwen2-moe-a2.7b"), device="cuda")
    model = build_model(get_smoke_config("qwen2-moe-a2.7b"), device="cpu")
    assert model.device.type == "cpu"
