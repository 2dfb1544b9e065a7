"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the JAX package ``repro``, and their entry points run
on the card unless the caller asks for the CPU."""
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

BLOCKED = ("jax", "jaxlib", "repro")


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
print("imported", len(names), "modules")
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(SMOKE)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


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
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


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
