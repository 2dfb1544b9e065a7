"""CUDA-graph hygiene lint over ``src/repro_torch``: the port's
counterpart of ``repro.analysis.jitlint``. A captured decode step is the
port's ``jax.jit``, and the reference lint's three hazard families map
onto it:

1. **Recapture from keys.** ``runtime.decode_graph.GraphKey`` is laid out
   like the reference's ``static_argnames``, and the plan cache keys on
   plans: a key type that is unhashable raises, and one that hashes by
   identity captures a new graph for every equal object.
   ``check_static_types`` verifies field by field that each frozen
   dataclass reaching a graph key or a plan-cache key (``Plan``, ``Task``,
   ``TaskGraph``, ``ExecProgram``, ``TaskCosts``, ``CostBreakdown``,
   ``Placement``, ``SkewSummary``) stays hashable by value.
   ``DevicePlacement`` is exempt by name (``IDENTITY_KEYED``, with its
   reason).
2. **Host syncs.** ``.item()``, ``.tolist()``, ``.cpu()`` and
   ``.numpy()``, ``torch.cuda.synchronize`` and ``np.asarray`` /
   ``np.array`` wait for the card, and inside a captured step they fail
   the capture. An AST scan of the modules a step runs (``HOT_MODULES``)
   flags each, except in host-side setup code that ``ALLOWED_HOST_SYNCS``
   names by function, with its reason.
3. **The DEP walker's tracer rule.** ``core/dep.py`` reads the ambient
   tracer through ``active_tracer``, bound at module level, and never
   calls ``use_tracer`` or sets the ContextVar (a capture would bake one
   recorder into the graph).

The card's half of the lint is chip_smoke's runtime guard: one eager
decode step under ``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import typing
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Violation

PASS = "capturelint"

#: modules a decode or prefill step runs through (relative to the package)
HOT_MODULES = (
    "core/dep.py",
    "models/moe.py",
    "models/attention.py",
    "models/layers.py",
    "models/transformer.py",
)

#: modules under the DEP walker's tracer rule
TRACER_MODULES = ("core/dep.py",)

#: tensor methods that copy to the host and wait for the device
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: numpy functions that materialise a tensor on the host
_NP_SYNC = {"asarray", "array"}

#: host-side setup code in the hot modules: (module, function) -> reason
ALLOWED_HOST_SYNCS: Dict[Tuple[str, str], str] = {
    ("core/dep.py", "DepGroups.from_mesh"):
        "calls .tolist() on the mesh's numpy rank grid while it creates "
        "the data groups, once, before any step",
}

#: frozen dataclasses that reach a graph key or a plan-cache key
STATIC_KEY_TYPES: Tuple[Tuple[str, str], ...] = (
    ("repro_torch.core.solver", "Plan"),
    ("repro_torch.core.taskgraph", "Task"),
    ("repro_torch.core.taskgraph", "TaskGraph"),
    ("repro_torch.core.taskgraph", "ExecProgram"),
    ("repro_torch.core.taskgraph", "TaskCosts"),
    ("repro_torch.core.taskgraph", "CostBreakdown"),
    ("repro_torch.placement.placement", "Placement"),
    ("repro_torch.placement.tracker", "SkewSummary"),
)

#: key types compared by identity on purpose: name -> reason
IDENTITY_KEYED: Dict[Tuple[str, str], str] = {
    ("repro_torch.core.dep", "DevicePlacement"):
        "a graph holds the device tensors it was captured on, so an equal "
        "placement in other tensors must capture anew (eq=False)",
}

_HASH_SAFE_LEAVES = (int, float, str, bool, bytes, type(None))


# ---------------------------------------------------------------------------
# key types stay hashable by value
# ---------------------------------------------------------------------------

def _type_hash_problem(tp, seen: Set) -> Optional[str]:
    """Why ``tp`` is not safely hashable as a key field's type (None =
    fine). Recurses through Optional/Union/Tuple/FrozenSet and nested
    frozen dataclasses."""
    if tp in seen:
        return None
    seen = seen | {tp}
    if tp in _HASH_SAFE_LEAVES or tp is typing.Any:
        return None
    origin = typing.get_origin(tp)
    if origin in (tuple, frozenset, typing.Union):
        for a in typing.get_args(tp):
            if a is Ellipsis:
                continue
            why = _type_hash_problem(a, seen)
            if why:
                return why
        return None
    if origin in (list, dict, set):
        return f"{tp} is a mutable container"
    if isinstance(tp, type):
        if dataclasses.is_dataclass(tp):
            return _dataclass_hash_problem(tp, seen)
        if issubclass(tp, _HASH_SAFE_LEAVES):
            return None
        if tp.__hash__ is None:
            return f"{tp.__name__} is unhashable"
        if tp.__eq__ is object.__eq__:
            return (f"{tp.__name__} hashes by identity (no __eq__): every "
                    "instance keys a fresh capture")
        return None
    return f"unrecognized annotation {tp!r}"


def _dataclass_hash_problem(cls, seen: Set) -> Optional[str]:
    params = getattr(cls, "__dataclass_params__", None)
    if params is None or not params.frozen:
        return f"{cls.__name__} is not a frozen dataclass"
    if cls.__hash__ is None:
        return (f"{cls.__name__} has eq but no hash "
                "(frozen=False or eq without frozen)")
    if not params.eq:
        return (f"{cls.__name__} compares by identity (eq=False): every "
                "instance keys a fresh capture")
    try:
        hints = typing.get_type_hints(cls)
    except Exception as e:              # unresolvable forward ref
        return f"{cls.__name__}: cannot resolve field types ({e})"
    for f in dataclasses.fields(cls):
        if not f.compare:
            continue
        why = _type_hash_problem(hints.get(f.name, typing.Any), seen)
        if why:
            return f"{cls.__name__}.{f.name}: {why}"
    return None


def check_static_types(extra: Sequence[type] = ()) -> List[Violation]:
    """Every registered key type (plus ``extra`` classes, for tests) is a
    frozen dataclass, hashable by value, whose compared fields are
    recursively hash-safe; an ``IDENTITY_KEYED`` type must still be a
    frozen dataclass (its instances are immutable)."""
    out: List[Violation] = []
    classes: List[Tuple[str, type, bool]] = []
    for (mod_name, cls_name), identity in (
            [(k, False) for k in STATIC_KEY_TYPES]
            + [(k, True) for k in IDENTITY_KEYED]):
        mod = __import__(mod_name, fromlist=[cls_name])
        classes.append((f"{mod_name}.{cls_name}", getattr(mod, cls_name),
                        identity))
    classes += [(f"{c.__module__}.{c.__name__}", c, False) for c in extra]
    for where, cls, identity in classes:
        if identity:
            params = getattr(cls, "__dataclass_params__", None)
            why = (None if params is not None and params.frozen
                   else f"{cls.__name__} is not a frozen dataclass")
        else:
            why = _dataclass_hash_problem(cls, set())
        if why:
            out.append(Violation(PASS, "static-type-unhashable", where,
                                 why))
    return out


# ---------------------------------------------------------------------------
# AST pass
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Scan(ast.NodeVisitor):
    """Import aliases, and every call with its enclosing function's
    qualified name (``Class.method``)."""

    def __init__(self):
        self.np_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        self.calls: List[Tuple[ast.Call, str]] = []
        self.local_trace_imports: List[ast.ImportFrom] = []
        self._scope: List[ast.AST] = []

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "numpy":
                self.np_aliases.add(a.asname or a.name)
            elif a.name == "torch":
                self.torch_aliases.add(a.asname or a.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.module.endswith("obs.trace") and any(
                isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                for s in self._scope):
            self.local_trace_imports.append(node)
        self.generic_visit(node)

    def _visit_scope(self, node) -> None:
        self._scope.append(node)
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope

    def visit_Call(self, node: ast.Call) -> None:
        self.calls.append((node, ".".join(s.name for s in self._scope)))
        self.generic_visit(node)


def _host_sync(scan: _Scan, node: ast.Call) -> Optional[str]:
    """What host sync ``node`` is, or None."""
    d = _dotted(node.func)
    if d:
        root, _, attr = d.rpartition(".")
        if root in scan.np_aliases and attr in _NP_SYNC:
            return (f"{d}() materialises a tensor on the host: keep it a "
                    "tensor, or move the call to host-side setup")
        if any(d == f"{t}.cuda.synchronize" for t in scan.torch_aliases):
            return f"{d}() waits for the card inside a step"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS and not node.args \
            and not node.keywords:
        return (f".{node.func.attr}() copies to the host and waits for the "
                "card inside a step")
    return None


def lint_source(src: str, filename: str, hot: bool = False,
                tracer_module: bool = False) -> List[Violation]:
    """Lint one module's source. ``hot`` scans it for host syncs (outside
    the functions ``ALLOWED_HOST_SYNCS`` names for ``filename``);
    ``tracer_module`` applies the DEP walker's tracer rule."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Violation(PASS, "syntax-error", filename, str(e))]
    scan = _Scan()
    scan.visit(tree)
    out: List[Violation] = []
    if hot:
        for node, func in scan.calls:
            why = _host_sync(scan, node)
            if why and (filename, func) not in ALLOWED_HOST_SYNCS:
                out.append(Violation(
                    PASS, "host-sync", f"{filename}:{node.lineno}",
                    f"{func or '<module>'}: {why}"))
    if tracer_module:
        for node, _ in scan.calls:
            d = _dotted(node.func) or ""
            if d.split(".")[-1] == "use_tracer":
                out.append(Violation(
                    PASS, "tracer-context-leak", f"{filename}:{node.lineno}",
                    "use_tracer() inside the DEP walker module: scoping a "
                    "tracer in the step bakes one recorder into a captured "
                    "graph; read active_tracer() instead"))
            elif d.endswith(".set") and "_active" in d.lower():
                out.append(Violation(
                    PASS, "tracer-context-leak", f"{filename}:{node.lineno}",
                    f"{d}() sets the tracer ContextVar inside the DEP "
                    "walker module"))
        for imp in scan.local_trace_imports:
            out.append(Violation(
                PASS, "tracer-context-leak", f"{filename}:{imp.lineno}",
                "function-local import of repro_torch.obs.trace: the walker "
                "binds active_tracer at module level"))
        bound = any(isinstance(s, ast.ImportFrom) and s.module
                    and s.module.endswith("obs.trace")
                    and any(a.name == "active_tracer" for a in s.names)
                    for s in tree.body)
        if not bound:
            out.append(Violation(
                PASS, "tracer-context-leak", filename,
                "active_tracer is not bound at module level"))
    return out


def lint_tree(root: Optional[str] = None) -> List[Violation]:
    """Lint every module under ``src/repro_torch`` (default: the package
    this file lives in); every hot and tracer module must exist."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[Violation] = []
    seen = set()
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            seen.add(rel)
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
            out += lint_source(src, rel, hot=rel in HOT_MODULES,
                               tracer_module=rel in TRACER_MODULES)
    for rel in sorted(set(HOT_MODULES + TRACER_MODULES) - seen):
        out.append(Violation(PASS, "hot-module-missing", rel,
                             "a hot module named by the lint is gone"))
    return out


def run(fast: bool = False, log=None) -> Tuple[List[Violation], Dict]:
    out = lint_tree()
    out += check_static_types()
    if log is not None:
        log(f"capturelint: {len(out)} violations")
    return out, {"fast": fast, "hot_modules": len(HOT_MODULES)}
