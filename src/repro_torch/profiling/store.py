"""The port's counterpart of ``repro.profiling.store``: the same store,
schema and files; only ``ProfileKey.for_host`` differs, reading the
device kind from PyTorch (``torch.cuda.get_device_name``, or "cpu") and
the mesh shape from a ``core.dep.DepGroups`` (data x expert ranks).

Versioned on-disk store for calibrated ``HardwareProfile``s.

Calibration (``repro_torch.profiling.microbench.calibrate``) is a
measure+fit that takes seconds on a card; it should run once per host,
not once per process. The ``ProfileStore`` persists each fitted
profile as one JSON file keyed by (device kind, mesh shape, dtype) plus a
human-chosen name, with enough metadata to judge staleness:

  * ``schema``      — bumped when the on-disk layout changes; files with
                      an unknown schema are ignored, never misparsed;
  * ``created_at``  — unix seconds; ``StoredProfile.age_s`` /
                      ``is_stale(max_age_s)`` gate re-calibration;
  * ``fit_r2``      — the per-primitive fit quality at calibration time;
  * ``comm_proxy``  — whether the comm fit came from the on-device copy
                      proxy rather than a live all_to_all.

JSON floats serialize via ``repr`` which round-trips IEEE doubles
exactly, so a load returns the profile bit-for-bit — plans solved from a
loaded profile equal plans solved from the freshly fitted one.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.perf_model import HardwareProfile

SCHEMA_VERSION = 1

DEFAULT_STORE_DIR = os.environ.get("REPRO_PROFILE_DIR", ".repro-profiles")


def _mesh_shape_of(groups) -> Tuple[int, ...]:
    """(data ranks, expert ranks) of a ``DepGroups``; (1,) without one."""
    if groups is None:
        return (1,)
    return (groups.world_size // groups.expert_size, groups.expert_size)


def dtype_name(dtype) -> str:
    """The name ("float32", "bfloat16", ...) of a ``torch.dtype``, or a
    name as it is."""
    return str(dtype).replace("torch.", "")


@dataclass(frozen=True)
class ProfileKey:
    """What a calibration is valid for: the device kind it ran on, the
    expert layout whose collectives it measured, and the activation
    dtype."""

    device_kind: str
    mesh_shape: Tuple[int, ...]
    dtype: str

    @staticmethod
    def for_host(groups=None, dtype="float32",
                 device: DeviceLike = None) -> "ProfileKey":
        """The key of ``device`` (None: the card; raises without one)
        under ``groups`` at ``dtype`` (a ``torch.dtype`` or its name)."""
        dev = resolve_device(device)
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return ProfileKey(device_kind=kind, mesh_shape=_mesh_shape_of(groups),
                          dtype=dtype_name(dtype))

    def slug(self) -> str:
        mesh = "x".join(str(d) for d in self.mesh_shape)
        kind = "".join(c if c.isalnum() else "-" for c in self.device_kind)
        return f"{kind}_{mesh}_{self.dtype}".lower()

    def as_dict(self) -> dict:
        return {"device_kind": self.device_kind,
                "mesh_shape": list(self.mesh_shape), "dtype": self.dtype}

    @staticmethod
    def from_dict(d: dict) -> "ProfileKey":
        return ProfileKey(device_kind=str(d["device_kind"]),
                          mesh_shape=tuple(int(x) for x in d["mesh_shape"]),
                          dtype=str(d["dtype"]))


@dataclass
class StoredProfile:
    name: str
    profile: HardwareProfile
    key: ProfileKey
    fit_r2: Dict[str, float] = field(default_factory=dict)
    samples: Dict[str, Tuple[List[float], List[float]]] = \
        field(default_factory=dict)
    comm_proxy: bool = False
    created_at: float = 0.0
    schema: int = SCHEMA_VERSION

    @property
    def age_s(self) -> float:
        return max(time.time() - self.created_at, 0.0)

    def is_stale(self, max_age_s: float) -> bool:
        return self.age_s > max_age_s

    def as_dict(self) -> dict:
        return {
            "schema": self.schema,
            "name": self.name,
            "profile": self.profile.as_dict(),
            "key": self.key.as_dict(),
            "fit_r2": dict(self.fit_r2),
            "samples": {k: [list(xs), list(ts)]
                        for k, (xs, ts) in self.samples.items()},
            "comm_proxy": self.comm_proxy,
            "created_at": self.created_at,
        }

    @staticmethod
    def from_dict(d: dict) -> "StoredProfile":
        return StoredProfile(
            name=str(d["name"]),
            profile=HardwareProfile.from_dict(d["profile"]),
            key=ProfileKey.from_dict(d["key"]),
            fit_r2={k: float(v) for k, v in d.get("fit_r2", {}).items()},
            samples={k: (list(map(float, xs)), list(map(float, ts)))
                     for k, (xs, ts) in d.get("samples", {}).items()},
            comm_proxy=bool(d.get("comm_proxy", False)),
            created_at=float(d.get("created_at", 0.0)),
            schema=int(d.get("schema", 0)),
        )


class ProfileStore:
    """One JSON file per stored profile under ``root``."""

    def __init__(self, root: str = DEFAULT_STORE_DIR):
        self.root = Path(root).expanduser()

    def _path(self, name: str) -> Path:
        safe = "".join(c if (c.isalnum() or c in "._-") else "-"
                       for c in name)
        return self.root / f"{safe}.json"

    # -- write ----------------------------------------------------------
    def put(self, profile: HardwareProfile, key: ProfileKey, *,
            name: Optional[str] = None,
            fit_r2: Optional[Dict[str, float]] = None,
            samples: Optional[Dict[str, Tuple[List[float], List[float]]]]
            = None, comm_proxy: bool = False) -> StoredProfile:
        entry = StoredProfile(name=name or key.slug(), profile=profile,
                              key=key, fit_r2=dict(fit_r2 or {}),
                              samples=dict(samples or {}),
                              comm_proxy=comm_proxy,
                              created_at=time.time())
        self.root.mkdir(parents=True, exist_ok=True)
        path = self._path(entry.name)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(entry.as_dict(), indent=1))
        os.replace(tmp, path)
        return entry

    def put_calibration(self, result, key: ProfileKey, *,
                        name: Optional[str] = None) -> StoredProfile:
        """Persist a ``microbench.CalibrationResult``."""
        return self.put(result.profile, key, name=name,
                        fit_r2=result.fit_r2,
                        samples={k: v.as_xt()
                                 for k, v in result.samples.items()},
                        comm_proxy=result.comm_is_proxy)

    # -- read -----------------------------------------------------------
    def names(self) -> List[str]:
        if not self.root.is_dir():
            return []
        out = []
        for p in sorted(self.root.glob("*.json")):
            try:
                d = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if int(d.get("schema", -1)) == SCHEMA_VERSION:
                out.append(str(d["name"]))
        return out

    def get(self, name: str) -> StoredProfile:
        path = self._path(name)
        if not path.is_file():
            raise KeyError(f"no stored profile {name!r} under {self.root} "
                           f"(have: {self.names()})")
        d = json.loads(path.read_text())
        if int(d.get("schema", -1)) != SCHEMA_VERSION:
            raise KeyError(f"stored profile {name!r} has schema "
                           f"{d.get('schema')!r}, expected {SCHEMA_VERSION} "
                           "— recalibrate")
        return StoredProfile.from_dict(d)

    def get_for_key(self, key: ProfileKey) -> StoredProfile:
        """Newest stored profile calibrated under exactly ``key``."""
        best: Optional[StoredProfile] = None
        for name in self.names():
            entry = self.get(name)
            if entry.key == key and (best is None
                                     or entry.created_at > best.created_at):
                best = entry
        if best is None:
            raise KeyError(f"no stored profile for {key} under {self.root}")
        return best

    def has(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def load_profile(self, name: str) -> HardwareProfile:
        return self.get(name).profile

    def __len__(self) -> int:
        return len(self.names())

    def __repr__(self) -> str:
        return f"ProfileStore(root={str(self.root)!r}, n={len(self)})"
