"""Cells and their files by name, the run's context, the import guard and
the result."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may never be loaded in a run, compared whole
# (the measured package's name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mme_tpu")


def load(kind: str, name: str) -> Dict[str, Any]:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as fh:
        return json.load(fh)


def plugin(kind: str, name: str) -> ModuleType:
    """The code file ``benchmark/<kind>/<name>.py``, loaded once: a loop
    (``loops/``, named by a mix's ``loop``), a model (``models/``, named by
    a configuration's ``model``) or a per-layer metric's reader
    (``metrics/``)."""
    key = f"bench_{kind}.{name}"
    if key not in sys.modules:
        path = os.path.join(BENCH_DIR, kind, f"{name}.py")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def model(config: Dict[str, Any]) -> ModuleType:
    """The file of the configuration's model: its plain reference, its
    FLOP count and how the program builds it."""
    return plugin("models", config["model"])


def cell(name: str) -> Dict[str, Any]:
    """A cell's file with its configuration and its traffic merged in:
    ``config``, ``traffic`` (the mix's parameters, the cell's ``params``
    over them) and ``limits``."""
    w = load("workloads", name)
    return {"name": name, "config": load("configs", w["config"]),
            "traffic": {**load("traffic", w["traffic"]),
                        **w.get("params", {})},
            "limits": w.get("limits", {}), "chips": w.get("chips", 1)}


def forbidden_loaded() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell["config"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell["traffic"]


@dataclasses.dataclass
class Result:
    """What a loop hands back: end-to-end metrics (name → (value,
    unit)), attempted and failed units, the numbers compared (name,
    value, limit), the peak memory, and for a traced run what the
    per-layer readers read."""

    metrics: Dict[str, Tuple[float, str]]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    layer: Optional[Dict[str, Any]] = None
    notes: Optional[Dict[str, Any]] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def limit(run: Run, name: str) -> float:
    """The cell's limit on a compared number (NaN, never met, where the
    cell has none)."""
    return float(run.cell["limits"].get(name, float("nan")))
