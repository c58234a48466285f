"""Profiling and run logging.

Port of ``mme_tpu/utils/profiling.py``: ``profile_trace`` (a
``torch.profiler`` window written as a Chrome trace where JAX writes a
``jax.profiler`` trace), ``StepTimer`` and ``RunLogger``, the JSONL logger
with wandb-style keys and its optional ``MME_WANDB=1`` mirror.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the host and, where there is one, the CUDA device into
    ``log_dir/trace.json`` (Chrome trace format) when ``log_dir`` is set
    (``MME_PROFILE_DIR`` in the CLIs); no-op otherwise."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling steps/sec over the last ``window`` steps, host clock."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)


class RunLogger:
    """JSONL logger of wandb-style keyed dicts, one file per run
    (``run_dir/{name}.jsonl``). With ``MME_WANDB=1`` and wandb importable
    and configured, every dict is mirrored to ``wandb.log``; a wandb that
    is missing or fails leaves the JSONL file alone, with a notice."""

    def __init__(self, run_dir: str, name: str = "metrics"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"{name}.jsonl")
        self._step = 0
        self._wandb = None
        if os.environ.get("MME_WANDB") == "1":
            try:
                import wandb
                self._wandb = wandb.init(
                    project=os.environ.get("MME_WANDB_PROJECT", "mme_tpu"),
                    name=(os.environ.get("MME_WANDB_NAME")
                          or os.path.basename(os.path.abspath(run_dir))),
                    dir=run_dir, reinit=True)
            except Exception as e:  # noqa: BLE001 — any wandb failure
                print(f"MME_WANDB=1 but wandb unavailable ({e!r}); "
                      "logging JSONL only", flush=True)

    def log(self, metrics: Dict[str, Any]) -> None:
        rec = {"_step": self._step, "_time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log(
                    {k: v for k, v in rec.items() if not k.startswith("_")},
                    step=self._step)
            except Exception as e:  # noqa: BLE001
                print(f"wandb.log failed ({e!r}); disabling mirror",
                      flush=True)
                self._wandb = None
        self._step += 1

    def finish(self) -> None:
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception as e:  # noqa: BLE001
                print(f"wandb.finish failed ({e!r})", flush=True)
            self._wandb = None
