"""Patience-based early stopping with an in-memory best state.

Port of ``mme_tpu/train/early_stopping.py``: tracks the best validation
metric, keeps a host copy of the best state (optionally pickled to
``save_path``) and hands it back on request. Where JAX takes the copy with
``jax.device_get``, the port copies every tensor of the state
(``.detach().cpu().clone()``), so later in-place updates of the parameters
cannot reach it. The main loop's own patience counter lives in
``train/loop.py``.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional

import torch


def host_copy(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor in it copied to the host;
    dataclasses, lists, tuples and dicts are rebuilt around the copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: host_copy(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    return obj


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 0.0,
                 mode: str = "min", save_path: Optional[str] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.save_path = save_path
        self.counter = 0
        self.best_metric: Optional[float] = None
        self.best_state: Any = None
        self.should_stop = False

    def _improved(self, metric: float) -> bool:
        if self.best_metric is None:
            return True
        if self.mode == "min":
            return metric < self.best_metric - self.min_delta
        return metric > self.best_metric + self.min_delta

    def __call__(self, metric: float, state: Any) -> bool:
        """Update with a new validation metric; True once training should
        stop. An improvement keeps a host copy of ``state``."""
        if self._improved(metric):
            self.best_metric = metric
            self.best_state = host_copy(state)
            self.counter = 0
            if self.save_path:
                with open(self.save_path, "wb") as f:
                    pickle.dump(self.best_state, f)
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def restore_best(self, fallback: Any = None) -> Any:
        if self.best_state is not None:
            return self.best_state
        if self.save_path:
            try:
                with open(self.save_path, "rb") as f:
                    return pickle.load(f)
            except OSError:
                pass
        return fallback
