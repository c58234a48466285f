"""Profiling and run logging.

Port of ``mme_tpu/utils/profiling.py``: ``profile_trace`` (a
``torch.profiler`` window written as a Chrome trace where JAX writes a
``jax.profiler`` trace), ``StepTimer`` and ``RunLogger``, the JSONL logger
with wandb-style keys and its optional ``MME_WANDB=1`` mirror.

The program's own spans and counters (``span``, ``count``) are recorded
while a ``torch.profiler`` session records on the calling thread,
``profile_trace``'s or any other, and cost one flag test otherwise. A span
is then a ``record_function`` range, so it sits in the profiler's timeline
beside the kernels it launched, and a record in ``STORE``, stamped on the
profiler's clock (``time.time_ns``, the Unix clock kineto converts its
stamps to) with its parent span and thread. ``count`` adds to the
innermost open span of its thread; ``host_syncs`` is counted by the
program itself: every CUDA call inside a span that makes the host wait for
the device (a pageable host-to-device copy, ``.cpu()``, ``.item()``,
``float()`` of a device tensor, ``nonzero``), as CUDA's sync debug mode
reports it. That mode does not report an explicit
``torch.cuda.synchronize()`` or an event's ``synchronize()``: the program
calls neither inside a span.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the host and, where there is one, the CUDA device into
    ``log_dir/trace.json`` (Chrome trace format) when ``log_dir`` is set,
    the program's spans among the host's events; no-op otherwise."""
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


# ---- spans and counters ---------------------------------------------------

# what CUDA's sync debug mode warns on each synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"
_MODE_NOTICE = "Synchronization debug mode is a prototype"
HOST_SYNCS = "host_syncs"

_tracing = torch.autograd._profiler_enabled


@dataclasses.dataclass
class SpanRecord:
    """One span: ``parent`` is the ``id`` of the span that encloses it on
    its ``thread`` (None at the top); stamps in Unix ns, ``end_ns`` 0
    while the span is open."""

    id: int
    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class SpanStore:
    """The newest ``capacity`` span records in the order they opened;
    ``dropped`` counts the older ones the ring let go."""

    def __init__(self, capacity: int = 1 << 16):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.dropped = 0

    def open(self, name: str, parent: Optional[int]) -> SpanRecord:
        with self._lock:
            rec = SpanRecord(next(self._ids), name, parent,
                             threading.get_ident(), time.time_ns())
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
        return rec

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


STORE = SpanStore()
_open = threading.local()     # .stack: the thread's open span records


def _stack() -> List[SpanRecord]:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _SyncWatch:
    """While any span is open, CUDA's sync debug mode warns on each
    synchronising call; the warning is counted as ``host_syncs`` on the
    innermost open span of the thread that made the call and shown to no
    one. Everything is put back when the last span closes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._mode = False
        self._catch: Optional[warnings.catch_warnings] = None
        self._shown = None

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if str(message).startswith(SYNC_WARNING):
            count(HOST_SYNCS)
        else:
            self._shown(message, category, filename, lineno, file, line)

    def enter(self) -> None:
        with self._lock:
            self._depth += 1
            if self._depth > 1:
                return
            self._catch = warnings.catch_warnings()
            self._catch.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            # said once, when the mode is first set
            warnings.filterwarnings("ignore", message=_MODE_NOTICE)
            self._shown, warnings.showwarning = warnings.showwarning, \
                self._show
            # a mode the caller set (warn or error) is left as it is
            self._mode = (torch.cuda.is_initialized()
                          and torch.cuda.get_sync_debug_mode() == 0)
            if self._mode:
                torch.cuda.set_sync_debug_mode("warn")

    def exit(self) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth > 0:
                return
            if self._mode:
                torch.cuda.set_sync_debug_mode("default")
            self._catch.__exit__(None, None, None)
            self._catch = None


_SYNCS = _SyncWatch()


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> SpanRecord:
        stack = _stack()
        self.rec = STORE.open(self.name, stack[-1].id if stack else None)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack.append(self.rec)
        _SYNCS.enter()
        return self.rec

    def __exit__(self, *exc) -> bool:
        _SYNCS.exit()
        _stack().pop()
        self.range.__exit__(None, None, None)
        self.rec.end_ns = time.time_ns()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """``with span("mme.layer.part"):`` records the block while a
    ``torch.profiler`` session records (module docstring); otherwise a
    shared no-op context. Never synchronises, records no CUDA event."""
    if not _tracing():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread; nothing where no span is open."""
    stack = getattr(_open, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


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
