"""Checkpoint manager: best-checkpoint saves, the preemption slot, orphan GC.

Port of ``mme_tpu/train/checkpoint.py`` on a torch format. The layout and
its semantics are JAX's: every best save goes to a fresh
``best_<n>_<host>-<pid>`` directory, ``best_meta.json`` points at the
durable one and flips only at :meth:`CheckpointManager.wait`, so a crash
mid-write leaves the previous best whole; ``latest`` is the preemption slot
(``latest_meta.json``); dead-pid orphans are collected at start-up.

A directory holds one ``state.pt``, the ``TrainState`` as plain dicts,
lists, ints and tensors (:func:`state_payload`): ``step``, the parameters
by name, ``AdamWState``'s ``count``, ``seed``, ``mu``, ``nu``, ``nu_row``
and ``nu_col`` (entries may be None), ``accum_grads`` and ``accum_count``;
and for a state with ``buffers`` (a BatchNorm model's running statistics)
the buffers by name, so a restore pairs the weights with the statistics of
the same step. It is read with ``torch.load(weights_only=True)``. Reading
a JAX (orbax) checkpoint is not supported.

The port's state is updated in place: the optimizer writes the model's own
parameters and the moments. So a save first copies every tensor on its
device, on the current stream, before it returns; an asynchronous save
(``MME_ASYNC_CKPT``, on by default) then moves the copy to the host on a
side stream and writes it from a thread while training goes on. A restore
copies into the target state's existing tensors, so the model trains the
restored weights. A failed write raises at the next :meth:`wait`.

Two choices set the write's speed (``time_checkpoint.py`` times them). The
copy to the host goes into pinned tensors, which PyTorch's caching host
allocator keeps for the next save: a copy into pageable memory is slower
and slows the training thread's kernel launches while it runs. The zip
records are written without their CRC-32, whose computation takes most of
``torch.save``'s time; the process-wide switch is off only while a
checkpoint is written.

In a multi-process run (``parallel/distributed.py``) the ranks share the
directory and hold the same state: only rank 0 writes (best saves, the
latest slot, the meta files), and a restore first lets rank 0 publish its
write, then waits at a barrier, then reads on every rank.

Under tensor or expert parallelism a rank holds blocks of the cut leaves
(``parallel/sharding_rules.py``). A checkpoint holds whole tensors, as
JAX's orbax writes global arrays: every rank takes part in gathering the
blocks of the parameters, their moments and the accumulation buffer, and
rank 0 writes. A restore reads the whole tensors and copies each rank's
block of a cut leaf into it, so a checkpoint written at mp=2 restores at
mp=1 and the reverse.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.serialization import config as serialization_config

from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.mesh import barrier
from mme_tpu_torch.parallel.sharding_rules import full_tensor, shard_of
from mme_tpu_torch.train.steps import TrainState

STATE_FILE = "state.pt"


def _process_count() -> int:
    """Processes of the run, for the multi-host GC guard."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _safe_hostname() -> str:
    """Filesystem-safe hostname for save-dir names, so the orphan GC can
    tell this machine's dead pids from another machine's live ones on a
    shared directory. '-' separates host and pid, so only alphanumerics are
    kept, and a short hash of the raw name keeps two hosts that sanitise
    alike apart."""
    raw = socket.gethostname()
    safe = re.sub(r"[^A-Za-z0-9]", "", raw) or "host"
    return safe + hashlib.sha1(raw.encode()).hexdigest()[:8]


def _names(state: TrainState) -> List[str]:
    if state.names is not None:
        return list(state.names)
    return [str(i) for i in range(len(state.params))]


def _opt_list(x: Optional[List[Any]]) -> Optional[List[Any]]:
    return None if x is None else list(x)


def _whole(xs: Optional[List[Any]], shards) -> Optional[List[Any]]:
    if xs is None:
        return None
    return [None if x is None else full_tensor(x, s)
            for x, s in zip(xs, shards)]


def state_payload(state: TrainState) -> Dict[str, Any]:
    """The state as plain dicts, lists, ints and its own tensors (a cut
    leaf's gathered whole: a collective every rank of its axis calls); the
    ``buffers`` entry only for a state that has buffers."""
    o = state.opt_state
    shards = [shard_of(p) for p in state.params]
    payload = {
        "step": int(state.step),
        "params": dict(zip(_names(state), _whole(
            [p.detach() for p in state.params], shards))),
        "opt_state": {"count": int(o.count), "seed": int(o.seed),
                      "mu": _whole(o.mu, shards), "nu": _whole(o.nu, shards),
                      "nu_row": _opt_list(o.nu_row),
                      "nu_col": _opt_list(o.nu_col)},
        "accum_grads": _whole(state.accum_grads, shards),
        "accum_count": int(state.accum_count),
    }
    if state.buffers is not None:
        payload["buffers"] = {k: b.detach() for k, b in state.buffers.items()}
    return payload


def _map_tensors(obj: Any, fn: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_tensors(v, fn) for v in obj]
    return obj


def _cuda_device(obj: Any) -> Optional[torch.device]:
    found: List[torch.device] = []
    _map_tensors(obj, lambda t: found.append(t.device) or t)
    return next((d for d in found if d.type == "cuda"), None)


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str,
               shard=None) -> None:
    if shard is not None:
        src = shard.local(src)     # this rank's block of the whole tensor
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(
            f"checkpoint {what}: {tuple(src.shape)} {src.dtype} does not fit "
            f"the target's {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _copy_list(dst: Optional[List[Optional[torch.Tensor]]],
               src: Optional[List[Optional[torch.Tensor]]], what: str,
               shards=None) -> None:
    if (dst is None) != (src is None) or (
            dst is not None and len(dst) != len(src)):
        raise ValueError(f"checkpoint {what} does not match the target's")
    for i, (d, s) in enumerate(zip(dst or [], src or [])):
        if (d is None) != (s is None):
            raise ValueError(f"checkpoint {what}[{i}] does not match the "
                             "target's")
        if d is not None:
            _copy_into(d, s, f"{what}[{i}]",
                       None if shards is None else shards[i])


def load_payload(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Copy a payload into ``state``'s own tensors (parameters and moments
    keep their storage) and set its counters; returns ``state``. The
    accumulation buffer follows the payload: None strips it."""
    names = _names(state)
    saved = payload["params"]
    if list(saved) != names:
        raise ValueError("checkpoint parameters differ from the target's: "
                         f"{len(saved)} saved, {len(names)} in the target")
    buffers = payload.get("buffers")
    if (buffers is None) != (state.buffers is None) or (
            buffers is not None and list(buffers) != list(state.buffers)):
        raise ValueError("checkpoint buffers differ from the target's")
    o, so = state.opt_state, payload["opt_state"]
    shards = [shard_of(p) for p in state.params]
    with torch.no_grad():
        for p, name, sh in zip(state.params, names, shards):
            _copy_into(p, saved[name], f"parameter {name}", sh)
        for name, b in (state.buffers or {}).items():
            _copy_into(b, buffers[name], f"buffer {name}")
        for key in ("mu", "nu"):
            _copy_list(getattr(o, key), so[key], key, shards)
        for key in ("nu_row", "nu_col"):
            _copy_list(getattr(o, key), so[key], key)
        accum = payload["accum_grads"]
        if accum is None:
            state.accum_grads = None
        elif state.accum_grads is None:
            state.accum_grads = [
                (a if sh is None else sh.local(a)).to(p.device).clone()
                for a, p, sh in zip(accum, state.params, shards)]
        else:
            _copy_list(state.accum_grads, accum, "accum_grads", shards)
    o.count, o.seed = int(so["count"]), int(so["seed"])
    state.step = int(payload["step"])
    state.accum_count = int(payload["accum_count"])
    return state


def _snapshot(state: TrainState
              ) -> Tuple[Dict[str, Any], Optional[torch.cuda.Event]]:
    """A copy of every tensor of the state on its own device, enqueued on
    the current stream before the next step can change the state, and for
    a CUDA state the event that marks the copy done."""
    payload = _map_tensors(state_payload(state), lambda t: t.clone())
    dev = _cuda_device(payload)
    if dev is None:
        return payload, None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return payload, done


def _gather_only(state: TrainState) -> None:
    """A rank that does not write still takes part in gathering the cut
    leaves rank 0 writes."""
    if any(shard_of(p) is not None for p in state.params):
        state_payload(state)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _write(payload: Dict[str, Any], done: Optional[torch.cuda.Event],
           directory: str) -> None:
    """Move a snapshot to the host (a CUDA one into pinned memory on a side
    stream, once ``done`` has passed) and write it."""
    dev = _cuda_device(payload)
    if dev is not None:
        torch.cuda.set_device(dev)
        side = torch.cuda.Stream(dev)
        side.wait_event(done)
        with torch.cuda.stream(side):
            payload = _map_tensors(payload, _pinned_copy)
        side.synchronize()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    crc = serialization_config.save.compute_crc32
    serialization_config.save.compute_crc32 = False
    try:
        torch.save(payload, path + ".tmp")
    finally:
        serialization_config.save.compute_crc32 = crc
    os.replace(path + ".tmp", path)


def _load(directory: str) -> Dict[str, Any]:
    return torch.load(os.path.join(directory, STATE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)


class CheckpointManager:
    def __init__(self, directory: str, use_async: Optional[bool] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if use_async is None:
            use_async = os.environ.get("MME_ASYNC_CKPT", "1") != "0"
        self._async = use_async
        self._counter = 0
        self._pending_meta: Optional[Dict[str, Any]] = None
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # rank 0 writes; another rank only notes that a best was saved
        self._writes = distributed.is_writer()
        self._noted_best = False
        self._gc_orphans()

    # foreign-host dirs must be this stale (newest mtime under the tree)
    # before GC touches them: a foreign owner's finished but unpublished
    # best dir stops getting mtime bumps long before its pointer flips
    _GC_STALE_S = 24 * 3600.0

    def _gc_orphans(self) -> None:
        """Remove ``best_<n>_<host>-<pid>`` dirs that ``best_meta.json`` does
        not reference and whose owner is dead: a process killed between
        ``save_best`` and the next :meth:`wait` leaves its fresh dir behind.
        The ``os.kill(pid, 0)`` probe decides this host's dirs and legacy
        ``best_<n>_<pid>`` ones (a live pid or EPERM keeps the dir); another
        host's dirs go only once nothing under them was written for
        ``_GC_STALE_S`` seconds. Nothing is collected in a multi-process
        run, and the referenced dir never."""
        if _process_count() > 1:
            return
        keep = os.path.basename(self.best_path)
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        now = time.time()
        for name in entries:
            if not name.startswith("best_") or name == keep:
                continue
            token = name.rsplit("_", 1)[-1]
            host, _, pid_s = token.rpartition("-")
            try:
                pid = int(pid_s)
            except ValueError:
                continue
            path = os.path.join(self.directory, name)
            if not os.path.isdir(path):
                continue
            if host == _safe_hostname() or host == "":
                try:
                    os.kill(pid, 0)  # existence probe, no signal sent
                    continue         # owner alive → in flight, keep
                except ProcessLookupError:
                    pass             # owner dead → orphan
                except OSError:
                    continue         # e.g. EPERM: someone's pid, keep
            else:
                # another machine: only age proves death; stop the walk at
                # the first fresh file
                try:
                    cutoff = now - self._GC_STALE_S
                    fresh = os.path.getmtime(path) >= cutoff
                    if not fresh:
                        for r, _, fs in os.walk(path):
                            if any(os.path.getmtime(os.path.join(r, f))
                                   >= cutoff for f in fs):
                                fresh = True
                                break
                except OSError:
                    continue
                if fresh:
                    continue
            shutil.rmtree(path, ignore_errors=True)

    @property
    def best_path(self) -> str:
        """The current best data dir, as ``best_meta.json`` names it."""
        meta_path = os.path.join(self.directory, "best_meta.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    rel = json.load(f).get("_data", "best")
                return os.path.join(self.directory, rel)
            except (OSError, ValueError):
                pass
        return os.path.join(self.directory, "best")

    def _run_writer(self, payload: Dict[str, Any],
                    done: Optional[torch.cuda.Event], directory: str) -> None:
        try:
            _write(payload, done, directory)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def wait(self) -> None:
        """Barrier on an in-flight save. Once its data is durable, publish
        its meta; a failed write raises here and publishes nothing."""
        if not self._writes:
            return
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            failed = os.path.join(self.directory, self._pending_meta["_data"])
            self._pending_meta = None
            shutil.rmtree(failed, ignore_errors=True)
            raise RuntimeError("checkpoint write failed") from err
        if self._pending_meta is not None:
            meta = self._pending_meta
            self._pending_meta = None
            old = self.best_path
            with open(os.path.join(self.directory, "best_meta.json"),
                      "w") as f:
                json.dump(meta, f)
            new = os.path.join(self.directory, meta["_data"])
            if os.path.abspath(old) != os.path.abspath(new) and \
                    os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)

    def save_best(self, state: TrainState, meta: Dict[str, Any]) -> None:
        """Save a new best. Returns once the state's tensors are copied on
        their device; with async saves the host copy and the write overlap
        the next steps, and the pointer flips at the next :meth:`wait`."""
        if not self._writes:
            self._noted_best = True
            _gather_only(state)
            return
        self.wait()  # the previous write lands and its meta publishes
        name = None
        while name is None or os.path.exists(
                os.path.join(self.directory, name)):
            self._counter += 1
            name = f"best_{self._counter}_{_safe_hostname()}-{os.getpid()}"
        payload, done = _snapshot(state)
        directory = os.path.join(self.directory, name)
        os.makedirs(directory)       # the name is taken before save returns
        self._pending_meta = dict(meta, _data=name)
        if self._async:
            self._writer = threading.Thread(
                target=self._run_writer, args=(payload, done, directory),
                name="mme-checkpoint")
            self._writer.start()
        else:
            self._run_writer(payload, done, directory)
            self.wait()  # blocking mode publishes at once

    def has_best(self) -> bool:
        return (self._pending_meta is not None or self._noted_best or
                os.path.exists(os.path.join(self.directory,
                                            "best_meta.json")))

    # ---- "latest": the state the loop held when told to stop (SIGTERM) ----

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latest")

    def save_latest(self, state: TrainState, meta: Dict[str, Any]) -> None:
        """Write the state into the latest slot, durable before return."""
        if not self._writes:
            _gather_only(state)
            return
        self.wait()
        _write(*_snapshot(state), self.latest_path)
        with open(os.path.join(self.directory, "latest_meta.json"),
                  "w") as f:
            json.dump(meta, f)

    def has_latest(self) -> bool:
        return os.path.exists(os.path.join(self.directory,
                                           "latest_meta.json"))

    def clear_latest(self) -> None:
        """Remove the preemption slot, so a later resume never prefers a
        stale preempted state to the newer best."""
        if not self._writes:
            return
        meta = os.path.join(self.directory, "latest_meta.json")
        if os.path.exists(meta):
            os.remove(meta)
        shutil.rmtree(self.latest_path, ignore_errors=True)

    def _published(self) -> None:
        """Rank 0's write is durable and its meta published, on every
        rank."""
        self.wait()
        barrier()

    def restore_latest(self, target_state: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
        self._published()
        state = load_payload(target_state, _load(self.latest_path))
        with open(os.path.join(self.directory, "latest_meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def restore_best(self, target_state: TrainState
                     ) -> Tuple[TrainState, Dict[str, Any]]:
        """Copy the best state into ``target_state``'s tensors."""
        self._published()  # the write about to be read must be durable
        state = load_payload(target_state, _load(self.best_path))
        with open(os.path.join(self.directory, "best_meta.json")) as f:
            meta = json.load(f)
        meta.pop("_data", None)
        return state, meta
