"""A pool of ranks: worker processes joined into one process group, each
running the calls it is sent.

``RankPool(world)`` starts ``world`` Python processes through the env
contract of ``parallel/distributed.py`` (``MME_COORDINATOR`` on a free
local port, ``MME_NUM_PROCESSES``, ``MME_PROCESS_ID``; ``MME_DIST_BACKEND``
when given). :meth:`RankPool.run` sends every rank the same call, a target
``"package.module:function"`` or ``"path/to/file.py:function"`` with
picklable arguments, and returns the ranks' results in rank order. Every
call has a time limit: a rank that raises, dies or does not answer in time
stops the whole pool (the others may be waiting in a collective) and the
call raises with the ranks' tracebacks. The tests use one pool per file;
``chip_smoke.py`` uses one for its two-rank phase.

Calls and results travel over a pipe pair per rank (inherited descriptors,
``multiprocessing.connection.Connection``), so the ranks' standard output
stays theirs. Run a worker by hand with ``python -m
mme_tpu_torch.parallel.launch <read fd> <write fd>``.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` ranks on ``device`` (``cpu``, or ``cuda`` for
    ``cuda:{rank % device_count}``), ``env`` added to each worker's
    environment. Use as a context manager or call :meth:`close`."""

    def __init__(self, world: int, device: str = "cpu",
                 env: Optional[Dict[str, str]] = None,
                 timeout_s: float = 120.0):
        self.world = world
        self.timeout_s = timeout_s
        port = free_port()
        self._procs: List[subprocess.Popen] = []
        self._send: List[Connection] = []
        self._recv: List[Connection] = []
        base = dict(os.environ)
        base.update(env or {})
        base["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in base.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        for r in range(world):
            to_child_r, to_child_w = os.pipe()
            to_parent_r, to_parent_w = os.pipe()
            wenv = dict(base, MME_COORDINATOR=f"127.0.0.1:{port}",
                        MME_NUM_PROCESSES=str(world),
                        MME_PROCESS_ID=str(r), MME_POOL_DEVICE=device)
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", "mme_tpu_torch.parallel.launch",
                 str(to_child_r), str(to_parent_w)],
                env=wenv, pass_fds=(to_child_r, to_parent_w)))
            os.close(to_child_r)
            os.close(to_parent_w)
            self._send.append(Connection(to_child_w, readable=False))
            self._recv.append(Connection(to_parent_r, writable=False))
        # the ranks answer once they have joined the group
        self._collect("joining the process group")

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _collect(self, what: str, timeout_s: Optional[float] = None
                 ) -> List[Any]:
        deadline = time.time() + (timeout_s or self.timeout_s)
        results, errors = [None] * self.world, []
        for r, conn in enumerate(self._recv):
            try:
                ready = conn.poll(max(deadline - time.time(), 0.0))
            except (EOFError, OSError):
                ready = True
            if not ready:
                errors.append(f"rank {r}: no answer within the time limit "
                              f"({what})")
                continue
            try:
                status, value = conn.recv()
            except (EOFError, OSError):
                code = self._procs[r].poll()
                errors.append(f"rank {r}: exited (code {code}) while "
                              f"{what}")
                continue
            if status == "ok":
                results[r] = value
            else:
                errors.append(f"rank {r} raised while {what}:\n{value}")
        if errors:
            self.close(kill=True)
            raise RuntimeError("rank pool failed:\n" + "\n".join(errors))
        return results

    def run(self, target: str, *args: Any, timeout_s: Optional[float] = None,
            **kwargs: Any) -> List[Any]:
        """Every rank calls ``target(*args, **kwargs)``; the results in
        rank order."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for conn in self._send:
            conn.send((target, args, kwargs))
        return self._collect(f"running {target}", timeout_s)

    def close(self, kill: bool = False) -> None:
        """Stop the workers (``kill``: at once) and wait for them."""
        for conn in self._send:
            try:
                if not kill:
                    conn.send(None)
            except OSError:
                pass
            conn.close()
        deadline = time.time() + (0 if kill else 30)
        for p in self._procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                p.kill()
                p.wait()
        for conn in self._recv:
            conn.close()
        self._procs, self._send, self._recv = [], [], []


_MODULES: Dict[str, Any] = {}


def resolve(target: str):
    """``"package.module:function"`` or ``"path/to/file.py:function"`` →
    the function (a file is imported once per process, under its own
    name, never as ``__main__``)."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = os.path.abspath(where)
        if path not in _MODULES:
            mod_name = "_rank_pool_" + os.path.splitext(
                os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
            _MODULES[path] = module
        return getattr(_MODULES[path], name)
    return getattr(importlib.import_module(where), name)


def _worker(read_fd: int, write_fd: int) -> None:
    from mme_tpu_torch.parallel import distributed

    inbox = Connection(read_fd, writable=False)
    outbox = Connection(write_fd, readable=False)
    try:
        distributed.maybe_initialize(
            device=os.environ.get("MME_POOL_DEVICE", "cpu"))
        outbox.send(("ok", distributed.rank()))
    except Exception:  # noqa: BLE001 — sent to the parent, which raises
        outbox.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = inbox.recv()
        except EOFError:
            break
        if msg is None:
            break
        target, args, kwargs = msg
        try:
            result = ("ok", resolve(target)(*args, **kwargs))
        except Exception:  # noqa: BLE001 — reported to the parent, which
            result = ("err", traceback.format_exc())   # stops the pool
        outbox.send(result)
    distributed.shutdown()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
