"""Time a checkpoint of the full-width TAV train state on one CUDA card, by
its parts.

    python -m mme_tpu_torch.time_checkpoint

The state is what ``train/checkpoint.py`` saves in the bench
configuration: ``TAVSpec(output_dim=7)`` with the shared audio frontend,
fp32 parameters and bf16 AdamW moments (``MME_OPT_STATE=bf16``), 4.96 GB.
Prints one JSON line with:
- the copy of the state to the host on a side stream: into pageable memory
  (``.to("cpu")``), into pinned memory the first time (allocated) and the
  second (from PyTorch's caching host allocator);
- ``torch.save`` of the host copy with and without the zip records' CRC-32;
- ``CheckpointManager``'s path: the blocking part of ``save_best``, the
  ``wait()`` for its write, ``restore_best`` into the card's tensors;
- host µs per kernel launch of the calling thread alone, while another
  thread copies the state into pageable memory, and while the manager
  writes;
and the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, List, Tuple

import torch
from torch.utils.serialization import config as serialization_config

from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.optim import AdamWState
from mme_tpu_torch.train.steps import TrainState


def full_width_state() -> TrainState:
    spec = dataclasses.replace(TAVSpec(output_dim=7),
                               share_audio_frontend=True)
    names, params = zip(*from_flax(init_params(spec, 0)).items())
    params = [p.cuda() for p in params]
    zeros = lambda: [torch.zeros_like(p, dtype=torch.bfloat16)
                     for p in params]
    return TrainState(step=0, params=params, accum_grads=None,
                      opt_state=AdamWState(count=0, mu=zeros(), nu=zeros()),
                      names=list(names))


def timed(fn: Callable) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def launch_us(n: int = 1000) -> float:
    """Host µs per launch of a one-element kernel."""
    x = torch.zeros(1, device="cuda")
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    return (time.perf_counter() - t) / n * 1e6


def launch_us_during(fn: Callable) -> Tuple[List[float], float]:
    """``launch_us`` in rounds while ``fn`` runs in another thread, and
    the seconds ``fn`` took."""
    done = []

    def run():
        t = time.perf_counter()
        fn()
        done.append(time.perf_counter() - t)

    th = threading.Thread(target=run)
    th.start()
    out = []
    while th.is_alive():
        out.append(launch_us())
    th.join()
    return out, done[0]


def main() -> None:
    state = full_width_state()
    tensors = state.params + state.opt_state.mu + state.opt_state.nu
    gb = sum(t.numel() * t.element_size() for t in tensors) / 1e9
    side = torch.cuda.Stream()
    res = {"state_gb": gb, "tensors": len(tensors)}
    host: List[torch.Tensor] = []

    # each copy first frees the last one, so the second pinned copy takes
    # the first one's blocks from the caching host allocator
    def pageable():
        host.clear()
        with torch.cuda.stream(side):
            host[:] = [t.to("cpu") for t in tensors]

    def pinned():
        host.clear()
        with torch.cuda.stream(side):
            out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for t in tensors]
            for o, t in zip(out, tensors):
                o.copy_(t, non_blocking=True)
        side.synchronize()
        host[:] = out

    res["to_host_pageable_s"] = timed(pageable)
    res["to_host_pinned_first_s"] = timed(pinned)
    res["to_host_pinned_cached_s"] = timed(pinned)
    directory = tempfile.mkdtemp(prefix="mme_time_ckpt_")
    try:
        for crc in (True, False):
            serialization_config.save.compute_crc32 = crc
            res[f"torch_save_crc32_{'on' if crc else 'off'}_s"] = timed(
                lambda: torch.save(host, os.path.join(directory, "x.pt")))
        serialization_config.save.compute_crc32 = True
        host.clear()

        res["launch_us_alone"] = launch_us()
        res["launch_us_during_pageable_copy"] = launch_us_during(
            pageable)[0]
        host.clear()
        mgr = CheckpointManager(os.path.join(directory, "ck"))
        # two turns; the calling thread launches kernels while the second
        # is written
        for turn in range(2):
            t = time.perf_counter()
            mgr.save_best(state, {"epoch": turn})
            res[f"save_best_blocking_s_{turn}"] = time.perf_counter() - t
            if turn:
                res["launch_us_during_write"], res["wait_s_1"] = (
                    launch_us_during(mgr.wait))
            else:
                res["wait_s_0"] = timed(mgr.wait)
            res[f"restore_best_s_{turn}"] = timed(
                lambda: mgr.restore_best(state))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    res["card"] = card_line()
    print(json.dumps({"time_checkpoint": res}), flush=True)


if __name__ == "__main__":
    main()
