"""Where the time of one train step goes on the card.

Builds the full-width ``TAVSpec(output_dim=7)`` training setup through
``build_tav`` in the configuration of the JAX package's ``bench.py`` (bf16
compute over fp32 weights, batch 8, 70 tokens, 96 000 samples, a 16x224x224
clip, shared audio frontend, no remat, no accumulation buffer, bf16 moments,
lr 5e-6, random weights from ``convert.init_params``) and reports, with
``MME_FUSED_ADAM`` off and on and then with ``MME_FUSED_LN=1
MME_FUSED_MLP=1``:

- ``step_ms``: host clock around one ``train_step`` ending in a
  synchronise, median of 5 after 3 warm-up steps;
- a ``torch.profiler`` window over 2 steps: device time per step by kernel
  family, the top kernels, the number of device kernels per step, and their
  sum over ``step_ms``, the device-busy share.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.profile_train``.
Prints one JSON object per setting. ``--cudnn-benchmark`` sets
``torch.backends.cudnn.benchmark`` first (cuDNN then times its convolution
algorithms instead of taking its heuristic's pick): a probe of how much of
the step is that pick, not a setting the port makes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import init_params
from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.profile_serve import kernel_family
from mme_tpu_torch.train.build_tav import build_tav, example_tav_batch
from mme_tpu_torch.train.steps import to_device

WINDOW = 2      # steps per profiler window
SETTINGS = (
    {"MME_FUSED_ADAM": "0", "MME_FUSED_LN": "0", "MME_FUSED_MLP": "0"},
    {"MME_FUSED_ADAM": "1", "MME_FUSED_LN": "0", "MME_FUSED_MLP": "0"},
    {"MME_FUSED_ADAM": "0", "MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cudnn-benchmark", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    card = card_line()
    spec = dataclasses.replace(
        TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=8, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    os.environ["MME_OPT_STATE"] = "bf16"
    model, state, train_step, _ = build_tav(
        spec, cfg, 1000, params=init_params(spec, 0), remat=False,
        use_accum=False, device="cuda")
    batch = to_device(example_tav_batch(spec, 8, 70, 96000, seed=1), "cuda")
    labels = np.arange(8) % 7
    mask, cw = np.ones(8, np.int32), np.ones(7, np.float32)

    def step():
        train_step(state, batch, labels, mask, cw, 1.0, True, 0)
        torch.cuda.synchronize()

    for knobs in SETTINGS:
        os.environ.update(knobs)
        for _ in range(3):
            step()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            step()
            times.append((time.perf_counter() - t) * 1e3)
        step_ms = float(np.median(times))
        for _ in range(2):          # the first window warms the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(WINDOW):
                    step()
        families = defaultdict(float)
        kernels, launches = [], 0
        for ev in prof.key_averages():
            # device-side events only (kernels, memcpy, memset): the host
            # ops that launched them carry the same time again
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = float(getattr(ev, "self_device_time_total", 0.0)
                       or getattr(ev, "self_cuda_time_total", 0.0))
            families[kernel_family(ev.key)] += us / (1e3 * WINDOW)
            kernels.append((us / (1e3 * WINDOW), ev.count // WINDOW,
                            ev.key[:90]))
            launches += ev.count // WINDOW
        kernels.sort(reverse=True)
        device_ms = sum(families.values())
        print(json.dumps({
            "knobs": knobs,
            "cudnn_benchmark": args.cudnn_benchmark, "compute": "bf16",
            "batch": 8,
            "card": card, "step_ms": step_ms, "times_ms": times,
            "utt_per_s": 8e3 / step_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share_of_step": device_ms / step_ms,
            "device_kernels_per_step": launches,
            "families_ms": dict(sorted(families.items(),
                                       key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": k}
                            for ms, n, k in kernels[:14]],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}), flush=True)


if __name__ == "__main__":
    main()
