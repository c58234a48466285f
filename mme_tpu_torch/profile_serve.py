"""Where the time of one served chunk goes on the card.

Builds the full-width ``TAVSpec(output_dim=7)`` model (bf16 compute, random
weights from ``convert.init_params``), serves chunks of 8 utterances with
uint8 video through ``Predictor`` and reports, for fp32 and for bf16 stored
weights:

- ``request_ms``: host clock around one ``Predictor`` call (ingress, pad,
  forward, softmax, copy back), median of 10;
- ``forward_ms``: CUDA events around the model forward alone on a batch
  already on the device, median of 10;
- a ``torch.profiler`` window over 3 requests: device time per request by
  kernel family and the top kernels; their sum over ``request_ms`` is the
  device-busy share.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.profile_serve``.
Prints one JSON object per weight dtype.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.serve import Predictor
from mme_tpu_torch.train.build_tav import (example_tav_batch,
                                           normalize_uint8_video)

# kernel-name fragments → family (first match wins)
FAMILIES = (("flash_fwd", "flash_fwd (K1)"),
            ("flash_bwd", "flash_bwd (K2)"),
            ("adam_update", "adam_update (K3)"),
            ("mme_ln_fwd", "layer_norm_fwd (K4a)"),
            # K4b is mme_ln_bwd and its mme_ln_bwd_reduce
            ("mme_ln_bwd", "layer_norm_bwd (K4b)"),
            ("mlp_fwd", "fused_mlp_fwd (K5a)"),
            ("mlp_bwd", "fused_mlp_bwd (K5b)"),
            # bf16: K5a is two mlp_gemm launches, K5b mlp_dual and one
            ("mlp_dual", "fused_mlp_bwd (K5b)"),
            ("mlp_gemm", "mlp_gemm (K5a; K5b dx, dW)"),
            ("dgrad", "conv backward"), ("wgrad", "conv backward"),
            ("conv", "conv"), ("cudnn", "conv"), ("fprop", "conv"),
            ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
            ("nvjet", "matmul"),
            ("Memcpy", "memcpy"), ("copy", "copy/cast"),
            ("reduce", "reduction"), ("softmax", "reduction"))


def kernel_family(name: str) -> str:
    for frag, fam in FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "elementwise/other"


def _median_ms(fn, n=10):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    card = card_line()
    spec = TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16)
    state = from_flax(init_params(spec, 0))
    req = example_tav_batch(spec, 8, 70, 96000, seed=1)
    req["video"] = np.clip(req["video"] * 64 + 128, 0, 255).astype(np.uint8)
    for param_dtype in (None, torch.bfloat16):
        model = TAVModel(spec, device="cuda")
        model.load_state_dict(state)
        pred = Predictor(model, batch_size=8, device="cuda",
                         param_dtype=param_dtype)
        pred(req)
        pred(req)
        request_ms = _median_ms(lambda: pred(req))
        dev = {k: torch.from_numpy(v).cuda() for k, v in req.items()}
        dev["video"] = normalize_uint8_video(dev["video"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fwd = []
        with torch.inference_mode():
            for _ in range(10):
                start.record()
                model(dev)
                end.record()
                end.synchronize()
                fwd.append(start.elapsed_time(end))
        for _ in range(2):          # the first window warms the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    pred(req)
                torch.cuda.synchronize()
        families = defaultdict(float)
        kernels = []
        for ev in prof.key_averages():
            # device-side events only (kernels, memcpy, memset): the host
            # ops that launched them carry the same time again
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = float(getattr(ev, "self_device_time_total", 0.0)
                       or getattr(ev, "self_cuda_time_total", 0.0))
            families[kernel_family(ev.key)] += us / 3e3
            kernels.append((us / 3e3, ev.count // 3, ev.key[:90]))
        kernels.sort(reverse=True)
        device_ms = sum(families.values())
        print(json.dumps({
            "weights": "fp32" if param_dtype is None else "bf16",
            "compute": "bf16", "batch": 8, "card": card,
            "request_ms": request_ms,
            "forward_ms": float(np.median(fwd)),
            "device_ms_per_request": device_ms,
            "device_busy_share_of_request": device_ms / request_ms,
            "families_ms": dict(sorted(families.items(),
                                       key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": n, "name": k}
                            for ms, n, k in kernels[:12]],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}), flush=True)
        del pred, model, dev
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
