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

Then the fp32-weight model as a bundle (``serve.py::export_bundle``,
loaded by ``load_bundle``) and as the program ``torch.export`` gives
before ``export_bundle`` strips its per-cast metadata checks, each beside
the live ``Predictor`` on the same request with the video normalised on
the host (what a bundle takes): ``request_ms``, device time, busy share,
and the program's node counts.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.profile_serve``.
Prints one JSON object per weight dtype and one for the bundle legs.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from collections import Counter, defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.serve import (Predictor, _Forward, _to_device,
                                 export_bundle, load_bundle)
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


def device_profile(call, n: int = 3) -> dict:
    """Device time per call of ``call`` by kernel family and the top
    kernels, from a profiler window over ``n`` calls (the first window
    warms the profiler)."""
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
    families = defaultdict(float)
    kernels = []
    launches = 0
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the host ops
        # that launched them carry the same time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0)
                   or getattr(ev, "self_cuda_time_total", 0.0))
        families[kernel_family(ev.key)] += us / (n * 1e3)
        kernels.append((us / (n * 1e3), ev.count // n, ev.key[:90]))
        launches += ev.count
    kernels.sort(reverse=True)
    return {"device_ms_per_request": sum(families.values()),
            "device_kernels_per_request": launches / n,
            "families_ms": dict(sorted(families.items(),
                                       key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "calls": c, "name": k}
                            for ms, c, k in kernels[:12]]}


def bundle_legs(model, req: dict, card: str) -> dict:
    """The live Predictor, the bundle ``export_bundle`` writes and the
    program as ``torch.export`` gives it, on one request whose video is
    normalised on the host."""
    req = dict(req)
    req["video"] = normalize_uint8_video(torch.from_numpy(req["video"])
                                         ).numpy()
    pred = Predictor(model, batch_size=8, device="cuda")
    directory = tempfile.mkdtemp(prefix="mme_profile_bundle_")
    try:
        info = export_bundle(model, req, directory, batch_size=8,
                             device="cuda")
        bundle = load_bundle(directory, device="cuda")
        with torch.no_grad():
            raw = torch.export.export(
                _Forward(model), (_to_device(req, torch.device("cuda")),),
                strict=False).module()
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    def raw_call(batch):
        with torch.inference_mode():
            return raw(_to_device(batch, torch.device("cuda")))

    out = {"bundle": {**info, "load_s": bundle.load_s}, "card": card}
    for name, call, graph in (("live", pred, None),
                              ("bundle", bundle, bundle.module.graph),
                              ("torch_export_as_traced", raw_call,
                               raw.graph)):
        call(req)
        call(req)
        leg = {"request_ms": _median_ms(lambda: call(req)),
               **device_profile(lambda: call(req))}
        leg["device_busy_share_of_request"] = (
            leg["device_ms_per_request"] / leg["request_ms"])
        if graph is not None:
            nodes = Counter(str(n.target) for n in graph.nodes
                            if n.op == "call_function")
            leg["graph_nodes"] = sum(nodes.values())
            leg["metadata_asserts"] = sum(
                v for k, v in nodes.items() if "assert_tensor_metadata" in k)
        out[name] = leg
    return out


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
        prof = device_profile(lambda: pred(req))
        print(json.dumps({
            "weights": "fp32" if param_dtype is None else "bf16",
            "compute": "bf16", "batch": 8, "card": card,
            "request_ms": request_ms,
            "forward_ms": float(np.median(fwd)),
            "device_ms_per_request": prof["device_ms_per_request"],
            "device_busy_share_of_request":
                prof["device_ms_per_request"] / request_ms,
            "families_ms": prof["families_ms"],
            "top_kernels": prof["top_kernels"],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}), flush=True)
        del pred, dev
        if param_dtype is None:
            print(json.dumps({"bundle_legs": bundle_legs(model, req, card)}),
                  flush=True)
        del model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
