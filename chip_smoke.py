"""Smoke run of the PyTorch/CUDA port (``mme_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: every kernel of the serving path from ``mme_tpu_torch/csrc/``,
   one ``nvcc`` per source started together; prints the build time and
   ``-Xptxas -v``.
3. Kernels against their plain PyTorch versions on the card: the flash
   forward at the four served shapes in bf16 and fp32, a ragged key length
   with head_dim 128, and rows whose every key is masked. Times the kernel,
   its plain version and ``scaled_dot_product_attention`` (a yardstick the
   port never calls) at the served bf16 shapes with CUDA events.
4. The main path at full width: ``init_params(TAVSpec(output_dim=7))`` →
   ``from_flax`` → ``TAVModel`` → ``Predictor(batch_size=8)`` serving ragged
   requests (8, 5 and 11 utterances, uint8 video) in an fp32 and a bf16
   leg. Each leg is held against the same Predictor with ``MME_FLASH=0``;
   the flash launch count must be 54 per chunk. Prints ms per batch of 8,
   utterances per second and peak device memory for the bf16 leg.

Then one JSON line of per-kernel results, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                               flash_attention_fwd_plain)
from mme_tpu_torch.serve import Predictor
from mme_tpu_torch.train.build_tav import example_tav_batch

SEED = 0
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
# tolerances of the flash kernel against its plain version, elementwise
# |O - O_plain| <= atol + rtol |O_plain| and relative on LSE:
# fp32 — both sum fp32 products, in other orders: a few fp32 ulps of |O|;
# bf16 — the kernel rounds the unnormalised P to bf16 and the plain version
# the normalised probabilities, and O itself is rounded to bf16 (one ulp is
# 2^-8 relative): a bf16 ulp or two of |O|; LSE is summed in fp32 on both
# sides.
TOL = {torch.float32: {"atol": 1e-5, "rtol": 1e-5, "lse": 1e-5},
       torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2, "lse": 1e-3}}
# served probabilities, flash against MME_FLASH=0 on the same weights and
# requests: fp32 agrees to fp32 rounding carried through 54 attention
# layers; bf16 carries the per-layer bf16 differences above through the
# towers' depth (24 audio layers)
SERVE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# (name, batch, seq, heads) of the attention calls of one served chunk:
# 6 text, 24 audio, 12 video and 12 fusion layers, head_dim 64
SERVED = (("text", 8, 70, 12, 6), ("audio", 8, 299, 16, 24),
          ("video", 8, 1464, 12, 12), ("fusion", 8, 473, 12, 12))
LAUNCHES_PER_CHUNK = sum(n for *_, n in SERVED)   # 54


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, Sq, Sk, H, D, dtype, masked_rows, seed):
    """q, k, v as strided views of fused QKV tensors (the layout the model
    hands the kernel) and a key-mask bias with ragged lengths; the first
    ``masked_rows`` batch rows have every key masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, Sk, 3, H, D, generator=g, device="cuda").to(dtype)
    q = qkv[:, :, 0] if Sq == Sk else torch.randn(
        B, Sq, 3, H, D, generator=g, device="cuda").to(dtype)[:, :, 0]
    lengths = torch.randint(1, Sk + 1, (B,), generator=g, device="cuda")
    lengths[:masked_rows] = 0
    keep = torch.arange(Sk, device="cuda")[None, :] < lengths[:, None]
    bias = additive_mask(keep)[:, 0, 0, :]
    return q, qkv[:, :, 1], qkv[:, :, 2], bias


def bound_ms(B, Sq, Sk, H, D, elem, has_bias):
    flops = 4 * B * H * Sq * Sk * D
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem \
        + B * H * Sq * 4 + (B * Sk * 4 if has_bias else 0)
    return flops, nbytes, max(flops / PEAK_BF16_FLOPS,
                              nbytes / PEAK_BYTES) * 1e3


def check_flash(card: str):
    """Phase 3. Returns (max |O - O_plain| over all cases, per-shape
    results at the served bf16 shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video"))
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True))
    max_err = 0.0
    for i, (name, B, Sq, Sk, H, D, dtype, masked, has_bias) in enumerate(
            cases):
        q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, i)
        bias = bias if has_bias else None
        o, lse = flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
        tol = TOL[dtype]
        d = (o.float() - o_ref.float()).abs()
        err = d.max().item()
        excess = (d - tol["rtol"] * o_ref.float().abs()).max().item()
        lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)
                   ).max().item()
        finite = bool(torch.isfinite(o.float()).all())
        print(f"flash_fwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
              f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
              f"max|dO|={err:.3e}, max(|dO| - rtol|O|)={excess:.3e} "
              f"(atol {tol['atol']}, rtol {tol['rtol']}); "
              f"max rel dLSE={lse_err:.3e} (tol {tol['lse']})", flush=True)
        if not (finite and excess <= tol["atol"] and lse_err <= tol["lse"]):
            raise SystemExit(f"flash_fwd disagrees with its plain version "
                             f"on case {name} {dtype}")
        max_err = max(max_err, err)

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 100 + i)
        bias = None if name == "video" else bias
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, bias))
        plain = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, bias),
                        iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        flops, nbytes, bound = bound_ms(B, S, S, H, 64, 2, bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_chunk": n, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                            >= nbytes / PEAK_BYTES else "bytes"),
               "card": card}
        print(json.dumps({"flash_fwd_shape": row}), flush=True)
        shapes.append(row)
    return max_err, shapes


def requests(spec: TAVSpec):
    """Ragged requests of 8, 5 and 11 utterances with uint8 video; some
    rows carry shorter text and audio."""
    out = []
    for i, n in enumerate((8, 5, 11)):
        r = example_tav_batch(spec, n, 70, 96000, seed=SEED + 1 + i)
        r["video"] = np.clip(r["video"] * 64 + 128, 0, 255).astype(np.uint8)
        r["text_mask"][1::3, 40:] = 0
        r["audio_mask"][1::2, 60000:] = 0
        out.append(r)
    return out


def serve(pred: Predictor, reqs):
    probs = [pred(r)[1] for r in reqs]
    torch.cuda.synchronize()
    return probs


def main_path(card: str):
    """Phase 4. Returns the flash launches of the bf16 (served) run."""
    spec = TAVSpec(output_dim=7)
    t0 = time.perf_counter()
    state = from_flax(init_params(spec, SEED))
    n_params = sum(v.numel() for v in state.values())
    print(f"weights: {n_params / 1e6:.1f} M parameters drawn and converted "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served_launches = None
    for dtype in (torch.float32, torch.bfloat16):
        leg = "fp32" if dtype == torch.float32 else "bf16"
        model = TAVModel(spec.with_compute_dtype(dtype), device="cuda")
        model.load_state_dict(state, strict=True)
        pred = Predictor(model, batch_size=8, device="cuda")
        serve(pred, reqs[:1])                       # warm-up: cuDNN, build
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        got = serve(pred, reqs)
        launches = kernels.LAUNCHES["flash_fwd"]
        os.environ["MME_FLASH"] = "0"
        try:
            ref = serve(pred, reqs)
            plain_launches = kernels.LAUNCHES["flash_fwd"] - launches
        finally:
            del os.environ["MME_FLASH"]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
        sums = max(float(np.abs(p.sum(-1) - 1).max()) for p in got)
        shapes_ok = all(p.shape == (len(r["input_ids"]), 7)
                        for p, r in zip(got, reqs))
        finite = all(np.isfinite(p).all() for p in got + ref)
        print(f"serve {leg}: {chunks} chunks, flash launches {launches} "
              f"(expected {LAUNCHES_PER_CHUNK * chunks}), with MME_FLASH=0 "
              f"{plain_launches}; max|probs - probs(MME_FLASH=0)| = "
              f"{diff:.3e} (tol {SERVE_TOL[dtype]}); max|sum-1| = "
              f"{sums:.2e}; finite {finite}", flush=True)
        if not (finite and shapes_ok and sums < 1e-5
                and launches == LAUNCHES_PER_CHUNK * chunks
                and plain_launches == 0 and diff <= SERVE_TOL[dtype]):
            raise SystemExit(f"serving check failed in the {leg} leg")
        if dtype == torch.bfloat16:
            served_launches = launches
            one = reqs[0]
            times = []
            for _ in range(10):
                t = time.perf_counter()
                pred(one)
                times.append(time.perf_counter() - t)
            ms = float(np.median(times)) * 1e3
            print(json.dumps({"serve_bf16": {
                "ms_per_batch_of_8": ms, "utt_per_s": 8e3 / ms,
                "times_ms": [x * 1e3 for x in times],
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "card": card}}), flush=True)
        del pred, model
        torch.cuda.empty_cache()
    return served_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build(["flash_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s\n{logs['flash_fwd']}",
          flush=True)

    max_err, shapes = check_flash(card)
    launches = main_path(card)

    total = {k: sum(r[k] * r["launches_per_chunk"] for r in shapes)
             for k in ("ms", "plain_ms", "library_ms")}
    flops = sum(r["gflop"] * r["launches_per_chunk"] for r in shapes) * 1e9
    nbytes = sum(r["mbytes"] * r["launches_per_chunk"] for r in shapes) * 1e6
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mme_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mme_tpu/ops/flash_attention.py:125",
        "tpu_kernel": "mme_tpu/ops/flash_attention.py::_fwd_kernel",
        "launches": launches, "max_abs_err": max_err, "max_err": max_err,
        # times and bound: the 54 launches of one served chunk of 8
        "ms": total["ms"], "kernel_ms": total["ms"],
        "plain_ms": total["plain_ms"], "library_ms": total["library_ms"],
        "bound_ms": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
        "bound_us": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e6,
        "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                     >= nbytes / PEAK_BYTES else "bytes")}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
