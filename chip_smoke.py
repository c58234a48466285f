"""Smoke run of the PyTorch/CUDA port (``mme_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: every CUDA kernel from ``mme_tpu_torch/csrc/`` (flash forward
   and backward, the fused MLP, the fused LayerNorm, the fused Adam
   update), one ``nvcc`` per source started together; prints the build
   time, ``-Xptxas -v`` of the flash kernels and a summary of the fused
   MLP's (registers, spills), of every flash kernel's (registers, spills,
   wgmma serialized by ptxas or not), of every LayerNorm instance's
   (registers, spills, static shared memory; the ring's dynamic shared
   memory is printed per shape in phase 3) and of the Adam kernel's.
3. Kernels against their plain PyTorch versions on the card:
   - the flash forward (K1) and backward (K2), q/k/v as strided views of a
     fused QKV tensor, at the four model shapes in bf16 and fp32, a ragged
     key length with head_dim 128, rows whose every key is masked by bias
     and, for K2, a sentinel row (every score -inf). Times each kernel, its
     plain version and ``scaled_dot_product_attention`` forward / backward
     (a yardstick the port never calls) at the bf16 shapes with CUDA events;
   - the fused bf16-moment Adam update (K3) on the model's leaf shapes:
     exact in ``zero_noise`` mode, and with noise every moment is one of
     the two bf16 neighbours, the mean error is within 5 standard errors,
     other leaves and steps get other dither, and the moments equal the
     plain version's bit for bit on the same Philox words; one launch over
     a mixed list (fp32 and bf16 gradients, 1 to 38.6 M elements, a leaf
     not 16-byte aligned), fresh and in place; one launch over the step's
     725 trainable leaves against the plain version on the same words.
     Times one call over the step's trainable leaves (and over its 235 big
     ones, the per-leaf kernel's old set): wrapper by CUDA events, kernel
     alone in a profiler trace, host µs per call, the plain version once;
   - the fused LayerNorm forward (K4a) and backward (K4b) at [2 392, 1024],
     [11 712, 768], [3 784, 768], [153 592, 512], a ragged [3 001, 768] and
     the widest row [1 024, 8 192] in bf16 and fp32, fp32 in / bf16 out, and
     x as a row-offset view: y, dx, dscale, dbias, two runs bit-equal. Times
     them at every shape a training step launches, beside ``F.layer_norm``
     and its backward (weight and bias cast to bf16 once, outside the
     timed call), with the bounds of ``ops/layer_norm.py::bounds``;
   - the wgmma/TMA product core of the bf16 MLP kernels alone
     (``gemm_bf16``) against an fp32 product at the four operand orders,
     ragged extents and the video tower's product shapes;
   - the fused MLP forward (K5a) and backward (K5b) at the four full-width
     tower shapes in bf16, a small shape in fp32 and bf16 with each of the
     four activations, N = 1, 17 and 129 at H = 256 to 1024 in bf16, and a
     wide fp32 shape: out, dx, dW1, dW2, db1, db2, two runs bit-equal.
     Times them at the tower shapes beside the unfused
     ``F.linear → gelu → F.linear`` and its autograd backward.
4. Serving at full width: ``init_params(TAVSpec(output_dim=7))`` →
   ``from_flax`` → ``TAVModel`` → ``Predictor(batch_size=8)`` serving ragged
   requests (8, 5 and 11 utterances, uint8 video) in an fp32 and a bf16
   leg. Each leg is held against the same Predictor with ``MME_FLASH=0``
   (54 flash launches per chunk), then served again with
   ``MME_FUSED_LN=1 MME_FUSED_MLP=1`` and held against the knobs-off
   probabilities: 54 K5a launches per chunk and the K4a count computed from
   the spec. Prints ms per batch of 8 with the knobs off and on,
   utterances per second and peak device memory for the bf16 leg.
5. Training at full width and depth through ``build_tav`` (70 tokens,
   96 000 samples, a 16x224x224 clip, shared audio frontend, no remat, no
   accumulation buffer):
   (1) fp32 compute, dropout and SpecAugment off, batch 4: loss and
       gradients of one batch with the kernels against ``MME_FLASH=0``
       (54 forward and 54 backward launches with, none without), and with
       both knobs on against both off: 54 + 54 launches of K5a/K5b and
       K1/K2, the computed K4a/K4b counts;
   (2) a deterministic bf16 leg (dropout off) on one fixed batch of 8: the
       loss after four steps must lie below the first;
   (3) the benchmark configuration: bf16 compute, batch 8, dropout and
       SpecAugment on, ``MME_OPT_STATE=bf16``, lr 5e-6, cosine warm
       restarts; 2 warm-up and 4 timed steps, 54 + 54 launches per step;
       prints ms per step, utterances per second, peak memory and a
       forward / backward / optimizer split by CUDA events;
   (4) the same state with ``MME_FUSED_ADAM=1``: one K3 launch per step
       covering every trainable leaf, the moments bf16 and updated in
       place, peak memory within 0.2 GB of leg (3)'s; device kernels per
       step beside leg (3)'s (profiler);
   (5) the same state with ``MME_FUSED_LN=1 MME_FUSED_MLP=1``: launches per
       step, ms per step, the split and peak memory beside leg (3)'s.
6. The training loop at full width: phase 5's weights in a fresh bf16
   ``TAVModel`` (dropout 0.1, shared audio frontend) through the CLI's
   ``cli/common.py::run_classifier`` with ``MME_OPT_STATE=bf16
   MME_FUSED_ADAM=1`` on synthetic records (70 tokens, 96 000 samples, a
   16x224x224 clip; 32 / 8 / 8 utterances), batch 8, two epochs,
   validation every 2 steps, random keep-masks and SpecAugment, checkpoints
   in a temporary directory deleted at the end. Epoch 0 runs the weighted
   sampler and plain loss; epoch 1 runs in order with class weights and
   dialog accumulation (dialogs of 16: two batches per update). Checks:
   finite losses in both epochs; 54 K1 launches per train step and eval
   batch, 54 K2 per train step, one K3 per applied update (6 for 8
   steps); no saved state carries the accumulation buffer; the best
   checkpoint restored into fresh tensors equals the state the loop
   returned bit for bit; a save followed by a train step before its
   ``wait()`` still restores the state of the save (the step rewrites
   parameters and moments in place); ``MME_EVAL_ONLY=1`` on the same
   directory reproduces the test matrix and loss. Prints the loop's
   utterances per second beside leg (4)'s bare step, peak memory,
   checkpoint size, the host ms of each save's blocking part, of each
   ``wait()`` and of each restore, free disk space and the phase's time;
   then runs one more epoch under ``torch.profiler`` (device activity
   only) for the device's busy share of it.

Then one JSON line of per-kernel results (seven kernels), the card's name
and power limit, and last the line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mme_tpu_torch.cli.common import run_classifier
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.data.dataset import batches
from mme_tpu_torch.data.synthetic import synthetic_tav_dataset
from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES, card_line
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch import time_adam
from mme_tpu_torch.ops import adam_update, kernels
from mme_tpu_torch.ops.adam_update import (adam_update_leaf,
                                           adam_update_leaf_plain,
                                           adam_update_leaves,
                                           adam_update_leaves_plain)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.fused_mlp import (ACTS, fused_mlp_bwd,
                                         fused_mlp_bwd_plain, fused_mlp_fwd,
                                         fused_mlp_fwd_plain, gemm_bf16,
                                         gemm_operand_major, kernel_supports)
from mme_tpu_torch.ops.fused_mlp import bounds as mlp_bounds
from mme_tpu_torch.ops.layer_norm import bounds as ln_bounds
from mme_tpu_torch.ops.layer_norm import (fused_layer_norm_bwd,
                                          fused_layer_norm_bwd_plain,
                                          fused_layer_norm_fwd,
                                          fused_layer_norm_fwd_plain,
                                          launch_geometry, smem_bytes)
from mme_tpu_torch.ops.flash_attention import (bounds as flash_bounds,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain)
from mme_tpu_torch.serve import Predictor
from mme_tpu_torch.time_layer_norm import fused_ln_shapes
from mme_tpu_torch.train.build_tav import (build_tav, example_tav_batch,
                                           make_video_keep_transform)
from mme_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.optim import AdamWState, global_norm_f32
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                       make_train_step, to_device)

SEED = 0
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
# gradients of the flash backward against its plain version, as a share of
# each gradient's largest element (a gradient that is zero but for
# cancellation is held to a twentieth of the largest of the three): fp32 —
# sums of up to 1464 fp32 products in another order; bf16 — P and dS are
# rounded to bf16 on both sides at fp32 values that differ in the last
# place, and the result is rounded to bf16 once more. The kernel has no
# atomics: two runs give the same bits.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# fused Adam: the update `out` may differ from the plain version's by this
# many fp32 units in the last place (division and square root round to
# nearest on both sides; measured 0); the moments must be equal
ADAM_OUT_ULPS = 2
# training, kernels against MME_FLASH=0 from the same state, fp32 compute:
# fp32 rounding carried through 54 layers, forward and backward
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-3
# fused LayerNorm against its plain version, elementwise |y - y_plain| <=
# atol + rtol |y_plain| on y and dx: both sides compute in fp32 and differ by
# an ulp or so (rsqrt, fused multiply-adds) before the cast, so a few fp32
# ulps, or one bf16 step after a bf16 cast; dscale and dbias are fp32 sums
# over up to 153 592 rows in another order, held to 1e-4 of their largest
# element. No atomics: two runs give the same bits.
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
LN_SUM_RTOL = 1e-4
# fused MLP against its plain version, as a share of each tensor's largest
# element: fp32 — sums of up to 4096 (dW: N) fp32 products in another order;
# bf16 — `a` and `dh` are rounded to bf16 on both sides at fp32 values that
# differ in the last place and each result is rounded to bf16 once more.
# db1 and db2 are fp32 sums on both sides (1e-4 in bf16, where db1 sums the
# unrounded dh). No atomics: two runs give the same bits.
MLP_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLP_BIAS_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
# both knobs on against both off, same weights and inputs: served
# probabilities as SERVE_TOL; training in fp32 as TRAIN_*_RTOL (LayerNorm
# and the MLP products summed in other orders through 54 layers)
KNOBS = {"MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"}
# (name, batch, seq, heads) of the attention calls of one served chunk:
# 6 text, 24 audio, 12 video and 12 fusion layers, head_dim 64
SERVED = (("text", 8, 70, 12, 6), ("audio", 8, 299, 16, 24),
          ("video", 8, 1464, 12, 12), ("fusion", 8, 473, 12, 12))
LAUNCHES_PER_CHUNK = sum(n for *_, n in SERVED)   # 54


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spills of every kernel in one
    source's ``-Xptxas -v`` output (the fused MLP's shared memory is
    dynamic, sized per launch)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    return {"kernels": len(regs), "registers": sorted(regs),
            "max_registers": max(regs), "spill_bytes": sum(spills),
            "static_smem_bytes": sorted(set(smem))}


def kernel_ptxas(log: str) -> list:
    """Registers, spill bytes and static shared memory of every kernel in
    one source's ``-Xptxas -v`` output, by kernel and template arguments
    (D and element type; for LayerNorm x and y or g in bf16 (1) or fp32 (0)
    and the chunks per thread)."""
    out = []
    # ptxas names each kernel whose wgmma it serialised (C7512, C7515, ...)
    serialized = set(re.findall(r"are serialized[^\n]*'([^'\n]+)'", log))
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"'([^'\n]+)'", block).group(1)
        # _ZN..._<source>_cu_<8 hex digits><length><kernel name>I...
        at = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
        base = (name[at.end():at.end() + int(at.group(1))] if at
                else name)
        args = re.findall(r"Li(\d+)E", name)
        if "bfloat16" in name:
            args.append("bf16")
        elif re.search(r"IfLi", name):
            args.append("fp32")
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", block)
        out.append({"kernel": base + "<" + ",".join(args) + ">",
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spills.group(1)) + int(spills.group(2))
                                    if spills else None),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "serialized_wgmma": name in serialized})
    return out


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
        (flops, nbytes, bound, by), _ = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_chunk": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_fwd_shape": row}), flush=True)
        shapes.append(row)
    return max_err, shapes


def grads_close(got, want, dtype):
    """(ok, largest error as a share of its tolerance, largest |error|)."""
    floor = 0.05 * max(b.float().abs().max().item() for b in want)
    worst, worst_abs, finite = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        finite = finite and bool(torch.isfinite(a).all())
        err = (a - b).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst = max(worst, err / (BWD_TOL[dtype]
                                  * max(b.abs().max().item(), floor)))
    return finite and worst <= 1.0, worst, worst_abs


def check_flash_bwd(card: str):
    """Phase 3, K2. Returns (max |error| over all cases, per-shape results
    at the bf16 model shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video", False))
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True,
                      False))
        cases.append(("sentinel", 3, 130, 130, 4, 64, dtype, 1, True, True))
    max_err = 0.0
    for i, (name, B, Sq, Sk, H, D, dtype, masked, has_bias,
            sentinel) in enumerate(cases):
        q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, i)
        bias = bias if has_bias else None
        if sentinel:
            bias = bias.clone()
            bias[-1] = float("-inf")       # every score -inf in this row
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        out, lse = flash_attention_fwd(q, k, v, bias)
        got = flash_attention_bwd(q, k, v, bias, out, lse, do)
        again = flash_attention_bwd(q, k, v, bias, out, lse, do)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, bias, out, lse, do)
        ok, share, err = grads_close(got, want, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # a row masked by bias keeps the uniform P (dV not zero); a
        # sentinel row gets no gradient at all
        masked_dv = got[2][0].float().abs().max().item() if masked else None
        dead = (all(bool((x[-1] == 0).all()) for x in got) if sentinel
                else None)
        print(f"flash_bwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
              f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
              f"max|dgrad|={err:.3e} = {share:.3f} of tolerance "
              f"({BWD_TOL[dtype]} of max|grad|); two runs equal {same}; "
              f"max|dV| of the masked row {masked_dv}; sentinel row zero "
              f"{dead}", flush=True)
        if not (ok and same and (masked_dv is None or sentinel
                                 or masked_dv > 0)
                and dead is not False):
            raise SystemExit(f"flash_bwd disagrees with its plain version "
                             f"on case {name} {dtype}")
        max_err = max(max_err, err)

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 200 + i)
        bias = None if name == "video" else bias
        do = torch.randn(B, S, H, 64, device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, bias)
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, bias, out, lse, do))
        plain = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, bias, out, lse, do), iters=3, warmup=1)
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        do_t = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do_t,
                                                  retain_graph=True))
        _, (flops, nbytes, bound, by) = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_step": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_bwd_shape": row}), flush=True)
        shapes.append(row)
        del o_lib, leaves
    return max_err, shapes


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in fp32 units in the last place."""
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def adam_leaf(shape, seed, gdtype=torch.float32, offset=0):
    """A leaf's gradient and moments on the card; with ``offset`` each is a
    view that many elements into its storage (1: not 16-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))

    def at(x, dtype):
        buf = torch.empty(n + offset, dtype=dtype, device="cuda")
        buf[offset:] = x
        return buf[offset:].view(shape)

    return (at(torch.randn(n, generator=g, device="cuda") * 1e-3, gdtype),
            at(torch.randn(n, generator=g, device="cuda") * 1e-3,
               torch.bfloat16),
            at(torch.rand(n, generator=g, device="cuda") * 1e-6,
               torch.bfloat16))


def adam_same_bits(got, want) -> Tuple[bool, int]:
    """(every moment bit-equal, largest ulp distance of out) of two
    (outs, mu's, nu's) lists."""
    exact = all(torch.equal(a, b) for xs, ys in zip(got[1:], want[1:])
                for a, b in zip(xs, ys))
    return exact, max(ulps(a, b) for a, b in zip(got[0], want[0]))


def check_adam(spec: TAVSpec, card: str):
    """Phase 3, K3. Returns (max |out - out_plain|, times and bound of one
    call over the step's trainable leaves and over its 235 big ones)."""
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    max_err = 0.0
    # embedding, an MLP weight (port layout), an audio MLP weight, a conv
    for i, shape in enumerate(((50265, 768), (3072, 768), (1024, 4096),
                               (512, 512, 3))):
        grad, mu, nu = adam_leaf(shape, 300 + i)
        out, mu2, nu2 = adam_update_leaf(grad, mu, nu, bc1, bc2, 7,
                                         zero_noise=True, **kw)
        torch.cuda.synchronize()
        o_ref, mu_ref, nu_ref = adam_update_leaf_plain(
            grad, mu, nu, bc1, bc2, zero_noise=True, **kw)
        exact = torch.equal(mu2, mu_ref) and torch.equal(nu2, nu_ref)
        d_ulp = ulps(out, o_ref)
        err = (out - o_ref).abs().max().item()
        max_err = max(max_err, err)

        # with noise: each moment is one of its fp32 value's two bf16
        # neighbours, the mean error is within 5 standard errors (the
        # truncated value's is far outside), and the dither differs
        # between leaves (seed) and between steps (seed)
        m32 = 0.9 * mu.float() + (1.0 - 0.9) * grad
        bits = m32.view(torch.int32) & -65536
        lo, hi = bits.view(torch.float32), (bits + 65536).view(torch.float32)
        noisy = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)
        a = noisy[1].float()
        b = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)[1].float()
        c = adam_update_leaf(grad, mu, nu, bc1, bc2, 12, **kw)[1].float()
        bracket = bool(((a == lo) | (a == hi)).all())
        e = (a - m32).double()
        n = e.numel()
        se = e.std().item() / n ** 0.5
        mean_err, trunc = e.mean().item(), (lo.abs() - m32.abs()).double(
            ).mean().item()
        seeded = torch.equal(a, b) and not torch.equal(a, c)
        # noise on, the same Philox words: the plain version's bits
        same, n_ulp = adam_same_bits(
            [[x] for x in noisy],
            adam_update_leaves_plain([grad], [mu], [nu], bc1, bc2, [11],
                                     **kw))
        print(f"adam_update {str(shape):14s}: zero_noise moments equal "
              f"{exact}, out within {d_ulp} ulp (tol {ADAM_OUT_ULPS}); "
              f"noise: neighbours {bracket}, mean error {mean_err:.3e} = "
              f"{abs(mean_err) / se:.2f} standard errors (tol 5; "
              f"truncation {trunc / se:.1f}), same seed same bits and "
              f"other seed other bits {seeded}; same words as the plain "
              f"version: moments equal {same}, out within {n_ulp} ulp",
              flush=True)
        if not (exact and d_ulp <= ADAM_OUT_ULPS and bracket and seeded
                and abs(mean_err) <= 5 * se and trunc < -20 * se
                and same and n_ulp <= ADAM_OUT_ULPS):
            raise SystemExit(f"adam_update check failed on leaf {shape}")
        del grad, mu, nu, noisy, a, b, c, e, m32

    # one launch over a mixed list, fresh and in place, noise on
    specs = [((1,), torch.float32, 0), ((7,), torch.bfloat16, 0),
             ((768,), torch.float32, 0), ((70001,), torch.bfloat16, 0),
             ((3072, 768), torch.float32, 0), ((4099,), torch.float32, 1),
             ((50265, 768), torch.bfloat16, 0)]
    leaves = [adam_leaf(shape, 400 + k, dt, off)
              for k, (shape, dt, off) in enumerate(specs)]
    gs, mus, nus = (list(x) for x in zip(*leaves))
    seeds = [(5 << 20) + k for k in range(len(specs))]
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    fresh = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    torch.cuda.synchronize()
    counted = (kernels.LAUNCHES["adam_update"] - before[0],
               adam_update.LEAVES_FUSED - before[1])
    want = adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds, **kw)
    same, n_ulp = adam_same_bits(fresh, want)
    max_err = max(max_err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(fresh[0], want[0])))
    inplace = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, outs=gs,
                                 mu_outs=mus, nu_outs=nus, **kw)
    torch.cuda.synchronize()
    aliased = all(torch.equal(a, b) for xs, ys in zip(inplace, fresh)
                  for a, b in zip(xs, ys)) and all(
        x is y for xs, ys in zip(inplace, (gs, mus, nus))
        for x, y in zip(xs, ys))
    print(json.dumps({"adam_update_mixed": {
        "leaves": [[list(sh), str(dt), off] for sh, dt, off in specs],
        "launches": counted[0], "leaves_covered": counted[1],
        "moments_equal_plain": same, "out_ulps": n_ulp,
        "in_place_equals_fresh": aliased, "card": card}}), flush=True)
    if not (counted == (1, len(specs)) and same and n_ulp <= ADAM_OUT_ULPS
            and aliased):
        raise SystemExit("adam_update check failed on the mixed list")
    del leaves, gs, mus, nus, fresh, want, inplace
    torch.cuda.empty_cache()

    # one call over the step's trainable leaves (and its 235 big ones):
    # wrapper, kernel alone, host
    timed = time_adam.with_bounds(time_adam.time_tree())
    # the step's launch (past 32 leaves warp 0 searches in rounds) against
    # the plain version on the same inputs and words, which is timed too
    sizes = time_adam.step_leaf_sizes(spec)
    gs, mus, nus = time_adam.leaf_state(sizes, 1)
    seeds = [(9 << 20) + k for k in range(len(sizes))]
    got = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    want = []

    def plain():
        want[:] = [adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds,
                                            **kw)]

    timed["all"]["plain_ms"] = cuda_ms(plain, iters=1, warmup=1)
    same, n_ulp = adam_same_bits(got, want[0])
    max_err = max(max_err, max((a - b).abs().max().item()
                               for a, b in zip(got[0], want[0][0])))
    timed["all"].update(moments_equal_plain=same, out_ulps=n_ulp)
    del gs, mus, nus, got, want
    torch.cuda.empty_cache()
    print(json.dumps({"adam_update_step": timed, "card": card}), flush=True)
    if not (same and n_ulp <= ADAM_OUT_ULPS):
        raise SystemExit("adam_update check failed over the step's "
                         f"{len(sizes)} leaves")
    return max_err, timed


@contextlib.contextmanager
def knobs_on():
    """MME_FUSED_LN=1 and MME_FUSED_MLP=1 for the enclosed calls."""
    os.environ.update(KNOBS)
    try:
        yield
    finally:
        for k in KNOBS:
            del os.environ[k]


def mlp_shapes(spec: TAVSpec, batch: int, text_len: int = 70,
               samples: int = 96000):
    """(name, rows, hidden, intermediate, layers) of the four towers' MLPs."""
    frames = samples
    for k, st in zip(spec.audio.conv_kernels, spec.audio.conv_strides):
        frames = (frames - k) // st + 1
    towers = (("text", spec.text.encoder, batch * text_len),
              ("audio", spec.audio.encoder, batch * frames),
              ("video", spec.video.encoder,
               batch * (spec.video.num_patches - spec.video_keep_k)),
              ("fusion", spec.fusion,
               batch * (text_len + frames + spec.video_keep_k)))
    return [(name, n, e.hidden, e.intermediate, e.layers)
            for name, e, n in towers]


def ln_case(n, h, xdtype, ydtype, seed, offset=0):
    """With ``offset`` rows, x is a row-offset view: its base pointer is not
    the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n + offset, h, generator=g, device="cuda") * 2
         + 0.5).to(xdtype)[offset:]
    w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
    b = 0.2 * torch.randn(h, generator=g, device="cuda")
    gy = torch.randn(n, h, generator=g, device="cuda").to(ydtype)
    return x, w, b, gy


def check_layer_norm(spec: TAVSpec, card: str):
    """Phase 3, K4a and K4b. Returns the forward's and the backward's entry
    for the kernels line, times and bounds summed over the launches of one
    training step of the bf16 bench configuration."""
    eps = 1e-5
    shapes = [(2392, 1024), (11712, 768), (3784, 768), (153592, 512),
              (3001, 768),                                   # one ragged N
              (1024, 8192)]                                  # the widest row
    cases = [(n, h, dt, dt, 0) for dt in (torch.bfloat16, torch.float32)
             for n, h in shapes]
    cases.append((2392, 1024, torch.float32, torch.bfloat16, 0))  # fp32 → bf16
    cases.append((2392, 1024, torch.bfloat16, torch.bfloat16, 8))  # row view
    err_fwd = err_bwd = 0.0
    for i, (n, h, xdt, ydt, offset) in enumerate(cases):
        x, w, b, gy = ln_case(n, h, xdt, ydt, 400 + i, offset)
        y = fused_layer_norm_fwd(x, w, b, eps, ydt)
        got = fused_layer_norm_bwd(gy, x, w, eps)
        again = fused_layer_norm_bwd(gy, x, w, eps)
        torch.cuda.synchronize()
        y0 = fused_layer_norm_fwd_plain(x, w, b, eps, ydt)
        want = fused_layer_norm_bwd_plain(gy, x, w, eps)

        def excess(a, ref, dt):
            atol, rtol = LN_TOL[dt]
            d = (a.float() - ref.float()).abs()
            return d.max().item(), (d - rtol * ref.float().abs()
                                    ).max().item() - atol

        e_y, x_y = excess(y, y0, ydt)
        e_dx, x_dx = excess(got[0], want[0], xdt)
        sums = max(((a - r).abs().max() / r.abs().max().clamp(min=1e-12)
                    ).item() for a, r in zip(got[1:], want[1:]))
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (y,) + tuple(got))
        print(f"layer_norm N={n} H={h} x {str(xdt)[6:]} y {str(ydt)[6:]}"
              f"{' (row-offset view)' if offset else ''}: "
              f"max|dy|={e_y:.3e}, max|d(dx)|={e_dx:.3e} (atol, rtol "
              f"{LN_TOL[ydt]}, {LN_TOL[xdt]}); dscale, dbias within "
              f"{sums:.3e} of their largest element (tol {LN_SUM_RTOL}); "
              f"two runs equal {same}", flush=True)
        if not (finite and same and x_y <= 0 and x_dx <= 0
                and sums <= LN_SUM_RTOL and y.dtype == ydt
                and got[0].dtype == xdt):
            raise SystemExit(f"fused layer norm disagrees with its plain "
                             f"version at N={n} H={h} {xdt}")
        err_fwd, err_bwd = max(err_fwd, e_y), max(err_bwd, e_dx)

    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    rows = []
    dt = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (n, h), count in sorted(fused_ln_shapes(spec, 8).items()):
        x, w, b, gy = ln_case(n, h, dt, dt, n % 1000)
        # the library's weight and bias in the input's type, cast once
        lx, lw, lb = (t.detach().to(dt).requires_grad_() for t in (x, w, b))
        ly = F.layer_norm(lx, (h,), lw, lb, eps)
        t = {"fwd": cuda_ms(lambda: fused_layer_norm_fwd(x, w, b, eps, dt)),
             "fwd_plain": cuda_ms(lambda: fused_layer_norm_fwd_plain(
                 x, w, b, eps, dt), iters=5, warmup=1),
             "fwd_library": cuda_ms(lambda: F.layer_norm(
                 x, (h,), lw, lb, eps)),
             "bwd": cuda_ms(lambda: fused_layer_norm_bwd(gy, x, w, eps)),
             "bwd_plain": cuda_ms(lambda: fused_layer_norm_bwd_plain(
                 gy, x, w, eps), iters=5, warmup=1),
             "bwd_library": cuda_ms(lambda: torch.autograd.grad(
                 ly, (lx, lw, lb), gy, retain_graph=True))}
        # x in, y out, scale and bias; g and x in, dx out, scale in and the
        # two [H] sums out: the same work whatever implements it
        (_, fwd_bytes, fwd_bound, _), (_, bwd_bytes, bwd_bound, _) = \
            ln_bounds(n, h, 2)
        geom = launch_geometry(n, h, sms)
        rows.append({"N": n, "H": h, "dtype": "bf16",
                     "launches_per_step": count, **t,
                     "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
                     "grid": geom.grid, "rows_per_team": geom.rows_per_team,
                     "smem_fwd": smem_bytes(geom, h, 2),
                     "smem_bwd": smem_bytes(geom, h, 2, 2)})
        for tot, key, nb in ((fwd, "fwd", fwd_bytes), (bwd, "bwd", bwd_bytes)):
            tot["ms"] += t[key] * count
            tot["plain_ms"] += t[key + "_plain"] * count
            tot["library_ms"] += t[key + "_library"] * count
            tot["nbytes"] += nb * count
        del ly, lx
    print(json.dumps({"layer_norm_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in ((fwd, err_fwd), (bwd, err_bwd)):
        nbytes = tot.pop("nbytes")
        out.append({**tot, "max_abs_err": err, "bound_by": "bytes",
                    "bound_ms": nbytes / PEAK_BYTES * 1e3})
    return out


def mlp_case(n, h, f, dtype, seed):
    """x is a row-offset view, so its base pointer is not the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = r(n + 8, h).to(dtype)[8:]
    w1 = (r(f, h) * h ** -0.5).to(dtype)
    w2 = (r(h, f) * f ** -0.5).to(dtype)
    return x, w1, r(f) * 0.1, w2, r(h) * 0.1, r(n, h).to(dtype)


def gemm_operand(rows, cols, mn, g):
    """A [rows, cols] bf16 operand contracted along `cols`, stored with
    `rows` contiguous when `mn`, else `cols`, in storage padded past the
    extent (the row stride is not the extent)."""
    inner, outer = (rows, cols) if mn else (cols, rows)
    store = torch.randn(outer, (inner + 7) // 8 * 8 + 8, generator=g,
                        device="cuda").to(torch.bfloat16)
    return store[:, :inner].t() if mn else store[:, :inner]


def check_gemm_core(card: str):
    """Phase 3, the wgmma/TMA product core of K5a and K5b alone: C = A B
    against an fp32 product of the same bf16 operands at the four operand
    orders, every extent ragged against the 128 x 128 x 64 tiles (the last
    extents on more tiles than the card has SMs), and at the orders and
    extents of the video tower's five products."""
    cases = [(m, n, k, a_mn, b_mn)
             for m, n, k in ((5, 3, 7), (200, 136, 328), (300, 520, 1000),
                             (4000, 1100, 136))
             for a_mn in (0, 1) for b_mn in (0, 1)]
    cases += [(11712, 3072, 768, 0, 0), (11712, 768, 3072, 0, 0),
              (3072, 768, 11712, 1, 1), (11712, 768, 3072, 0, 1)]
    worst = 0.0
    for i, (m, n, k, a_mn, b_mn) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(700 + i)
        a = gemm_operand(m, k, a_mn, g)
        b = gemm_operand(n, k, b_mn, g).t()
        assert (gemm_operand_major(a, 1), gemm_operand_major(b, 0)) \
            == (a_mn, b_mn)
        c = gemm_bf16(a, b)
        torch.cuda.synchronize()
        ref = torch.matmul(a.float(), b.float())
        share = ((c.float() - ref).abs().max().item()
                 / (MLP_TOL[torch.bfloat16] * ref.abs().max().item()))
        worst = max(worst, share)
        print(f"gemm core M={m} N={n} K={k} A {'MN' if a_mn else 'K'}-major"
              f" B {'MN' if b_mn else 'K'}-major: error {share:.3f} of "
              "tolerance", flush=True)
        if not (share <= 1.0 and bool(torch.isfinite(c.float()).all())):
            raise SystemExit(f"gemm core disagrees at M={m} N={n} K={k} "
                             f"orders ({a_mn}, {b_mn})")
    print(json.dumps({"gemm_core_cases": len(cases),
                      "worst_share_of_tolerance": worst, "card": card}),
          flush=True)


def check_fused_mlp(spec: TAVSpec, card: str):
    """Phase 3, K5a and K5b. Returns the forward's and the backward's entry
    for the kernels line, summed over the 54 launches of one step."""
    towers = mlp_shapes(spec, 8)
    if not all(kernel_supports(h, f, torch.bfloat16)
               for _, _, h, f, _ in towers):
        raise SystemExit("a full-width MLP is outside the kernels' shape rule")
    cases = [(name, n, h, f, torch.bfloat16, "gelu")
             for name, n, h, f, _ in towers]
    cases += [("small", 300, 256, 512, dt, act)
              for dt in (torch.float32, torch.bfloat16) for act in ACTS]
    cases += [("ragged", n, h, f, torch.bfloat16, act)
              for n, h, f, act in ((1, 256, 64, "gelu"),
                                   (17, 512, 192, "gelu_new"),
                                   (129, 768, 320, "relu"),
                                   (129, 1024, 256, "tanh"))]
    cases.append(("fp32_wide", 300, 768, 3072, torch.float32, "gelu"))
    err_fwd = err_bwd = 0.0
    for i, (name, n, h, f, dt, act) in enumerate(cases):
        x, w1, b1, w2, b2, do = mlp_case(n, h, f, dt, 500 + i)
        out = fused_mlp_fwd(x, w1, b1, w2, b2, act)
        got = fused_mlp_bwd(x, w1, b1, w2, do, act)
        again = fused_mlp_bwd(x, w1, b1, w2, do, act)
        torch.cuda.synchronize()
        out0 = fused_mlp_fwd_plain(x, w1, b1, w2, b2, act)
        want = fused_mlp_bwd_plain(x, w1, b1, w2, do, act)
        shares, worst = {}, 0.0
        names = ("out", "dx", "dw1", "db1", "dw2", "db2")
        for key, a, ref in zip(names, (out,) + got, (out0,) + want):
            tol = (MLP_BIAS_TOL if key.startswith("db") else MLP_TOL)[dt]
            d = (a.float() - ref.float()).abs().max().item()
            shares[key] = d / (tol * ref.float().abs().max().item())
            if key == "out":
                err_fwd = max(err_fwd, d)
            else:
                err_bwd = max(err_bwd, d)
            worst = max(worst, shares[key])
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (out,) + got)
        print(f"fused_mlp {name:9s} {str(dt)[6:]:8s} {act:8s} N={n} H={h} "
              f"F={f}: error as a share of tolerance "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
              + f" (tol {MLP_TOL[dt]} of max, biases {MLP_BIAS_TOL[dt]}); "
              f"two runs equal {same}", flush=True)
        if not (finite and same and worst <= 1.0):
            raise SystemExit(f"fused mlp disagrees with its plain version "
                             f"on case {name} {dt} {act}")

    totals = [dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, nbytes=0)
              for _ in range(2)]
    rows = []
    for i, (name, n, h, f, layers) in enumerate(towers):
        x, w1, b1, w2, b2, do = mlp_case(n, h, f, torch.bfloat16, 600 + i)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, w1, b1.bfloat16(), w2, b2.bfloat16())]

        def unfused():
            lx, lw1, lb1, lw2, lb2 = leaves
            return F.linear(F.gelu(F.linear(lx, lw1, lb1)), lw2, lb2)

        lib_out = unfused()
        t = {"fwd": cuda_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2)),
             "fwd_plain": cuda_ms(lambda: fused_mlp_fwd_plain(
                 x, w1, b1, w2, b2), iters=3, warmup=1),
             "fwd_library": cuda_ms(unfused),
             "bwd": cuda_ms(lambda: fused_mlp_bwd(x, w1, b1, w2, do),
                            iters=10),
             "bwd_plain": cuda_ms(lambda: fused_mlp_bwd_plain(
                 x, w1, b1, w2, do), iters=3, warmup=1),
             "bwd_library": cuda_ms(lambda: torch.autograd.grad(
                 lib_out, leaves, do, retain_graph=True))}
        bounds = mlp_bounds(n, h, f, 2)
        rows.append({"shape": name, "N": n, "H": h, "F": f, "dtype": "bf16",
                     "launches_per_step": layers, **t,
                     "fwd_bound_ms": bounds[0][2], "fwd_bound_by": bounds[0][3],
                     "bwd_bound_ms": bounds[1][2], "bwd_bound_by": bounds[1][3],
                     "fwd_tflops": bounds[0][0] / t["fwd"] / 1e9,
                     "bwd_tflops": bounds[1][0] / t["bwd"] / 1e9})
        for tot, key, (flops, nbytes, _, _) in zip(totals, ("fwd", "bwd"),
                                                   bounds):
            tot["ms"] += t[key] * layers
            tot["plain_ms"] += t[key + "_plain"] * layers
            tot["library_ms"] += t[key + "_library"] * layers
            tot["flops"] += flops * layers
            tot["nbytes"] += nbytes * layers
        del lib_out, leaves
    print(json.dumps({"fused_mlp_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in zip(totals, (err_fwd, err_bwd)):
        flops, nbytes = tot.pop("flops"), tot.pop("nbytes")
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out.append({**tot, "max_abs_err": err,
                    "bound_ms": max(by_ops, by_bytes) * 1e3,
                    "bound_by": "operations" if by_ops >= by_bytes
                    else "bytes"})
    return out



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
    """Phase 4. Returns the flash launches of the bf16 (served) run and the
    launches of the bf16 run with both knobs on."""
    spec = TAVSpec(output_dim=7)
    ln_per_chunk = sum(fused_ln_shapes(spec, 8).values())
    t0 = time.perf_counter()
    state = from_flax(init_params(spec, SEED))
    n_params = sum(v.numel() for v in state.values())
    print(f"weights: {n_params / 1e6:.1f} M parameters drawn and converted "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served_launches = served_fused = None
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

        # the same requests with MME_FUSED_LN=1 and MME_FUSED_MLP=1
        with knobs_on():
            serve(pred, reqs[:1])                   # warm-up
            kernels.reset_launches()
            fused = serve(pred, reqs)
            count = dict(kernels.LAUNCHES)
        diff_f = max(float(np.abs(a - b).max()) for a, b in zip(fused, got))
        finite_f = all(np.isfinite(p).all() for p in fused)
        print(f"serve {leg}, both knobs on: launches {count} (expected "
              f"{LAUNCHES_PER_CHUNK * chunks} flash_fwd and fused_mlp_fwd, "
              f"{ln_per_chunk * chunks} layer_norm_fwd, no backward); "
              f"max|probs - probs(knobs off)| = {diff_f:.3e} (tol "
              f"{SERVE_TOL[dtype]}); finite {finite_f}", flush=True)
        if not (finite_f and diff_f <= SERVE_TOL[dtype]
                and count["flash_fwd"] == count["fused_mlp_fwd"]
                == LAUNCHES_PER_CHUNK * chunks
                and count["layer_norm_fwd"] == ln_per_chunk * chunks
                and count["flash_bwd"] == count["fused_mlp_bwd"]
                == count["layer_norm_bwd"] == 0):
            raise SystemExit(f"serving with both knobs on failed in the "
                             f"{leg} leg")
        if dtype == torch.bfloat16:
            served_launches = launches
            served_fused = {k: v // chunks for k, v in count.items()}
            one = reqs[0]
            times = []
            for _ in range(5):
                t = time.perf_counter()
                pred(one)
                times.append(time.perf_counter() - t)
            ms = float(np.median(times)) * 1e3
            with knobs_on():
                times_f = []
                for _ in range(5):
                    t = time.perf_counter()
                    pred(one)
                    times_f.append(time.perf_counter() - t)
            print(json.dumps({"serve_bf16": {
                "ms_per_batch_of_8": ms, "utt_per_s": 8e3 / ms,
                "times_ms": [x * 1e3 for x in times],
                "ms_per_batch_of_8_knobs_on":
                    float(np.median(times_f)) * 1e3,
                "times_ms_knobs_on": [x * 1e3 for x in times_f],
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "card": card}}), flush=True)
        del pred, model
        torch.cuda.empty_cache()
    return served_launches, served_fused


def train_inputs(spec: TAVSpec, batch_size: int, seed: int):
    batch = example_tav_batch(spec, batch_size, 70, 96000, seed=seed)
    batch["text_mask"][1::3, 40:] = 0
    batch["audio_mask"][1::2, 60000:] = 0
    labels = np.arange(batch_size) % 7
    return (batch, labels, np.ones(batch_size, np.int32),
            np.ones(7, np.float32))


def without_noise(spec: TAVSpec) -> TAVSpec:
    """Every dropout rate and SpecAugment probability 0."""
    def quiet(e):
        return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        spec, dropout=0.0,
        text=dataclasses.replace(spec.text, encoder=quiet(spec.text.encoder)),
        audio=dataclasses.replace(spec.audio, mask_time_prob=0.0,
                                  mask_feature_prob=0.0,
                                  encoder=quiet(spec.audio.encoder)),
        video=dataclasses.replace(spec.video,
                                  encoder=quiet(spec.video.encoder)),
        fusion=quiet(spec.fusion))


def tower_norms(model, grads):
    """Global gradient norm per top-level tower."""
    groups = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        parts = name.split(".")
        key = parts[0] if parts[0] != "model" else parts[1]
        groups.setdefault(key, []).append(g)
    return {k: global_norm_f32(v).item() for k, v in groups.items()}


def train_check_fp32(params, card: str):
    """Phase 5 (1): loss and gradients of one batch, kernels against
    MME_FLASH=0, fp32 compute, no dropout, full depth, batch 4."""
    spec = dataclasses.replace(without_noise(TAVSpec(output_dim=7)),
                               share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=4, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    model, state, _, _ = build_tav(spec, cfg, 1000, params=params,
                                   remat=False, use_accum=False,
                                   device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 4, SEED + 20)
    batch = to_device(batch, "cuda")
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    model.train()

    def loss_and_grads():
        kernels.reset_launches()
        loss = cross_entropy(model(batch), labels, cw, mask)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, state.params)]
        torch.cuda.synchronize()
        return (loss.item(), global_norm_f32(grads).item(),
                tower_norms(model, grads), dict(kernels.LAUNCHES))

    loss, norm, towers, count = loss_and_grads()
    os.environ["MME_FLASH"] = "0"
    try:
        loss0, norm0, towers0, count0 = loss_and_grads()
    finally:
        del os.environ["MME_FLASH"]
    with knobs_on():
        loss_f, norm_f, towers_f, count_f = loss_and_grads()
    rel = {k: abs(towers[k] - towers0[k]) / max(towers0[k], 1e-12)
           for k in towers0}
    rel_f = {k: abs(towers_f[k] - towers[k]) / max(towers[k], 1e-12)
             for k in towers}
    n_ln = sum(fused_ln_shapes(spec, 4).values())
    print(json.dumps({"train_check_fp32": {
        "batch": 4, "loss": loss, "loss_plain": loss0, "grad_norm": norm,
        "grad_norm_plain": norm0, "tower_norms": towers,
        "tower_norm_rel_diff": rel, "launches": count,
        "launches_plain": count0, "loss_knobs_on": loss_f,
        "grad_norm_knobs_on": norm_f,
        "tower_norm_rel_diff_knobs_on_vs_off": rel_f,
        "launches_knobs_on": count_f, "expected_layer_norm_launches": n_ln,
        "card": card}}), flush=True)
    ok_f = (np.isfinite(loss_f) and abs(loss_f - loss) <= TRAIN_LOSS_RTOL
            * abs(loss) and abs(norm_f - norm) <= TRAIN_NORM_RTOL * norm
            and max(rel_f.values()) <= TRAIN_NORM_RTOL
            and count_f["flash_fwd"] == count_f["flash_bwd"]
            == count_f["fused_mlp_fwd"] == count_f["fused_mlp_bwd"]
            == LAUNCHES_PER_CHUNK
            and count_f["layer_norm_fwd"] == count_f["layer_norm_bwd"] == n_ln
            and count["fused_mlp_fwd"] == count["layer_norm_fwd"] == 0)
    if not ok_f:
        raise SystemExit("training check with both knobs on against both "
                         "off failed")
    ok = (np.isfinite(loss) and abs(loss - loss0) <= TRAIN_LOSS_RTOL
          * abs(loss0) and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0
          and max(rel.values()) <= TRAIN_NORM_RTOL
          and count["flash_fwd"] == count["flash_bwd"] == LAUNCHES_PER_CHUNK
          and count0["flash_fwd"] == count0["flash_bwd"] == 0)
    if not ok:
        raise SystemExit("training check against MME_FLASH=0 failed")


def train_descends_bf16(params, card: str):
    """Phase 5 (2): a few steps on one fixed batch with dropout off. The
    model is deterministic, so the eval loss after the last update is the
    next point of the same series; it must lie below the first loss."""
    spec = dataclasses.replace(
        without_noise(TAVSpec(output_dim=7)).with_compute_dtype(
            torch.bfloat16), share_audio_frontend=True)
    lr = 5e-6
    cfg = ExperimentConfig(batch_size=8, learning_rate=lr, text_max_len=70,
                           audio_max_samples=96000)
    model, state, train_step, eval_step = build_tav(
        spec, cfg, 1000, params=params, remat=False, use_accum=False,
        device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 30)
    losses = []
    for _ in range(4):
        state, loss, cm, _ = train_step(state, batch, labels, mask, cw, 1.0,
                                        True, SEED)
        losses.append(loss.item())
    ev_loss, ev_cm, preds = eval_step(batch, labels, mask, cw)
    losses.append(ev_loss.item())
    print(json.dumps({"train_descends_bf16": {
        "lr": lr, "losses": losses, "cm_sum": int(cm.sum()),
        "card": card}}), flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and int(cm.sum()) == 8 and int(ev_cm.sum()) == 8
            and preds.shape == (8,)):
        raise SystemExit("the deterministic bf16 training leg did not "
                         "lower its loss")


def train_bench(params, card: str):
    """Phase 5 (3), (4) and (5): the benchmark configuration, the same
    state with MME_FUSED_ADAM=1, and the same state with MME_FUSED_LN=1 and
    MME_FUSED_MLP=1. Returns the launches of one timed step of each leg."""
    spec = dataclasses.replace(
        TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=8, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    os.environ["MME_OPT_STATE"] = "bf16"
    try:
        model, state, train_step, _ = build_tav(
            spec, cfg, 1000, params=params, remat=False, use_accum=False,
            device="cuda")
    finally:
        del os.environ["MME_OPT_STATE"]
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 40)
    batch = to_device(batch, "cuda")
    before = [p.detach().clone() for p in state.params[:8]]
    n_trainable = sum(m is not None for m in state.opt_state.mu)
    n_ln = sum(fused_ln_shapes(spec, 8).values())
    fused_names = ("fused_mlp_fwd", "fused_mlp_bwd", "layer_norm_fwd",
                   "layer_norm_bwd")

    def run(steps):
        out, times, counts = [], [], []
        for _ in range(steps):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss, cm, gnorm = train_step(state, batch, labels, mask, cw,
                                            1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            out.append((loss.item(), gnorm.item()))
            counts.append(dict(kernels.LAUNCHES))
        return out, times, counts

    # forward / backward / optimizer split of the same step, by hand with
    # the step's own pieces and CUDA events
    tx = make_optimizer(cosine_warm_restarts(5e-6, cfg.T_max, 1000),
                        cfg.weight_decay, cfg.clip, None, "bf16")
    labels_t, mask_t, cw_t = (torch.as_tensor(x, device="cuda")
                              for x in (labels, mask, cw))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def split_ms():
        split = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            model.train()
            ev[0].record()
            loss = cross_entropy(model(batch, rng=gen), labels_t, cw_t,
                                 mask_t)
            ev[1].record()
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, state.params)]
            ev[2].record()
            tx.update(state.params, grads, state.opt_state, gen)
            ev[3].record()
            torch.cuda.synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        return [float(x) for x in np.median(np.array(split), axis=0)]

    def device_kernels():
        """Device kernels (and copies) per step, from a profiler window of
        two steps after a one-step window that warms the profiler."""
        for steps in (1, 2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                run(steps)
        return sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) // 2

    run(2)                                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, times, counts = run(4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_kernels = device_kernels()
    moved = max((a - b.detach()).abs().max().item()
                for a, b in zip(before, state.params[:8]))
    moments_bf16 = all(m.dtype == torch.bfloat16
                       for m in state.opt_state.mu + state.opt_state.nu)
    ms = float(np.median(times))
    ok = (all(np.isfinite(x) for r in res for x in r) and moved > 0
          and moments_bf16 and all(
              c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
              and c["adam_update"] == 0
              and all(c[k] == 0 for k in fused_names) for c in counts))
    print(json.dumps({"train_bf16": {
        "ms_per_step": ms, "utt_per_s": 8e3 / ms, "times_ms": times,
        "losses": [r[0] for r in res], "grad_norms": [r[1] for r in res],
        "max_memory_allocated_gb": peak, "launches_per_step": counts[-1],
        "device_kernels_per_step": n_kernels, "params_moved": moved,
        "moments_bf16": moments_bf16, "card": card}}), flush=True)
    if not ok:
        raise SystemExit("the bf16 training leg failed its checks")
    (fwd, bwd, opt) = split_ms()
    print(json.dumps({"train_bf16_split_ms": {
        "forward": fwd, "backward": bwd, "optimizer_unfused": opt,
        "card": card}}), flush=True)

    # (4) one K3 launch per step over every trainable leaf, the moments
    # updated in place from the first fused step on
    os.environ["MME_FUSED_ADAM"] = "1"
    try:
        run(1)
        moments = [m for m in state.opt_state.mu + state.opt_state.nu
                   if m is not None]
        ptrs = [m.data_ptr() for m in moments]
        torch.cuda.reset_peak_memory_stats()
        leaves0 = adam_update.LEAVES_FUSED
        res_f, times_f, counts_f = run(3)
        covered = (adam_update.LEAVES_FUSED - leaves0) / 3
        peak_f = torch.cuda.max_memory_allocated() / 1e9
        kept = [m.data_ptr() for m in state.opt_state.mu
                + state.opt_state.nu if m is not None] == ptrs and all(
            m.dtype == torch.bfloat16 for m in moments)
        n_kernels_f = device_kernels()
        (fwd_f, bwd_f, opt_fused) = split_ms()
    finally:
        del os.environ["MME_FUSED_ADAM"]
    del moments
    ms_f = float(np.median(times_f))
    print(json.dumps({"train_bf16_fused_adam": {
        "ms_per_step": ms_f, "ms_per_step_unfused": ms, "times_ms": times_f,
        "losses": [r[0] for r in res_f], "trainable_leaves": n_trainable,
        "leaves_covered_per_step": covered,
        "moments_bf16_in_place": kept,
        "launches_per_step": counts_f[-1],
        "device_kernels_per_step": n_kernels_f,
        "device_kernels_per_step_unfused": n_kernels,
        "max_memory_allocated_gb": peak_f,
        "max_memory_allocated_gb_unfused": peak,
        "split_ms": {"forward": fwd_f, "backward": bwd_f,
                     "optimizer_fused": opt_fused},
        "optimizer_unfused_ms": opt, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_f for x in r) and all(
            c["adam_update"] == 1
            and c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
            for c in counts_f) and covered == n_trainable and kept
            and abs(peak_f - peak) <= 0.2):
        raise SystemExit("the MME_FUSED_ADAM=1 training leg failed")

    # (5) the same state and batch with both knobs on
    torch.cuda.empty_cache()
    with knobs_on():
        run(2)                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        res_k, times_k, counts_k = run(4)
        peak_k = torch.cuda.max_memory_allocated() / 1e9
        (fwd_k, bwd_k, opt_k) = split_ms()
    ms_k = float(np.median(times_k))
    print(json.dumps({"train_bf16_knobs_on": {
        "knobs": KNOBS, "ms_per_step": ms_k, "ms_per_step_knobs_off": ms,
        "utt_per_s": 8e3 / ms_k, "times_ms": times_k,
        "losses": [r[0] for r in res_k], "grad_norms": [r[1] for r in res_k],
        "max_memory_allocated_gb": peak_k,
        "max_memory_allocated_gb_knobs_off": peak,
        "split_ms": {"forward": fwd_k, "backward": bwd_k,
                     "optimizer_unfused": opt_k},
        "split_ms_knobs_off": {"forward": fwd, "backward": bwd,
                               "optimizer_unfused": opt},
        "launches_per_step": counts_k[-1],
        "expected_layer_norm_launches": n_ln, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_k for x in r) and all(
            c["flash_fwd"] == c["flash_bwd"] == c["fused_mlp_fwd"]
            == c["fused_mlp_bwd"] == LAUNCHES_PER_CHUNK
            and c["layer_norm_fwd"] == c["layer_norm_bwd"] == n_ln
            and c["adam_update"] == 0 for c in counts_k)):
        raise SystemExit("the training leg with both knobs on failed")
    return counts[-1], counts_f[-1], counts_k[-1], ms_f


def train_path(card: str):
    """Phase 5. Returns the flax tree, the launches of one step of the bf16
    leg, of the fused-Adam leg and of the leg with both knobs on, and the
    fused-Adam leg's ms per step."""
    t0 = time.perf_counter()
    params = init_params(dataclasses.replace(TAVSpec(output_dim=7),
                                             share_audio_frontend=True), SEED)
    print(f"train weights drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for leg in (train_check_fp32, train_descends_bf16):
        t0 = time.perf_counter()
        leg(params, card)
        torch.cuda.empty_cache()
        print(f"{leg.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return (params, *train_bench(params, card))


# phase 6: the loop at full width. Train, validation and test utterances
# with their seeds; the train split's dialogs hold 16 utterances, so epoch 1
# (dialog accumulation) applies one update per two batches of 8
LOOP_SIZES = ((32, 0), (8, 1), (8, 2))
LOOP_DIALOG = 16
LOOP_CFG = dict(batch_size=8, epoch=2, log_val=2, patience=10,
                learning_rate=5e-6, mask=True, output_dim=7,
                dataset="synthetic", seed=SEED)
LOOP_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1"}
# 8 train steps, 6 applied updates (4 in epoch 0, 2 in epoch 1), 4
# validations of one batch and one test batch
LOOP_STEPS, LOOP_UPDATES, LOOP_EVAL_BATCHES = 8, 6, 5
# eval-only against the trained run's test pass: the same weights, masks
# and kernels (no atomics); the loss is a mean of fp32 values
EVAL_ONLY_RTOL = 1e-6


class TimedCheckpoints(CheckpointManager):
    """The loop's checkpoint manager with host times: the blocking part of
    each ``save_best`` and each ``restore_best`` (the ``wait()`` they start
    with counted apart) and each ``wait()``; whether every saved state was
    stripped of its accumulation buffer; the target of the last restore,
    which is the state the loop returns."""

    def __init__(self, directory: str):
        super().__init__(directory)
        self.ms = {"save_best": [], "wait": [], "restore_best": []}
        self.stripped = []
        self.returned = None

    def _timed(self, key, fn, *args):
        n = len(self.ms["wait"])
        t = time.perf_counter()
        out = fn(*args)
        self.ms[key].append((time.perf_counter() - t) * 1e3
                            - sum(self.ms["wait"][n:]))
        return out

    def wait(self):
        t = time.perf_counter()
        super().wait()
        self.ms["wait"].append((time.perf_counter() - t) * 1e3)

    def save_best(self, state, meta):
        self.stripped.append(state.accum_grads is None)
        self._timed("save_best", super().save_best, state, meta)

    def restore_best(self, target_state):
        self.returned = target_state
        return self._timed("restore_best", super().restore_best,
                           target_state)


def empty_state_like(state: TrainState) -> TrainState:
    """A state of the same structure in new, uninitialised tensors."""
    def like(xs):
        return None if xs is None else [
            None if x is None else torch.empty_like(x) for x in xs]
    o = state.opt_state
    return TrainState(
        step=-1, params=like(state.params), accum_grads=None,
        opt_state=AdamWState(count=-1, mu=like(o.mu), nu=like(o.nu),
                             seed=-1, nu_row=like(o.nu_row),
                             nu_col=like(o.nu_col)),
        names=state.names)


def state_diff(a: TrainState, b: TrainState) -> list:
    """What differs between two states, bit for bit: counters by name,
    tensor groups by how many tensors differ."""
    out = [k for k, x, y in (("step", a.step, b.step),
                             ("count", a.opt_state.count, b.opt_state.count),
                             ("seed", a.opt_state.seed, b.opt_state.seed))
           if x != y]
    groups = (("params", a.params, b.params),
              *((k, getattr(a.opt_state, k), getattr(b.opt_state, k))
                for k in ("mu", "nu", "nu_row", "nu_col")))
    for key, xs, ys in groups:
        if xs is None or ys is None:
            if xs is not ys:
                out.append(key)
            continue
        bad = sum((x is None) != (y is None) or (
            x is not None and not torch.equal(x, y)) for x, y in zip(xs, ys))
        if bad or len(xs) != len(ys):
            out.append(f"{key}: {bad} of {len(xs)}")
    return out


def loop_inputs(params, spec: TAVSpec, device: str, text_len: int,
                audio_len: int):
    """A model with ``params`` and the synthetic train, validation and test
    splits of phase 6."""
    (n_train, s_train), *evals = LOOP_SIZES
    train_ds = synthetic_tav_dataset(spec, n_train, text_len, audio_len,
                                     seed=s_train, dialog_size=LOOP_DIALOG)
    val_ds, test_ds = (synthetic_tav_dataset(spec, n, text_len, audio_len,
                                             seed=s) for n, s in evals)
    model = TAVModel(spec, device=device)
    model.load_state_dict(from_flax(params), strict=True)
    return model, train_ds, val_ds, test_ds


def busy_share(prof, wall_s: float) -> float:
    """The share of ``wall_s`` in which the device ran anything: the union
    of the device events' spans in a profiler window."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6 / wall_s


def profiled_epoch(params, spec: TAVSpec) -> dict:
    """One epoch of ``run_classifier`` as phase 6 runs it (4 steps, 2
    validations and their saves, the best reload, then the test pass)
    under ``torch.profiler`` with device activity only: its wall time and
    the device's busy share of it."""
    directory = tempfile.mkdtemp(prefix="mme_loop_prof_")
    try:
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1),
                               checkpoint_dir=directory, text_max_len=70,
                               audio_max_samples=96000)
        model, *data = loop_inputs(params, spec, "cuda", 70, 96000)
        transform = make_video_keep_transform(spec, random_mask=True)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run_classifier(cfg, model, *data, batch_transform=transform,
                           device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return {"wall_s": wall, "device_busy_share": busy_share(prof, wall)}


def loop_run(params, spec: TAVSpec, device: str, directory: str,
             text_len: int = 70, audio_len: int = 96000) -> dict:
    """Phase 6's runs on ``device`` (the CPU runs them at a tiny size):
    ``run_classifier`` trains and tests; the best checkpoint is restored
    into fresh tensors; a save is followed by a train step before its
    ``wait()``; ``MME_EVAL_ONLY=1`` tests the checkpoint again. Checks all
    but the kernel launches and returns what it measured."""
    cfg = ExperimentConfig(**LOOP_CFG, checkpoint_dir=directory,
                           text_max_len=text_len, audio_max_samples=audio_len)
    model, train_ds, val_ds, test_ds = loop_inputs(
        params, spec, device, text_len, audio_len)
    n_train = len(train_ds)
    transform = make_video_keep_transform(spec, random_mask=True)
    ckpts = TimedCheckpoints(directory)

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                             batch_transform=transform, checkpoints=ckpts,
                             device=device)
    loop_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    train_logs = [d for d in logs if "train/loss" in d]
    losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                           "test/loss") if k in d]
    state = ckpts.returned

    # the best checkpoint into fresh tensors
    fresh = empty_state_like(state)
    t = time.perf_counter()
    ckpts.restore_best(fresh)
    round_trip = state_diff(fresh, state)

    # the in-place trap: one more step rewrites parameters and moments
    # while the save is in flight
    ckpts.save_best(state, {"epoch": cfg.epoch, "step": state.step,
                            "val_loss": 0.0})
    tx = make_optimizer(cosine_warm_restarts(cfg.learning_rate, cfg.T_max,
                                             n_train // cfg.batch_size),
                        cfg.weight_decay, cfg.clip)
    batch, labels, mask, _ = next(batches(train_ds, np.arange(n_train),
                                          cfg.batch_size))
    batch = transform(torch.Generator(device=device).manual_seed(SEED),
                      to_device(batch, device))
    make_train_step(model, tx, num_classes=cfg.output_dim)(
        state, batch, labels, mask, np.ones(cfg.output_dim, np.float32),
        1.0, True, SEED)
    stepped = [k for k in state_diff(state, fresh)
               if k.startswith(("params", "mu", "nu"))]
    ckpts.wait()
    ckpts.restore_best(state)
    trap = state_diff(state, fresh)
    del fresh

    os.environ["MME_EVAL_ONLY"] = "1"
    os.environ["MME_RUN_DIR"] = os.path.join(directory, "eval_only")
    try:
        again = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                               batch_transform=transform, device=device)
    finally:
        del os.environ["MME_EVAL_ONLY"], os.environ["MME_RUN_DIR"]
    eval_rel = (abs(again["test/loss"] - summary["test/loss"])
                / abs(summary["test/loss"]))
    out = {
        "loop_s": loop_s, "launches": launches,
        "utt_per_s_loop": [d["train/steps_per_sec"] * cfg.batch_size
                           for d in train_logs],
        "epochs": [d["epoch"] for d in train_logs],
        "losses": losses, "test_loss": summary["test/loss"],
        "saved_states_stripped": ckpts.stripped,
        "round_trip_diff": round_trip, "in_place_step_changed": stepped,
        "in_place_trap_diff": trap, "eval_only_loss_rel_diff": eval_rel,
        "eval_only_same_matrix": (again["test/confusion_matrix"]
                                  == summary["test/confusion_matrix"]),
        "checkpoint_gb": os.path.getsize(os.path.join(
            ckpts.best_path, STATE_FILE)) / 1e9,
        "save_best_ms": ckpts.ms["save_best"], "wait_ms": ckpts.ms["wait"],
        "restore_best_ms": ckpts.ms["restore_best"]}
    ok = (all(np.isfinite(losses)) and sorted(set(out["epochs"])) == [0, 1]
          and len([d for d in logs if "val/loss" in d]) == 4
          and len(ckpts.stripped) >= 2 and all(ckpts.stripped)
          and not round_trip and stepped and not trap
          and out["eval_only_same_matrix"] and eval_rel <= EVAL_ONLY_RTOL)
    if not ok:
        print(json.dumps({"train_loop_failed": out}), flush=True)
        raise SystemExit("the training loop phase failed its checks")
    return out


def train_loop(params, card: str, step_ms: float) -> dict:
    """Phase 6 on the card. Returns the kernel launches of the loop's run."""
    t0 = time.perf_counter()
    spec = dataclasses.replace(
        TAVSpec(output_dim=7, dropout=0.1).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    directory = tempfile.mkdtemp(prefix="mme_loop_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    os.environ.update(LOOP_ENV)
    try:
        torch.cuda.reset_peak_memory_stats()
        out = loop_run(params, spec, "cuda", directory)
        peak = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
        epoch = profiled_epoch(params, spec)
    finally:
        for k in LOOP_ENV:
            del os.environ[k]
        shutil.rmtree(directory, ignore_errors=True)
    n = out["launches"]
    want = {"flash_fwd": LAUNCHES_PER_CHUNK * (LOOP_STEPS + LOOP_EVAL_BATCHES),
            "flash_bwd": LAUNCHES_PER_CHUNK * LOOP_STEPS,
            "adam_update": LOOP_UPDATES}
    print(json.dumps({"train_loop": {
        **out, "expected_launches": want,
        "bare_step_ms_fused_adam": step_ms,
        "utt_per_s_bare_step": 8e3 / step_ms,
        "profiled_epoch": epoch,
        "max_memory_allocated_gb": peak, "free_disk_gb_before": free_gb,
        "phase_s": time.perf_counter() - t0, "card": card}}), flush=True)
    if any(n.get(k, 0) != v for k, v in want.items()):
        raise SystemExit("the training loop did not launch K1, K2 and K3 "
                         "as its steps and updates need")
    return n


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
    logs = kernels.build(["flash_fwd", "flash_bwd", "fused_mlp",
                          "layer_norm", "adam_update"])
    print(f"build: {time.perf_counter() - t0:.1f} s\n{logs['flash_fwd']}\n"
          f"{logs['flash_bwd']}", flush=True)
    print(json.dumps({"fused_mlp_ptxas": ptxas_summary(logs["fused_mlp"])}),
          flush=True)
    print(json.dumps({"flash_ptxas": {name: kernel_ptxas(logs[name])
                                      for name in ("flash_fwd", "flash_bwd")}}),
          flush=True)
    print(json.dumps({"layer_norm_ptxas": kernel_ptxas(logs["layer_norm"])}),
          flush=True)
    print(json.dumps({"adam_update_ptxas": kernel_ptxas(logs["adam_update"])}),
          flush=True)

    spec = TAVSpec(output_dim=7)
    fwd_err, fwd_shapes = check_flash(card)
    bwd_err, bwd_shapes = check_flash_bwd(card)
    # the trained model shares its audio frontend: one conv stack's leaves
    train_spec = dataclasses.replace(spec, share_audio_frontend=True)
    adam_err, adam = check_adam(train_spec, card)
    ln_fwd, ln_bwd = check_layer_norm(train_spec, card)
    check_gemm_core(card)
    mlp_fwd, mlp_bwd = check_fused_mlp(train_spec, card)
    served, served_knobs = main_path(card)
    params, step, step_fused, step_knobs, step_ms = train_path(card)
    torch.cuda.empty_cache()
    loop = train_loop(params, card, step_ms)

    def entry(name, route, source, replaces, result):
        """A kernel of this slice: launches of one training step with both
        knobs on (and of one served chunk for a forward kernel); times and
        bound summed over those launches."""
        out = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": step_knobs[name], **result}
        if name.endswith("_fwd"):
            out["launches_serve_chunk"] = served_knobs[name]
        return out

    def flash_entry(name, source, replaces, shapes, per, err, launches):
        total = {k: sum(r[k] * r[per] for r in shapes)
                 for k in ("ms", "plain_ms", "library_ms")}
        flops = sum(r["gflop"] * r[per] for r in shapes) * 1e9
        nbytes = sum(r["mbytes"] * r[per] for r in shapes) * 1e6
        # times and bound: the 54 launches of one chunk or step of 8
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, **launches,
                **total,
                "bound_ms": max(flops / PEAK_BF16_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3,
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                             >= nbytes / PEAK_BYTES else "bytes")}

    print(json.dumps({"kernels": [
        flash_entry("flash_fwd", "mme_tpu_torch/csrc/flash_fwd.cu",
                    "mme_tpu/ops/flash_attention.py:125", fwd_shapes,
                    "launches_per_chunk", fwd_err,
                    {"launches": served,
                     "launches_train_step": step["flash_fwd"],
                     "launches_train_loop": loop["flash_fwd"]}),
        flash_entry("flash_bwd", "mme_tpu_torch/csrc/flash_bwd.cu",
                    "mme_tpu/ops/flash_attention.py:184", bwd_shapes,
                    "launches_per_step", bwd_err,
                    {"launches": step["flash_bwd"],
                     "launches_train_loop": loop["flash_bwd"]}),
        # times and bound: one call over every trainable leaf of one step
        {"name": "adam_update", "route": "cuda",
         "source": "mme_tpu_torch/csrc/adam_update.cu",
         "replaces": "mme_tpu/ops/adam_update.py:67",
         "launches": step_fused["adam_update"],
         "launches_train_loop": loop["adam_update"], "max_abs_err": adam_err,
         "ms": adam["all"]["ms"], "plain_ms": adam["all"]["plain_ms"],
         "library_ms": None, "bound_ms": adam["all"]["bound_ms"],
         "bound_by": adam["all"]["bound_by"],
         "kernel_ms": adam["all"]["kernels_ms"],
         "host_us": adam["all"]["host_us"], "leaves": adam["all"]["leaves"],
         "big_leaves_ms": adam["big"]["ms"]},
        entry("layer_norm_fwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:63", ln_fwd),
        entry("layer_norm_bwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:73", ln_bwd),
        entry("fused_mlp_fwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:105", mlp_fwd),
        entry("fused_mlp_bwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:116", mlp_bwd)]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
