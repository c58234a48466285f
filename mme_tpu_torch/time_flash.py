"""Time the flash-attention kernels alone at the four full-width shapes.

A short loop for iterating on ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``.
For each attention call of a served chunk or train step of the TAV model at
batch 8 (bf16; q, k, v as strided views of a fused QKV tensor, the key-mask
bias of the text, audio and fusion towers) it prints, as one JSON line:

- the forward (K1) and backward (K2) wrapper per call by CUDA events (20
  calls after 3 warm-up), with TFLOP/s and the bound
  (``ops/flash_attention.py::bounds``);
- the host time of a wrapper call (µs on the host clock over 200 calls
  queued back to back, before the device is waited for), and for the
  forward also through ``FlashAttention.apply`` without gradients, through
  the operator ``mme_tpu_torch::flash_fwd`` alone, and through the same
  wrapper registered as a ``torch.library.custom_op`` instead
  (:func:`route_host_us`);
- each kernel a wrapper call starts, in launch order, by its device time in
  a ``torch.profiler`` trace (5 calls, each after a marker kernel;
  :func:`kernel_ms`, which ``time_fused_mlp.py`` uses too);
- ``scaled_dot_product_attention`` forward and its autograd backward on the
  same inputs, as yardsticks the port never calls;
- the sums over the 54 launches of a chunk or step: wrapper, kernels
  alone, SDPA and the bound.

``--parent DIR`` also times another checkout (the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists) in a process of
its own, this file run against that checkout's package, in turns parent,
this tree, this tree, parent, so that both are timed on one card.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.time_flash
[--parent _archive]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mme_tpu_torch.device import card_line
from mme_tpu_torch.ops import flash_attention
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.flash_attention import (FlashAttention,
                                               flash_attention_bwd,
                                               flash_attention_fwd)

# (tower, batch, sequence, heads, launches per chunk or step), head_dim 64
SHAPES = (("text", 8, 70, 12, 6), ("audio", 8, 299, 16, 24),
          ("video", 8, 1464, 12, 12), ("fusion", 8, 473, 12, 12))
D = 64


def event_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` by CUDA events, after one warm-up."""
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


def kernel_ms(fn, iters: int = 5, tries: int = 3) -> list:
    """Device ms of each kernel one call of ``fn`` starts, in launch order,
    averaged over ``iters`` calls of a profiler trace. A short spin kernel
    (``torch.cuda._sleep``) marks the start of every call, and only calls
    whose kernels all reached the trace are counted: the trace sometimes
    misses kernels at the start of its window."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        kern = sorted((e for e in events if e.get("cat") == "kernel"),
                      key=lambda e: e["ts"])
        calls, cur = [], None
        for e in kern:
            if "spin_kernel" in e["name"]:
                if cur is not None:
                    calls.append(cur)
                cur = []
            elif cur is not None:
                cur.append(e)
        names = [tuple(e["name"] for e in c) for c in calls]
        if names:
            usual = max(set(names), key=names.count)
            whole = [c for c, n in zip(calls, names) if n == usual]
            if usual and len(whole) >= (iters + 1) // 2:
                return [{"kernel": usual[i][:60],
                         "ms": sum(c[i]["dur"] for c in whole)
                         / len(whole) / 1e3} for i in range(len(usual))]
    raise RuntimeError(f"no whole call of {iters} in {tries} profiler traces")


def inputs(B, S, H, with_bias, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    do = torch.randn(B, S, H, D, generator=g, device="cuda").to(torch.bfloat16)
    bias = None
    if with_bias:
        lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
        keep = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
        bias = additive_mask(keep)[:, 0, 0, :]
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias, do


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call: ``calls`` calls queued back to back, read on
    the host clock before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


_CUSTOM_OP = []


def custom_op_route():
    """The forward wrapper as a ``torch.library.custom_op`` (the route the
    port does not take), registered at first use, to time its host cost
    beside the operator the port registers."""
    if not _CUSTOM_OP:
        def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias_k: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
            return flash_attention_fwd(q, k, v, bias_k)
        op = torch.library.custom_op("time_flash::flash_fwd", fwd,
                                     mutates_args=())
        op.register_fake(flash_attention._flash_fwd_fake)
        _CUSTOM_OP.append(op)
    return _CUSTOM_OP[0]


def route_host_us(q, k, v, bias) -> dict:
    """Host µs per forward call by route: ``FlashAttention.apply`` without
    gradients (what a served model calls; every checkout has it), and,
    where the checkout registers the operator, the operator alone and the
    same wrapper as a ``custom_op``."""
    out = {}
    with torch.no_grad():
        out["apply_host_us"] = host_us(
            lambda: FlashAttention.apply(q, k, v, bias))
        op = getattr(flash_attention, "flash_fwd_op", None)
        if op is not None:
            out["op_host_us"] = host_us(lambda: op(q, k, v, bias))
            custom = custom_op_route()
            out["custom_op_host_us"] = host_us(lambda: custom(q, k, v, bias))
    return out


def time_tree() -> dict:
    """Times only, through the wrappers that every checkout of the port
    has; the bounds are added by the caller."""
    rows = []
    for i, (name, B, S, H, n) in enumerate(SHAPES):
        q, k, v, bias, do = inputs(B, S, H, name != "video", i)
        out, lse = flash_attention_fwd(q, k, v, bias)
        calls = {"fwd": lambda: flash_attention_fwd(q, k, v, bias),
                 "bwd": lambda: flash_attention_bwd(q, k, v, bias, out, lse,
                                                    do)}
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        do_t = do.transpose(1, 2)
        sdpa = {"fwd": lambda: F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask),
                "bwd": lambda: torch.autograd.grad(o_lib, leaves, do_t,
                                                   retain_graph=True)}
        row = {"shape": name, "B": B, "S": S, "H": H, "D": D,
               "bias": bias is not None, "launches": n}
        for key, call in calls.items():
            row[key] = {"ms": event_ms(call, iters=20),
                        "host_us": host_us(call), "kernels": kernel_ms(call),
                        "sdpa_ms": event_ms(sdpa[key], iters=20)}
        row["fwd"].update(route_host_us(q, k, v, bias))
        rows.append(row)
        del o_lib, leaves
    return {"flash": rows}


def with_bounds(result: dict) -> dict:
    """Adds TFLOP/s, the bound and the sums over the launches of a chunk
    (forward) or step (backward); their bound is the larger of all flops
    over the peak rate and all bytes over the memory rate."""
    from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES
    from mme_tpu_torch.ops.flash_attention import bounds
    total = {f"{key}_{what}": 0.0 for key in ("fwd", "bwd")
             for what in ("ms", "sdpa_ms", "kernels_ms", "flops", "bytes")}
    for row in result["flash"]:
        b = bounds(row["B"], row["S"], row["S"], row["H"], row["D"], 2,
                   row["bias"])
        for (flops, nbytes, bound, by), key in zip(b, ("fwd", "bwd")):
            t = row[key]
            t.update(tflops=flops / t["ms"] / 1e9, bound_ms=bound,
                     bound_by=by)
            for piece in t["kernels"]:
                piece["tflops"] = flops / piece["ms"] / 1e9
            n = row["launches"]
            total[f"{key}_ms"] += t["ms"] * n
            total[f"{key}_sdpa_ms"] += t["sdpa_ms"] * n
            total[f"{key}_kernels_ms"] += sum(
                piece["ms"] for piece in t["kernels"]) * n
            total[f"{key}_flops"] += flops * n
            total[f"{key}_bytes"] += nbytes * n
    for key in ("fwd", "bwd"):
        total[f"{key}_bound_ms"] = max(
            total.pop(f"{key}_flops") / PEAK_BF16_FLOPS,
            total.pop(f"{key}_bytes") / PEAK_BYTES) * 1e3
    return {**result, "per_chunk_or_step": total}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None,
                        help="another checkout to time in turns with this one")
    parser.add_argument("--times-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_flash needs a CUDA device")
    if args.times_only:
        print(json.dumps(time_tree()), flush=True)
        return
    card = card_line()
    if args.parent is None:
        print(json.dumps({**with_bounds(time_tree()), "card": card}),
              flush=True)
        return
    # this file against the other checkout's package: run from its root
    script = (f"import runpy, sys; sys.argv = ['time_flash', '--times-only'];"
              f" runpy.run_path({os.path.abspath(__file__)!r},"
              f" run_name='__main__')")
    for turn in ("parent", "change", "change", "parent"):
        if turn == "parent":
            out = subprocess.run([sys.executable, "-c", script],
                                 cwd=args.parent, capture_output=True,
                                 text=True)
            if out.returncode != 0:
                raise SystemExit(f"the parent's turn failed:\n{out.stderr}")
            result = json.loads(out.stdout.strip().splitlines()[-1])
        else:
            result = time_tree()
        print(json.dumps({"turn": turn, **with_bounds(result), "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
