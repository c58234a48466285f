"""Time the fused MLP kernels alone at the four full-width tower shapes.

A short loop for iterating on ``csrc/fused_mlp.cu``. For each of the TAV
model's MLPs at batch 8 (bf16) it prints, as one JSON line:

- the forward and backward wrapper per call by CUDA events (10 calls after
  one warm-up), with TFLOP/s and the bound (:func:`bounds`), and their sum
  over the 54 launches of a step;
- each kernel a wrapper call starts, in launch order, by its device time in
  a ``torch.profiler`` trace (5 calls): the forward's two ``mlp_gemm``
  launches (fc1, fc2), the backward's ``mlp_dual`` and grouped ``mlp_gemm``
  and the two ``torch.sum`` reductions, each with its TFLOP/s.

``--parent DIR`` also runs ``python -m mme_tpu_torch.time_fused_mlp`` from
another checkout (the parent commit unpacked by ``git archive`` into a
directory that ``.gitignore`` lists) in a process of its own, in turns
parent, this tree, this tree, parent, so that both are timed on one card.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.time_fused_mlp
[--parent _archive]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from mme_tpu_torch.device import card_line
from mme_tpu_torch.ops.fused_mlp import bounds, fused_mlp_bwd, fused_mlp_fwd
from mme_tpu_torch.time_flash import event_ms, kernel_ms

# (tower, rows at batch 8, hidden, intermediate, layers)
SHAPES = (("text", 560, 768, 3072, 6), ("audio", 2392, 1024, 4096, 24),
          ("video", 11712, 768, 3072, 12), ("fusion", 3784, 768, 3072, 12))
# flops of each kernel of a call, in units of N·H·F, by launch order
PIECES = {"fwd": (("fc1", 2), ("fc2", 2)),
          "bwd": (("dual", 4), ("grouped", 6), ("sum_db1", 0),
                  ("sum_db2", 0))}


def time_tree() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    rows, step = [], {"fwd_ms": 0.0, "bwd_ms": 0.0}
    for name, n, h, f, layers in SHAPES:
        def r(*shape):
            return torch.randn(*shape, generator=g, device="cuda")
        x, do = r(n, h).to(dt), r(n, h).to(dt)
        w1, w2 = (r(f, h) * h ** -0.5).to(dt), (r(h, f) * f ** -0.5).to(dt)
        b1, b2 = r(f) * 0.1, r(h) * 0.1
        calls = {"fwd": lambda: fused_mlp_fwd(x, w1, b1, w2, b2),
                 "bwd": lambda: fused_mlp_bwd(x, w1, b1, w2, do)}
        row = {"shape": name, "N": n, "H": h, "F": f, "layers": layers}
        for (key, call), (flops, _, bound, by) in zip(calls.items(),
                                                      bounds(n, h, f, 2)):
            ms = event_ms(call)
            row[key] = {"ms": ms, "tflops": flops / ms / 1e9,
                        "bound_ms": bound, "bound_by": by,
                        "kernels": kernel_ms(call)}
            for piece, (label, units) in zip(row[key]["kernels"],
                                             PIECES[key]):
                piece["piece"] = label
                if units:
                    piece["tflops"] = units * n * h * f / piece["ms"] / 1e9
            step[key + "_ms"] += ms * layers
        rows.append(row)
    return {"fused_mlp": rows, "per_step": step}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None,
                        help="another checkout to time in turns with this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_mlp needs a CUDA device")
    card = card_line()
    if args.parent is None:
        print(json.dumps({**time_tree(), "card": card}), flush=True)
        return
    for turn in ("parent", "change", "change", "parent"):
        if turn == "parent":
            out = subprocess.run(
                [sys.executable, "-m", "mme_tpu_torch.time_fused_mlp"],
                cwd=args.parent, capture_output=True, text=True, check=True)
            result = json.loads(out.stdout.strip().splitlines()[-1])
        else:
            result = time_tree()
        print(json.dumps({"turn": turn, **result, "card": card}), flush=True)


if __name__ == "__main__":
    main()
