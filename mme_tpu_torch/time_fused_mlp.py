"""Time the fused MLP kernels alone at the four full-width tower shapes.

A short loop for iterating on ``csrc/fused_mlp.cu``: builds the source,
then for each of the TAV model's MLPs at batch 8 (bf16) prints the forward
and backward time per launch by CUDA events (10 launches after one warm-up)
and their sum over the 54 launches of a step. ``chip_smoke.py`` holds the
kernels against their plain versions and times them beside the library
call; this only times.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.time_fused_mlp``.
"""

from __future__ import annotations

import json

import torch

from mme_tpu_torch.device import card_line
from mme_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

# (tower, rows at batch 8, hidden, intermediate, layers)
SHAPES = (("text", 560, 768, 3072, 6), ("audio", 2392, 1024, 4096, 24),
          ("video", 11712, 768, 3072, 12), ("fusion", 3784, 768, 3072, 12))


def _ms(fn, iters: int = 10) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_mlp needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    rows, step = [], {"fwd_ms": 0.0, "bwd_ms": 0.0}
    for name, n, h, f, layers in SHAPES:
        def r(*shape):
            return torch.randn(*shape, generator=g, device="cuda")
        x, do = r(n, h).to(dt), r(n, h).to(dt)
        w1, w2 = (r(f, h) * h ** -0.5).to(dt), (r(h, f) * f ** -0.5).to(dt)
        b1, b2 = r(f) * 0.1, r(h) * 0.1
        fwd = _ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2))
        bwd = _ms(lambda: fused_mlp_bwd(x, w1, b1, w2, do))
        rows.append({"shape": name, "N": n, "H": h, "F": f, "layers": layers,
                     "fwd_ms": fwd, "bwd_ms": bwd})
        step["fwd_ms"] += fwd * layers
        step["bwd_ms"] += bwd * layers
    print(json.dumps({"fused_mlp": rows, "per_step": step,
                      "card": card_line()}))


if __name__ == "__main__":
    main()
