"""Flash against the plain attention core at the real tower shapes: where
the dispatcher should start taking the kernels.

Port of ``scripts/flash_crossover.py``. At each (B, H, S, D) of the
towers, audio 8x16x299, fusion 8x12x473, text 8x12x70 and 8x16x512 (D 64,
bf16), it times one forward and backward with gradients on q, k and v
and a key-mask bias (the last S/8 keys masked; the production call)
through ``ops/attention.py::dot_product_attention_shd``: with
``use_flash=True`` (K1 forward, K2 backward) and ``use_flash=False`` (the
plain einsum core), and beside them ``scaled_dot_product_attention`` on
the same inputs, a yardstick the port never calls. Each time is the best
of ``WINDOWS`` windows of ``STEPS`` calls, by CUDA events on the card (the
host clock on the CPU). It prints one JSON line per shape, with the K1 /
K2 launches of the flash leg and the card's name and power limit.

The dispatcher's ``MME_FLASH_MIN_SEQ`` (flash from that many tokens on)
stays 0 until a measured crossover sets it; this script is that
measurement and sets nothing.

Run on the card: ``python -m mme_tpu_torch.flash_crossover``; from
Python, :func:`run` takes ``shapes``, ``device``, ``steps`` and
``windows``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mme_tpu_torch.device import DeviceLike, card_line, resolve_device
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import (additive_mask,
                                         dot_product_attention_shd)

STEPS, WINDOWS = 10, 3
SHAPES = ((8, 16, 299, 64), (8, 12, 473, 64), (8, 12, 70, 64),
          (8, 16, 512, 64))


def _inputs(B: int, H: int, S: int, D: int, dev: torch.device, seed: int
            ) -> Tuple[torch.Tensor, ...]:
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    keep = torch.ones((B, S), device=dev)
    keep[:, S - S // 8:] = 0.0
    return q, k, v, keep


def _legs(q, k, v, keep) -> Dict[str, Callable]:
    bias = additive_mask(keep)
    sdpa_mask = keep.bool()[:, None, None, :]

    def core(flash: bool):
        def step():
            o = dot_product_attention_shd(q, k, v, bias, use_flash=flash)
            loss = torch.sum(o.float() ** 2)
            return torch.autograd.grad(loss, (q, k, v))
        return step

    def sdpa():
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=sdpa_mask).transpose(1, 2)
        loss = torch.sum(o.float() ** 2)
        return torch.autograd.grad(loss, (q, k, v))

    return {"flash": core(True), "plain": core(False), "sdpa": sdpa}


def best_ms(fn, dev: torch.device, steps: int, windows: int) -> float:
    """The best of ``windows`` windows of ``steps`` calls, ms per call,
    after one warm-up call: CUDA events on the card, the host clock on
    the CPU."""
    fn()
    best = float("inf")
    for _ in range(windows):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / steps)
    return best


def run(shapes: Sequence[Tuple[int, int, int, int]] = SHAPES,
        device: DeviceLike = "cuda", steps: int = STEPS,
        windows: int = WINDOWS, card: Optional[str] = None
        ) -> List[dict]:
    """One result per shape: ms per forward + backward of each leg, the
    flash leg's K1 / K2 launches per call (0 on the CPU, where the
    wrappers run their plain versions), printed as a JSON line each."""
    dev = resolve_device(device)
    if card is None and dev.type == "cuda":
        card = card_line()
    out = []
    for i, (B, H, S, D) in enumerate(shapes):
        q, k, v, keep = _inputs(B, H, S, D, dev, seed=i)
        legs = _legs(q, k, v, keep)
        row = {"B": B, "H": H, "S": S, "D": D, "dtype": "bf16"}
        for name, fn in legs.items():
            try:
                row[name] = best_ms(fn, dev, steps, windows)
            except RuntimeError as e:    # a leg the device cannot run
                row[name] = str(e)[:100]
        kernels.reset_launches()
        legs["flash"]()
        row["launches"] = {n: kernels.LAUNCHES.get(n, 0)
                           for n in ("flash_fwd", "flash_bwd")}
        if isinstance(row["flash"], float) and isinstance(row["plain"],
                                                          float):
            row["flash_over_plain"] = row["flash"] / row["plain"]
        row["device"] = str(dev)
        row["card"] = card
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    run()
