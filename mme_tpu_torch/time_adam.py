"""Time the fused Adam update (K3) alone over one training step's leaves.

A short loop for iterating on ``csrc/adam_update.cu``. The leaves are the
trainable parameters of one train step of the bf16 bench configuration
(``TAVSpec(output_dim=7)``, shared audio frontend; :func:`step_leaf_sizes`,
counted on the ``meta`` device), with fp32 gradients and bf16 moments, the
update written in place as the optimizer calls it. It prints, as one JSON
line, for every trainable leaf ("all") and for the leaves of at least 2^16
elements ("big", the set that the per-leaf kernel of earlier checkouts
took):

- the wrapper per step by CUDA events (10 steps after one warm-up);
- the host time of one step's call (µs on the host clock over 3 steps
  queued back to back, before the device is waited for; median of 7);
- each kernel a step starts, by its device time in a ``torch.profiler``
  trace (``time_flash.kernel_ms``), and their sum;
- the bound (``ops/adam_update.py::bounds``), the launches per step, and
  a device-to-device copy of as many bytes (half read, half written) by
  CUDA events: the rate a plain stream reaches on this card, beside the
  published one the bound takes.

``--parent DIR`` also times another checkout (the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists) in a process of
its own, this file run against that checkout's package, in turns parent,
this tree, this tree, parent. A checkout without ``adam_update_leaves``
(one launch per leaf, new outputs per call) is timed as its optimizer
called it: ``adam_update_leaf`` on each big leaf in turn.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.time_adam
[--parent _archive]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.ops import adam_update
from mme_tpu_torch.time_flash import event_ms, host_us, kernel_ms
from mme_tpu_torch.train.build_tav import modality_embedding_trainable_mask

BIG = 1 << 16       # the per-leaf kernel's old size floor
KW = dict(b1=0.9, b2=0.999, eps=1e-8)
BC1, BC2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3


def step_leaf_sizes(spec: TAVSpec = None) -> list:
    """Element counts of the trainable leaves of one train step, in
    parameter order (the bench model shares its audio frontend)."""
    spec = spec or dataclasses.replace(TAVSpec(output_dim=7),
                                       share_audio_frontend=True)
    model = TAVModel(spec, device="meta")
    mask = modality_embedding_trainable_mask(model,
                                             spec.learn_pos_embeddings)
    return [p.numel() for k, p in enumerate(model.parameters())
            if mask is None or mask[k]]


def leaf_state(sizes, seed):
    """fp32 gradients and bf16 moments of the given sizes on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gs = [torch.randn(n, generator=g, device="cuda") * 1e-3 for n in sizes]
    mus = [(torch.randn(n, generator=g, device="cuda") * 1e-3).bfloat16()
           for n in sizes]
    nus = [(torch.rand(n, generator=g, device="cuda") * 1e-6).bfloat16()
           for n in sizes]
    return gs, mus, nus


def time_tree() -> dict:
    """Times only, through the wrappers that the checkout has; the bounds
    are added by the caller."""
    sizes = step_leaf_sizes()
    result = {}
    multi = hasattr(adam_update, "adam_update_leaves")
    for name in ("all", "big") if multi else ("big",):
        keep = [n for n in sizes if name == "all" or n >= BIG]
        gs, mus, nus = leaf_state(keep, len(keep))
        seeds = [(7 << 20) + k for k in range(len(keep))]
        if multi:
            def call():
                adam_update.adam_update_leaves(
                    gs, mus, nus, BC1, BC2, seeds, outs=gs, mu_outs=mus,
                    nu_outs=nus, **KW)
        else:
            def call():
                for g, mu, nu, s in zip(gs, mus, nus, seeds):
                    adam_update.adam_update_leaf(g, mu, nu, BC1, BC2, s,
                                                 **KW)
        kern = kernel_ms(call, iters=3)
        src = torch.empty(8 * sum(keep), dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy = event_ms(lambda: dst.copy_(src))
        del src, dst
        result[name] = {
            "leaves": len(keep), "elements": sum(keep),
            "launches_per_step": len(kern), "ms": event_ms(call),
            "host_us": float(np.median([host_us(call, calls=3)
                                        for _ in range(7)])),
            "kernels_ms": sum(k["ms"] for k in kern),
            "copy_same_bytes_ms": copy,
            "kernels": kern if len(kern) <= 4 else kern[:2]}
        del gs, mus, nus
        torch.cuda.empty_cache()
    return result


def with_bounds(result: dict) -> dict:
    sizes = step_leaf_sizes()
    for name, row in result.items():
        keep = [n for n in sizes if name == "all" or n >= BIG]
        _, nbytes, ms, by = adam_update.bounds(keep)
        row.update(bound_ms=ms, bound_by=by, bytes=nbytes,
                   share_of_bound=ms / row["kernels_ms"])
    return result


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None,
                        help="another checkout to time in turns with this one")
    parser.add_argument("--times-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_adam needs a CUDA device")
    if args.times_only:
        print(json.dumps(time_tree()), flush=True)
        return
    card = card_line()
    if args.parent is None:
        print(json.dumps({"adam_update": with_bounds(time_tree()),
                          "card": card}), flush=True)
        return
    # this file against the other checkout's package: run from its root
    script = (f"import runpy, sys; sys.argv = ['time_adam', '--times-only'];"
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
        print(json.dumps({"turn": turn, "adam_update": with_bounds(result),
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
