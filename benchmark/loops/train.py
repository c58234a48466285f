"""The training loop (a mix's ``"loop": "train"``): the window feeds the
program's train step as its loop does (``data/prefetch.py::prefetch_batches`` over the pool's batches,
the batch transform, ``train_step``, losses summed on the device).

Set-up builds the step once, from weights drawn on the device, and drives
it through three steps on the pool's first 24 rows; those steps are the
ones the reference follows after the window, and they warm every shape the
window uses. The window then runs back to back for ``--seconds`` and ends
with one synchronisation: ``train_utt_per_s`` is every utterance over all
of that time.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

import flops
from harness import check, data, program, trace, weights
from harness.common import Result, Run, limit, model

CHECKED_STEPS = 3


def _feed(feats, labels, batch: int, device):
    from mme_tpu_torch.data.dataset import ArrayDataset, batches
    from mme_tpu_torch.data.prefetch import prefetch_batches
    ds = ArrayDataset(feats, labels)
    order = np.arange(len(ds))
    endless = itertools.chain.from_iterable(
        batches(ds, order, batch) for _ in itertools.count())
    return prefetch_batches(endless, device)


class Loop:
    """One step of the loop: next batch, transform, train step."""

    def __init__(self, run: Run, trainer: program.Trainer, feed):
        from mme_tpu_torch.train.loop import fold_seed
        from mme_tpu_torch.train.steps import to_device
        self.run, self.tr, self.feed = run, trainer, feed
        self.fold_seed, self.to_device = fold_seed, to_device
        self.weights = torch.ones(run.config["output_dim"],
                                  device=run.device)
        self.losses: List[torch.Tensor] = []

    def __call__(self) -> torch.Tensor:
        tr, dev, seed = self.tr, self.run.device, self.run.seed
        with torch.profiler.record_function("bench.feed"):
            feats, labels, mask, _ = next(self.feed)
        with torch.profiler.record_function("bench.transform"):
            batch = self.to_device(feats, dev)
            if tr.transform is not None:
                gen = torch.Generator(device=dev).manual_seed(
                    self.fold_seed(seed, tr.state.step, 1))
                batch = tr.transform(gen, batch)
        with torch.profiler.record_function("bench.train_step"):
            tr.state, loss, _, _ = tr.step(tr.state, batch, labels, mask,
                                           self.weights, 1.0, True, seed)
        self.losses.append(loss)
        return loss


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steps_for(loop: Loop, seconds: float) -> tuple:
    dev = loop.run.device
    _sync(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        loop()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    return n, time.perf_counter() - t0


def drive(run: Run) -> Result:
    c, mix, dev = run.config, run.traffic, run.device
    B = int(mix["batch"])
    w, flat = weights.draw(c, run.seed, dev)
    tr = model(c).build_trainer(c, w, flat, run.seed, B, dev)
    del w, flat
    feats, labels = data.make_pool(c, mix, run.seed)
    feed = _feed(feats, labels, B, dev)
    loop = Loop(run, tr, feed)

    # the checked steps, through the window's own call and feed
    for i in range(CHECKED_STEPS):
        loop()
        if i == 0:
            first = tr.first_grad_norms()
    start, _ = weights.draw(c, run.seed, dev)
    changes = tr.changes(start)
    del start
    checked = [float(x) for x in torch.stack(loop.losses)]
    prog = {"losses": checked,
            "first_grad": dict(zip(tr.names, first.tolist()))}
    loop.losses.clear()
    _sync(dev)
    setup_s = time.time() - run.t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    layer = None
    if not run.trace:
        steps, elapsed = _steps_for(loop, run.seconds)
    else:
        steps, elapsed = _steps_for(loop, run.seconds / 2)

        def run_units(n):
            for _ in range(n):
                loop()

        summary = trace.traced(dev, run_units, int(mix["trace_units"]))
        layer = {"kind": "train", "summary": summary,
                 "utt_per_s": steps * B / elapsed,
                 "flops_per_utt": flops.train_flops(c, B) / B,
                 "peak_flops": flops.PEAK_FLOPS[c["compute_dtype"]],
                 "flash_bound_s": flops.flash_bound_s(c, B, backward=True)}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    window_losses = torch.stack(loop.losses)
    failed = int((~torch.isfinite(window_losses)).sum())
    feed.close()
    del tr, loop, feed, window_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_train(run, feats, labels, B)
    prog["change"] = {n: float(d.to(dev)[ref["moving"][n]].norm())
                      for n, d in changes.items()}
    del changes
    numbers, worst = check.train_numbers(prog, ref,
                                         int(mix.get("loss_steps", 0)))
    # a number the cell sets no limit on is shown and not compared
    checks = [(k, v, limit(run, k)) for k, v in numbers.items()
              if k in run.cell["limits"]]
    metrics = {"train_utt_per_s": (steps * B / elapsed, "utt/s"),
               "peak_mem_gb": (peak / 1e9, "GB"),
               "setup_s": (setup_s, "s")}
    return Result(metrics=metrics, attempted=steps, failed=failed,
                  checks=checks, memory_peak_bytes=peak, layer=layer,
                  notes={"numbers": numbers, "worst": worst,
                         "program_losses": checked,
                         "reference_losses": ref["losses"]})


def reference_batches(c: dict, feats: Dict[str, np.ndarray],
                      labels: np.ndarray, B: int, steps: int, device):
    names = c["inputs"]["names"]
    return [({k: torch.from_numpy(feats[k][i * B:(i + 1) * B]).to(device)
              for k in names},
             torch.from_numpy(labels[i * B:(i + 1) * B]).to(device))
            for i in range(steps)]


def reference_train(run: Run, feats, labels, B: int,
                    precision: str = "fp32", moving=None,
                    rows: int = 0) -> dict:
    """The reference's three steps from the same weights on the same
    rows (``precision``: ``fp32``, or the controls ``tf32`` / ``fp8``;
    ``moving``: the elements to compare changes over, by name; ``rows``:
    train on each batch's first rows only, a planted fault)."""
    import reference
    from reference import layers, optim
    c, dev = run.config, run.device
    ref = model(c).reference(c, device=dev)
    w, flat = weights.draw(c, run.seed, dev)
    ref.load_state_dict(w, strict=True)
    del w, flat
    layers.set_precision("fp8" if precision == "fp8" else "fp32")
    try:
        with reference.fp32_math(tf32=precision == "tf32"):
            batches = reference_batches(c, feats, labels, B, CHECKED_STEPS,
                                        dev)
            if rows:
                batches = [({k: v[:rows] for k, v in b.items()}, y[:rows])
                           for b, y in batches]
            names = [n for n, _ in ref.named_parameters()]
            return optim.train_steps(
                ref, batches, c["optimizer"],
                None if moving is None else [moving[n] for n in names])
    finally:
        layers.set_precision("fp32")


def control_readings(run: Run, lower: str) -> dict:
    """The control (the reference in the ``lower`` precision) and the
    planted fault ``half_batch`` (the reference's loss over the first half
    of each batch), each held to the reference as a run holds the
    program: reading name → numbers."""
    B = int(run.traffic["batch"])
    feats, labels = data.make_pool(run.config, run.traffic, run.seed)
    ref = reference_train(run, feats, labels, B)
    out = {}
    for name, kw in ((lower, {"precision": lower}),
                     ("half_batch", {"rows": B // 2})):
        got = reference_train(run, feats, labels, B, moving=ref["moving"],
                              **kw)
        out[name], _ = check.train_numbers(
            got, ref, int(run.traffic.get("loss_steps", 0)))
        del got
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    return out
