"""The offline serving loop (a mix's ``"loop": "serve_offline"``): a
prediction job, ``Predictor.predict_dataset`` over the pool with the
predict path's batch transform, the pool cycled until ``--seconds`` have
passed; ``serve_utt_per_s`` is every row predicted over all of that time
(each chunk's results are read to the host).

After the window the reference recomputes every pool row that was served,
from the same weights and inputs, and every answer of the window is held
to its row's.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

import flops
from harness import check, data, trace, weights
from harness.common import Result, Run, limit, model


def _setup(run: Run):
    c, mix, dev = run.config, run.traffic, run.device
    B = int(mix["batch"])
    w, _ = weights.draw(c, run.seed, dev)
    predictor, transform = model(c).build_predictor(c, w, B, dev)
    del w
    feats, labels = data.make_pool(c, mix, run.seed)
    return predictor, transform, feats, labels, B


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reference_logp(run: Run, feats: Dict[str, np.ndarray], rows: np.ndarray,
                   precision: str = "fp32") -> np.ndarray:
    """The reference's log-probabilities of pool rows ``rows``, in blocks
    of the cell's batch (an fp8 control's per-tensor scales span one
    served chunk's rows)."""
    import reference
    from reference import layers, optim
    c, dev = run.config, run.device
    block = int(run.traffic["batch"])
    ref = model(c).reference(c, device=dev)
    w, _ = weights.draw(c, run.seed, dev)
    ref.load_state_dict(w, strict=True)
    del w
    layers.set_precision("fp8" if precision == "fp8" else "fp32")
    out = []
    try:
        with reference.fp32_math(tf32=precision == "tf32"):
            for lo in range(0, len(rows), block):
                idx = rows[lo:lo + block]
                batch = {k: torch.from_numpy(feats[k][idx]).to(dev)
                         for k in c["inputs"]["names"]}
                out.append(optim.log_probs(ref, batch).cpu().numpy())
    finally:
        layers.set_precision("fp32")
    return np.concatenate(out)


def drive(run: Run) -> Result:
    from mme_tpu_torch.data.dataset import ArrayDataset
    dev, mix = run.device, run.traffic
    predictor, transform, feats, labels, B = _setup(run)
    ds = ArrayDataset(feats, labels)
    n_pool = len(ds)

    def rows():
        while True:
            with torch.profiler.record_function("bench.predict_dataset"):
                yield from predictor.predict_dataset(
                    ds, batch_transform=transform)

    stream = rows()
    for _ in range(int(mix["warmup_chunks"]) * B):
        next(stream)
    stream.close()
    setup_s = time.time() - run.t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    answers: List[tuple] = []

    def serve_for(seconds: float) -> tuple:
        stream = rows()
        t0 = time.perf_counter()
        n = 0
        for row in stream:
            n += 1
            answers.append((row["index"], row["probs"]))
            if n % B == 0 and time.perf_counter() - t0 >= seconds:
                break
        stream.close()
        return n, time.perf_counter() - t0

    layer = None
    if not run.trace:
        n, elapsed = serve_for(run.seconds)
    else:
        n, elapsed = serve_for(run.seconds / 2)
        def run_units(n):
            stream = rows()
            for _ in range(n * B):
                next(stream)
            stream.close()

        summary = trace.traced(dev, run_units, int(mix["trace_units"]))
        layer = {"kind": "serve", "summary": summary,
                 "utt_per_s": n / elapsed,
                 "flops_per_utt": flops.forward_flops(run.config, B) / B,
                 "peak_flops": flops.PEAK_FLOPS[run.config["compute_dtype"]],
                 "flash_bound_s": flops.flash_bound_s(run.config, B,
                                                      backward=False)}
    peak = _peak(dev)
    del predictor, stream
    _free(dev)
    gap = _held(run, feats, answers)
    metrics = {"serve_utt_per_s": (n / elapsed, "utt/s"),
               "peak_mem_gb": (peak / 1e9, "GB"), "setup_s": (setup_s, "s")}
    return Result(metrics=metrics, attempted=n, failed=0,
                  checks=[("logprob_gap", gap, limit(run, "logprob_gap"))],
                  memory_peak_bytes=peak, layer=layer,
                  notes={"pool": n_pool, "answers_checked": len(answers)})


def _held(run: Run, feats, answers: List[tuple]) -> float:
    """The largest log-probability gap of any answer (pool row, probs)
    against the reference's for its row."""
    if not answers:
        return float("inf")
    rows = np.array(sorted({i for i, _ in answers}))
    ref = dict(zip(rows.tolist(), reference_logp(run, feats, rows)))
    return check.logprob_gap([p for _, p in answers],
                             [ref[i] for i, _ in answers])


def control_readings(run: Run, lower: str) -> dict:
    """The control (the reference in the ``lower`` precision) and the
    planted fault ``altered_answer`` (one answer's likeliest and least
    likely classes swapped), over every pool row: reading name →
    numbers."""
    feats, labels = data.make_pool(run.config, run.traffic, run.seed)
    rows = np.arange(len(labels))
    ref = reference_logp(run, feats, rows)
    low = reference_logp(run, feats, rows, precision=lower)
    altered = np.exp(ref)
    order = np.argsort(-altered[0])
    altered[0, order[[0, -1]]] = altered[0, order[[-1, 0]]]
    return {lower: {"logprob_gap": check.logprob_gap(np.exp(low), ref)},
            "altered_answer": {"logprob_gap": check.logprob_gap(altered,
                                                                ref)}}
