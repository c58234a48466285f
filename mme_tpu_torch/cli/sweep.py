"""Sweep runner CLI: the local stand-in for ``wandb sweep`` + ``wandb agent``.

Port of ``mme_tpu/cli/sweep.py``. Reads a sweep YAML (``sweep.py``; the
``configs/*.yaml`` as they are), runs each trial through the entry point's
``main(argv, device=...)`` and reports the best trial by the sweep
metric::

    python -m mme_tpu_torch.cli.sweep configs/bert.yaml --trials 8 \
        --dataset meld.pkl
    python -m mme_tpu_torch.cli.sweep configs/bert.yaml --trials 8 \
        --workers 2 --pin_env CUDA_VISIBLE_DEVICES   # one agent per card

The entry comes from ``--entry`` or the YAML's ``program``: JAX's dotted
names (``mme_tpu.cli.tav_nn``) and the reference's scripts (``../tav_nn.py``;
``../audio_nn.py`` is ``audio_nn_wav2vec``) both name the port's
``mme_tpu_torch.cli.<name>``. Trials run on the card unless the caller
passes ``device="cpu"`` (``--device cpu`` on the command line); workers
get the agent's device.

``--workers N`` starts N agents as ``python -m mme_tpu_torch.cli.sweep``
subprocesses over one global trial sequence (worker w runs trials w, w+N,
...), each writing its trials to a JSONL results file, and merges them;
``--pin_env NAME`` sets ``NAME=<worker id>`` in each worker's environment;
CPU workers split the host's cores (``OMP_NUM_THREADS``, unless set).
Unlike JAX's workers, which share ``./checkpoints``, each worker writes
its checkpoints and run log under ``checkpoints/sweep_worker_<w>``
(``MME_CHECKPOINT_DIR``). A bayes worker conditions its proposals on its
siblings' finished trials too, read from the results directory before
each proposal.

A trial's metrics are the entry's summary (the test split's). As in JAX
a ``val/`` metric reads the summary's ``test/`` key, and a metric the
summary lacks scores 0.0; the port prints one line naming it. In process,
each trial's model, optimizer state and checkpoint manager are released
(and the card's cache emptied) before the next trial builds, and
``MME_WANDB_NAME`` is restored after each trial.
"""

from __future__ import annotations

import argparse
import gc
import glob
import importlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

import torch

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.sweep import (SweepConfig, TrialResult, best_of,
                                 run_sweep)

WORKER_DIR = os.path.join("checkpoints", "sweep_worker_{}")


def _parse(argv):
    p = argparse.ArgumentParser("mme_tpu_torch sweep agent")
    p.add_argument("yaml", help="sweep config (reference format)")
    p.add_argument("--entry", default=None,
                   help="cli entry module (tav_nn, text_nn, ...); default "
                        "derives from the yaml's `program` field")
    p.add_argument("--trials", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", default=None,
                   help="override dataset (e.g. synthetic)")
    p.add_argument("--workers", type=int, default=1,
                   help="parallel agent processes (1 = in-process)")
    p.add_argument("--pin_env", default=None,
                   help="env var set to the worker id in each worker "
                        "(device pinning, e.g. CUDA_VISIBLE_DEVICES)")
    p.add_argument("--trial_offset", type=int, default=0,
                   help="first global trial index this agent runs")
    p.add_argument("--stride", type=int, default=1,
                   help="global-trial-index stride between this agent's "
                        "trials")
    p.add_argument("--results", default=None,
                   help="JSONL path for per-trial results (worker mode)")
    p.add_argument("--device", default=None,
                   help="device of the trials (default: the caller's, "
                        "cuda from the command line)")
    return p.parse_args(argv)


def _entry_from_program(program) -> str:
    """The cli module named by a sweep yaml's ``program`` field: a dotted
    path (``mme_tpu.cli.tav_nn``) or a reference script path
    (``../tav_nn.py``; ``../audio_nn.py`` is ``audio_nn_wav2vec``)."""
    if not program:
        return "tav_nn"
    name = os.path.basename(str(program))
    if name.endswith(".py"):
        name = name[:-3]
    name = name.split(".")[-1]
    return {"audio_nn": "audio_nn_wav2vec"}.get(name, name)


def _read_results(path: str):
    with open(path) as f:
        return [TrialResult(rec["params"], rec["metrics"])
                for rec in map(json.loads, f)]


def _launch_workers(args, device: str) -> TrialResult:
    """One agent subprocess per worker, each with its own checkpoint
    directory; their results merged."""
    cfg = SweepConfig.from_yaml(args.yaml)
    if args.entry is None:
        args.entry = _entry_from_program(cfg.program)
    workers = max(1, args.workers)
    procs, files = [], []
    tmpdir = tempfile.mkdtemp(prefix="mme_sweep_")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for w in range(workers):
        n_w = len(range(w, args.trials, workers))
        if n_w == 0:
            continue
        res = os.path.join(tmpdir, f"worker_{w}.jsonl")
        files.append(res)
        cmd = [sys.executable, "-m", "mme_tpu_torch.cli.sweep", args.yaml,
               "--entry", args.entry, "--trials", str(n_w),
               "--seed", str(args.seed),
               "--trial_offset", str(args.trial_offset + w),
               "--stride", str(args.stride * workers),
               "--results", res, "--device", device]
        if args.dataset:
            cmd += ["--dataset", args.dataset]
        env = dict(os.environ)
        env["MME_SWEEP_WORKER"] = str(w)
        env["MME_CHECKPOINT_DIR"] = WORKER_DIR.format(w)
        if args.pin_env:
            env[args.pin_env] = str(w)
        if device.startswith("cpu"):
            # CPU workers share the host's cores rather than oversubscribe
            env.setdefault("OMP_NUM_THREADS",
                           str(max(1, (os.cpu_count() or 1) // workers)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"sweep worker(s) failed: rc={rcs}")

    results = [r for res in files for r in _read_results(res)]
    assert results, "no trial results collected"
    best = best_of(results, cfg.metric_name, cfg.metric_goal)
    print(json.dumps({"best_params": best.params,
                      cfg.metric_name: best.metrics.get(cfg.metric_name),
                      "trials": len(results), "workers": workers}),
          flush=True)
    return best


def _sibling_reader(results: str):
    """Before each bayes proposal: the trials of every other
    ``worker_*.jsonl`` in this agent's results directory (its own are in
    ``run_sweep``'s history); a file mid-write is read next time."""
    res_dir = os.path.dirname(os.path.abspath(results))
    own = os.path.abspath(results)

    def refresh():
        out = []
        for path in sorted(glob.glob(os.path.join(res_dir,
                                                  "worker_*.jsonl"))):
            if os.path.abspath(path) == own:
                continue
            try:
                out.extend(_read_results(path))
            except (OSError, ValueError):
                pass
        return out

    return refresh


def _release(device: str) -> None:
    """Free what the finished trial left: its model, optimizer state and
    checkpoint manager once their reference cycles are collected, and the
    card's cached blocks, so the next trial's peak is its own."""
    gc.collect()
    if device.startswith("cuda") and torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> TrialResult:
    args = _parse(argv)
    device = str(args.device or device)
    if args.workers > 1:
        return _launch_workers(args, device)

    cfg = SweepConfig.from_yaml(args.yaml)
    if args.entry is None:
        args.entry = _entry_from_program(cfg.program)
    entry = importlib.import_module(f"mme_tpu_torch.cli.{args.entry}")
    results_f = open(args.results, "a") if args.results else None
    refresh = _sibling_reader(args.results) if args.results else None
    trial_counter = [args.trial_offset]

    def trial(params):
        argv_trial = []
        for k, v in params.items():
            argv_trial += [f"--{k}", str(v)]
        if args.dataset:
            argv_trial += ["--dataset", args.dataset]
        # each trial is its own named run for the wandb mirror
        # (MME_WANDB=1); the caller's value comes back afterwards
        prev_name = os.environ.get("MME_WANDB_NAME")
        os.environ["MME_WANDB_NAME"] = (
            f"sweep-{args.entry}-t{trial_counter[0]}")
        trial_counter[0] += args.stride
        try:
            summary = entry.main(argv_trial, device=device)
        finally:
            if prev_name is None:
                os.environ.pop("MME_WANDB_NAME", None)
            else:
                os.environ["MME_WANDB_NAME"] = prev_name
            _release(device)
        # the entry returns the test summary: a val/ metric reads its
        # test/ key; a metric it lacks scores 0.0, as in JAX
        name = cfg.metric_name.replace("val/", "test/")
        if cfg.metric_name not in summary and name not in summary:
            print(f"sweep metric {cfg.metric_name!r} is not in the "
                  f"{args.entry} summary: scored 0.0", flush=True)
        metrics = {cfg.metric_name: summary.get(cfg.metric_name,
                                                summary.get(name, 0.0)),
                   **summary}
        if results_f is not None:
            results_f.write(json.dumps({"params": params,
                                        "metrics": metrics}) + "\n")
            results_f.flush()
        return metrics

    try:
        best = run_sweep(cfg, trial, args.trials, args.seed,
                         trial_offset=args.trial_offset, stride=args.stride,
                         refresh_observations=refresh)
    finally:
        if results_f is not None:
            results_f.close()
    print(json.dumps({"best_params": best.params,
                      cfg.metric_name: best.metrics.get(cfg.metric_name)}),
          flush=True)
    return best


if __name__ == "__main__":
    main()
