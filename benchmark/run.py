"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``benchmark/workloads/<cell>.json``) names its
configuration (``configs/``) and traffic mix (``traffic/``); the mix names
its loop (``loops/<loop>.py``), the configuration its model
(``models/<model>.py``). ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (one reader each in ``metrics/``), both as
``BENCHMARK.json`` declares them. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), then ``checks``: each number compared with
its limit, which are also the last lines of standard error.

Exits with 2 and prints no result without a CUDA device (or with fewer than
the cell asks for), and with 3 if JAX, flax, optax or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
# keep libraries that could load JAX by themselves from doing so
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from harness import check  # noqa: E402
from harness.common import (ROOT, Run, cell, forbidden_loaded,  # noqa: E402
                            plugin)


def declared() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def applies(metric: dict, name: str, reported) -> bool:
    """A per-layer metric is read in the cells it lists, or without a
    list in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric["moves"] in reported


def execute(c: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, bench: dict) -> dict:
    """Run ``c`` (a cell as ``harness.common.cell`` gives it) once on
    ``device``; returns the result line."""
    import torch
    dev = torch.device(device)
    run = Run(cell=c, seed=seed, seconds=seconds, trace=trace, device=dev,
              t_start=t_start)
    res = plugin("loops", c["traffic"]["loop"]).drive(run)

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or c["name"] in m["workloads"]]
    line = {"correct": res.correct and res.failed == 0,
            "attempted": res.attempted, "failed": res.failed}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(res.memory_peak_bytes)}
    if not trace:
        line["metrics"] = {m["name"]: {"value": res.metrics[m["name"]][0],
                                       "unit": m["unit"]}
                           for m in e2e if m["name"] in res.metrics}
    else:
        names = {m["name"] for m in e2e}
        summary = res.layer["summary"]
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, c["name"], names):
                continue
            value = plugin("metrics", m["name"]).read(res.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["device"] = device_info
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res.checks}
    for k, v in (res.notes or {}).items():
        print(f"note {k}: {v}", file=sys.stderr)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    c = cell(a.workload)
    bench = declared()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the H100 port only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(c["chips"]):
        print(f"the cell asks for {c['chips']} devices; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = execute(c, a.seed, a.seconds, bool(a.trace), "cuda:0", T_START,
                   bench)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for text in check.lines([(k, v["value"], v["limit"])
                             for k, v in line["checks"].items()]):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
