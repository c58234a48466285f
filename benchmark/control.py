"""The readings the limits of ``correct`` are set from, beside the
program's: the control and the planted faults, each put in the program's
place and compared with the reference as a run compares the program.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

- control: the reference computed in the precision below the
  configuration's (bfloat16 → fp8 operands; float32 → TF32 on);
- the faults the cell's loop can have, as its ``control_readings`` plants
  them (``loops/<loop>.py``): training's ``half_batch`` (the loss over the
  first half of each batch only), serving's ``altered_answer`` (one
  answer's likeliest and least likely classes swapped); a step that leaves
  the state unchanged reads 1 for ``grad_gap`` and ``change_gap`` by their
  definition and needs no run.

Prints one JSON line per seed and reading. The benchmark's runs never run
this; it runs on the card, or on the CPU at a small size in the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness.common import Run, cell, plugin  # noqa: E402

LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def readings(c: dict, seed: int, device) -> dict:
    run = Run(cell=c, seed=seed, seconds=0.0, trace=False,
              device=torch.device(device), t_start=time.time())
    return plugin("loops", c["traffic"]["loop"]).control_readings(
        run, LOWER[c["config"]["compute_dtype"]])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = cell(a.workload)
    for seed in a.seeds:
        for name, numbers in readings(c, seed, "cuda:0").items():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "reading": name, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
