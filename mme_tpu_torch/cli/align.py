"""Forced-alignment CLI: per-utterance (start_sec, end_sec) timings for
every row of a dataset pickle, written back as its ``timings`` column.

Port of ``mme_tpu/cli/align.py``. Emissions are read from
``--emissions_dir/<row index>.npy`` (log-probabilities [T, C] of any CTC
character model), with a ``--labels`` file naming the CTC vocabulary (one
character per line, blank first). A row without an emission file, or
whose transcript does not align, gets None. The pickle is read with
``pickle.load``: a frame (where pandas is installed) or a plain mapping of
column name → array, and the output is the same kind. The row's sample
count comes from ``--num_samples_col``, else ``T·320``. The trellis runs
on the card::

    python -m mme_tpu_torch.cli.align data.pkl --emissions_dir em/ \\
        --labels ctc_labels.txt --out data_timed.pkl

and on the CPU only through ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from mme_tpu_torch.data.alignment import utterance_bounds
from mme_tpu_torch.device import DeviceLike, resolve_device


def load_labels(path: str) -> dict:
    with open(path) as f:
        chars = [line.rstrip("\n") for line in f]
    return {c: i for i, c in enumerate(chars) if i > 0}  # 0 = blank


def _rows(table):
    """The rows of a frame (as Series) or of a mapping of columns (as
    dicts)."""
    if hasattr(table, "iterrows"):
        for _, row in table.iterrows():
            yield row
        return
    n = len(next(iter(table.values()))) if len(table) else 0
    for i in range(n):
        yield {k: v[i] for k, v in table.items()}


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> str:
    p = argparse.ArgumentParser("mme_tpu_torch forced alignment")
    p.add_argument("pickle", help="dataset pickle with text/audio columns")
    p.add_argument("--emissions_dir", required=True,
                   help="dir of <row>.npy CTC log-prob emissions")
    p.add_argument("--labels", required=True,
                   help="CTC label file, blank first, one char per line")
    p.add_argument("--out", default=None, help="output pickle path")
    p.add_argument("--text_col", default="text")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--num_samples_col", default="audio_shape")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    with open(args.pickle, "rb") as fh:
        table = pickle.load(fh)
    char2id = load_labels(args.labels)
    timings = []
    for i, row in enumerate(_rows(table)):
        em_path = os.path.join(args.emissions_dir, f"{i}.npy")
        if not os.path.exists(em_path):
            timings.append(None)
            continue
        em = np.load(em_path)
        n_samples = int(row.get(args.num_samples_col, em.shape[0] * 320))
        timings.append(utterance_bounds(em, str(row[args.text_col]),
                                        char2id, n_samples,
                                        args.sample_rate, device=dev))
    if hasattr(table, "assign"):
        table = table.assign(timings=timings)
    else:
        table = dict(table, timings=timings)
    out = args.out or args.pickle.replace(".pkl", "_timed.pkl")
    with open(out, "wb") as fh:
        pickle.dump(table, fh, protocol=pickle.HIGHEST_PROTOCOL)
    aligned = sum(t is not None for t in timings)
    print(f"aligned {aligned}/{len(timings)} rows → {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
