"""Test-prediction dumps: per-sample ``label , prediction`` lines appended
to a text file for offline re-evaluation (the reference's
``ResultsFromTest/*.txt``).

Port of ``mme_tpu/evals/dumps.py`` (numpy only, the same file format).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def dump_predictions(path: str, labels: Sequence[int],
                     preds: Sequence[int],
                     mask: Optional[Sequence[int]] = None) -> None:
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    keep = (np.asarray(mask).reshape(-1).astype(bool)
            if mask is not None else np.ones(len(labels), bool))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for l, p, k in zip(labels, preds, keep):
            if k:
                f.write(f"{int(l)} , {int(p)}\n")


def load_dump(path: str):
    """Parse a dump file back to (labels, preds) arrays."""
    labels, preds = [], []
    with open(path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if len(parts) >= 2:
                labels.append(int(float(parts[0])))
                preds.append(int(float(parts[1])))
    return np.asarray(labels), np.asarray(preds)
