"""The reference loop's policies as pure functions: epoch-parity sampling
and dialog-aligned gradient accumulation.

Port of ``mme_tpu/train/policies.py`` (numpy only, the same numbers for
the same generator).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def epoch_order(rng: np.random.Generator, epoch: int, epoch_switch: int,
                weights: np.ndarray, num_samples: int) -> np.ndarray:
    """Even ``epoch % epoch_switch`` → multinomial draw with replacement
    over ``weights``; odd → ``arange``."""
    if epoch % epoch_switch == 0:
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
        return rng.choice(len(p), size=num_samples, replace=True, p=p)
    return np.arange(num_samples)


def sample_weights_from_labels(labels: Sequence[int],
                               class_weights: np.ndarray) -> np.ndarray:
    """Per-sample sampling weight = the class weight of its label."""
    return np.asarray(class_weights)[np.asarray(labels, np.int64)]


@dataclasses.dataclass
class DialogAccumulator:
    """``counts[d]`` = utterances of dialog d, by dialog id. ``step(i)``
    returns (dialog_size, is_boundary) for sample index i in sequential
    order."""

    counts: List[int]

    def __post_init__(self):
        self.prefix = np.cumsum(self.counts)

    def step(self, i: int) -> Tuple[int, bool]:
        d = int(np.searchsorted(self.prefix, i, side="right"))
        d = min(d, len(self.counts) - 1)
        boundary = (i + 1 == self.prefix[d])
        return int(self.counts[d]), bool(boundary)


def dialog_counts(dialog_ids: Sequence[int]) -> List[int]:
    """Utterances per dialog, sorted by dialog id."""
    ids, counts = np.unique(np.asarray(dialog_ids), return_counts=True)
    return counts[np.argsort(ids)].tolist()
