"""Host-side dataset: packed numpy arrays and static-shape batch assembly.

Port of ``mme_tpu/data/dataset.py`` (numpy only, the same batches):
``ArrayDataset``, ``batches`` (the tail batch padded by repeating the
epoch's first index with ``sample_mask`` 0) and the length-bucketed
``bucketed_batches`` / ``BucketedBatchIter`` with tail promotion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    features: Dict[str, np.ndarray]
    labels: np.ndarray
    dialog_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.labels)
        for k, v in self.features.items():
            if len(v) != n:
                raise ValueError(f"feature {k} has {len(v)} rows, labels {n}")

    def __len__(self) -> int:
        return len(self.labels)

    def gather(self, indices: np.ndarray
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        batch = {k: v[indices] for k, v in self.features.items()}
        return batch, self.labels[indices]


def batches(ds: ArrayDataset, order: np.ndarray, batch_size: int
            ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray,
                                np.ndarray, np.ndarray]]:
    """Yield (batch, labels, sample_mask, batch_indices) of a fixed batch
    size; padded rows count in neither loss nor metrics."""
    n = len(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        mask = np.ones(batch_size, np.int32)
        if len(idx) < batch_size:
            pad = batch_size - len(idx)
            mask[len(idx):] = 0
            idx = np.concatenate([idx, np.full(pad, order[0])])
        batch, labels = ds.gather(idx)
        yield batch, labels, mask, idx


class BucketedBatchIter:
    """Length-bucketed batch iterator behind the loop's 4-tuple protocol,
    with ``epoch_len`` so the loop's end-of-epoch bookkeeping stays exact
    (per-bucket tails make more batches than ``ceil(n / batch)``)."""

    def __init__(self, bucket_bounds: Tuple[int, ...],
                 mask_key: str = "audio_mask",
                 length_keys: Tuple[str, ...] = ("waveform", "audio_mask")):
        self.bucket_bounds = tuple(sorted(bucket_bounds))
        self.mask_key = mask_key
        self.length_keys = length_keys

    def _lengths(self, ds: ArrayDataset) -> np.ndarray:
        return np.asarray(ds.features[self.mask_key]).sum(axis=1)

    def epoch_len(self, ds: ArrayDataset, order: np.ndarray,
                  batch_size: int) -> int:
        bucket_of = np.searchsorted(self.bucket_bounds,
                                    self._lengths(ds)[order])
        counts = np.bincount(bucket_of, minlength=len(self.bucket_bounds))
        # bucketed_batches' tail promotion: every bucket but the last gives
        # only full batches, its remainder rides up to the next
        total, carry = 0, 0
        for b, c in enumerate(counts):
            rows = int(c) + carry
            if b < len(counts) - 1:
                total += rows // batch_size
                carry = rows % batch_size
            else:
                total += int(np.ceil(rows / batch_size))
        return total

    def __call__(self, ds: ArrayDataset, order: np.ndarray, batch_size: int):
        for batch, labels, mask, idx, _bound in bucketed_batches(
                ds, order, batch_size, self._lengths(ds),
                self.bucket_bounds, self.length_keys):
            yield batch, labels, mask, idx


def bucketed_batches(ds: ArrayDataset, order: np.ndarray, batch_size: int,
                     sample_lengths: np.ndarray,
                     bucket_bounds: Tuple[int, ...],
                     length_keys: Tuple[str, ...] = ("waveform",
                                                     "audio_mask")):
    """Group samples by true length and cut the ragged features of each
    batch to its bucket bound. Yields (batch, labels, sample_mask, indices,
    bound). Each bucket's remainder below a batch is promoted into the next
    larger bucket, so only the largest bucket pays a padded tail."""
    bounds = sorted(bucket_bounds)
    if sample_lengths.max() > bounds[-1]:
        raise ValueError(f"max length {sample_lengths.max()} exceeds largest "
                         f"bucket {bounds[-1]}")
    bucket_of = np.searchsorted(bounds, sample_lengths[order])
    carry = np.empty((0,), dtype=order.dtype)
    for b, bound in enumerate(bounds):
        sel = np.concatenate([carry, order[bucket_of == b]])
        if b < len(bounds) - 1:
            keep = len(sel) - len(sel) % batch_size
            carry = sel[keep:]
            sel = sel[:keep]
        if len(sel) == 0:
            continue
        for batch, labels, mask, idx in batches(ds, sel, batch_size):
            sliced = {k: (v[:, :bound] if k in length_keys else v)
                      for k, v in batch.items()}
            yield sliced, labels, mask, idx, bound
