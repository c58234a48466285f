"""Per-rank input sharding: each rank keeps its rows of the global batch.

Port of ``mme_tpu/parallel/data.py``. Every rank runs the same sampler
order from the same seed (``train/policies.py::epoch_order``) and builds
the same global batch on the host, then keeps the contiguous rows of its
coordinate along the batch axis, so the rows the ranks hold together are
the single-process batch. Bucketed batches (``data/dataset.py::
BucketedBatchIter``) are tail-padded to the static batch size, so they
shard the same way (``mme_tpu/train/loop.py:58-69``).

The iterators yield ``(features, labels, sample_mask, rows)``: this rank's
rows of the first three and a :class:`GlobalRows` with the global batch's
indices, labels and mask, which the loop's host bookkeeping (dialog
accumulation, prediction dumps) reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from mme_tpu_torch.data.dataset import ArrayDataset, batches
from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class GlobalRows:
    """The global batch's host bookkeeping beside a rank's rows."""

    indices: np.ndarray
    labels: np.ndarray
    mask: np.ndarray


def host_slice(global_indices: np.ndarray,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> np.ndarray:
    """The contiguous slice of a global batch-index array that a process
    keeps (default: this rank of the world)."""
    pi = distributed.rank() if process_index is None else process_index
    pc = (distributed.world_size() if process_count is None
          else process_count)
    per = len(global_indices) // pc
    return global_indices[pi * per:(pi + 1) * per]


def _local(x: np.ndarray, index: int, size: int) -> np.ndarray:
    per = len(x) // size
    if per * size != len(x):
        raise ValueError(f"a batch of {len(x)} rows does not split over "
                         f"{size} ranks")
    return x[index * per:(index + 1) * per]


def shard_batches(src: Iterator, mesh: Mesh, axis: str = "dp"
                  ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray,
                                      np.ndarray, GlobalRows]]:
    """Shard an existing ``(batch, labels, mask, idx)`` iterator of global
    host batches (``batches``, ``BucketedBatchIter``) over ``axis``."""
    ax = mesh.axis(axis)
    for batch, labels, mask, idx in src:
        yield ({k: _local(v, ax.index, ax.size) for k, v in batch.items()},
               _local(labels, ax.index, ax.size),
               _local(mask, ax.index, ax.size),
               GlobalRows(np.asarray(idx), np.asarray(labels),
                          np.asarray(mask)))


def global_batches(ds: ArrayDataset, order: np.ndarray, global_batch: int,
                   mesh: Mesh, axis: str = "dp"):
    """``batches(ds, order, global_batch)`` sharded over ``axis``."""
    return shard_batches(batches(ds, order, global_batch), mesh, axis)


def global_rows(idx: Any, labels: np.ndarray, mask: np.ndarray
                ) -> GlobalRows:
    """The :class:`GlobalRows` of a batch: the sharded iterators' own, or
    an unsharded batch's."""
    if isinstance(idx, GlobalRows):
        return idx
    return GlobalRows(np.asarray(idx), np.asarray(labels), np.asarray(mask))
