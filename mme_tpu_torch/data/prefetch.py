"""Prefetch of the host input pipeline onto the device.

Port of ``mme_tpu/data/prefetch.py``: a producer thread moves the NEXT
batches' feature arrays to the device while the current step computes, so
the host→device copy overlaps compute. The sentinel, the error raised
consumer-side and the producer's exit when the consumer abandons the
iterator are JAX's.

On a CUDA device each feature goes through pinned host memory and is
copied ``non_blocking`` on a side stream; the consumer's stream waits on an
event recorded after the copies, and every feature tensor is marked with
``record_stream`` so the caching allocator does not hand its memory to a
later allocation of the side stream while a kernel of the consumer's
stream still reads it. On the CPU the features become tensors that share
the numpy arrays' memory.

Labels, the sample mask and the indices stay host numpy: the train loop
reads the mask on the host for dialog accumulation.

Under a ``torch.profiler`` session the consumer records the span
``mme.prefetch.wait`` around each batch's wait: the queue and the stream's
wait on the copies (``utils/profiling.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.utils.profiling import span

_SENTINEL = object()

Batch = Tuple[Dict[str, Any], Any, Any, Any]


def _to_cpu_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


def prefetch_batches(it: Iterator[Batch], device: DeviceLike = "cuda",
                     depth: int = 2) -> Iterator[Batch]:
    """Wrap a (features, labels, mask, idx) iterator: the features arrive
    as tensors on ``device``, moved by a producer thread up to ``depth``
    batches ahead. An exception of the producer is raised in the consumer;
    the producer is a daemon thread and stops once the consumer is gone."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that gives up once the consumer is gone, so the
        producer does not pin ``depth`` device batches forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            side = None
            if cuda:
                torch.cuda.set_device(dev)
                side = torch.cuda.Stream(dev)
            for batch, labels, mask, idx in it:
                if stop.is_set():
                    return
                ready = None
                if cuda:
                    with torch.cuda.stream(side):
                        feats = {k: _to_cpu_tensor(v).pin_memory().to(
                            dev, non_blocking=True) for k, v in batch.items()}
                    ready = torch.cuda.Event()
                    ready.record(side)
                else:
                    feats = {k: _to_cpu_tensor(v) for k, v in batch.items()}
                if not _put((feats, ready, labels, mask, idx)):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — raised consumer-side
            _put(e)

    t = threading.Thread(target=producer, daemon=True, name="mme-prefetch")
    t.start()
    try:
        while True:
            with span("mme.prefetch.wait"):
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                feats, ready, labels, mask, idx = item
                if ready is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ready)
                    for v in feats.values():
                        v.record_stream(stream)
            yield feats, labels, mask, idx
    finally:
        # consumer closed (exhausted, broken out of, or failed): release the
        # producer and drop its queued device batches
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
