"""Batched inference serving: fixed-size chunks, padded ragged requests.

Port of ``mme_tpu/serve.py`` (``_pad_rows``, ``_batched_call``,
``Predictor``). Requests come as dicts of numpy arrays with a common leading
dim; they are padded up to ``batch_size`` rows per chunk and the padding is
masked back out of the response. uint8 video is normalised on the device.
Mesh serving, ``export_bundle``/``load_bundle`` and the HTTP daemon are not
ported yet.

Use: ``p = Predictor(TAVModel(spec), batch_size=8); preds, probs = p(batch)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.train.build_tav import normalize_uint8_video


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _batched_call(forward: Callable, batch: Dict[str, Any], batch_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged requests up to ``batch_size``-row chunks, run
    ``forward(chunk) -> (preds, probs)`` and drop the padding rows."""
    n = len(next(iter(batch.values())))
    preds, probs = [], []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        chunk = {k: _pad_rows(np.asarray(v[lo:hi]), batch_size)
                 for k, v in batch.items()}
        p, pr = forward(chunk)
        preds.append(p[: hi - lo])
        probs.append(pr[: hi - lo])
    return np.concatenate(preds), np.concatenate(probs)


class Predictor:
    """Fixed-shape batched predictor around a classifier ``model``
    (``model(batch) -> logits``, e.g. ``TAVModel``).

    ``device``: where the model runs; ``cuda`` unless the caller asks for
    the CPU. ``param_dtype=torch.bfloat16`` stores the weights in bf16 —
    half the memory; logits and probabilities stay fp32."""

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 device: DeviceLike = "cuda",
                 param_dtype: Optional[torch.dtype] = None):
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if param_dtype is not None:
            for p in self.model.parameters():
                p.data = p.data.to(param_dtype)

    def _forward(self, chunk: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in chunk.items()}
        v = batch.get("video")
        if v is not None and v.dtype == torch.uint8:
            batch["video"] = normalize_uint8_video(v)
        with torch.inference_mode():
            logits = self.model(batch)
            probs = torch.softmax(logits.float(), dim=-1)
            preds = torch.argmax(logits, dim=-1)
        return preds.cpu().numpy(), probs.cpu().numpy()

    def __call__(self, batch: Dict[str, Any]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """batch: dict of arrays with a common leading dim (larger than
        ``batch_size`` is chunked). Returns (preds [N], probs [N, C])."""
        return _batched_call(self._forward, batch, self.batch_size)
