"""Classification metrics from one confusion matrix.

Port of ``mme_tpu/evals/metrics.py::confusion_matrix``, the part the train
and eval steps need; the scores derived from the matrix are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def confusion_matrix(preds: torch.Tensor, target: torch.Tensor,
                     num_classes: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cm[t, p]`` counts samples with true class ``t`` predicted ``p``
    (rows = targets, columns = predictions), int32 [C, C]. ``weights``
    (0/1) leaves padded batch rows out."""
    preds = preds.reshape(-1).to(torch.int64)
    target = target.reshape(-1).to(torch.int64)
    w = (torch.ones_like(preds, dtype=torch.int32) if weights is None
         else weights.reshape(-1).to(torch.int32))
    flat = torch.zeros(num_classes * num_classes, dtype=torch.int32,
                       device=preds.device)
    flat.index_add_(0, target * num_classes + preds, w)
    return flat.reshape(num_classes, num_classes)
