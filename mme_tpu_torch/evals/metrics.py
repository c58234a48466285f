"""Classification metrics from one confusion matrix.

Port of ``mme_tpu/evals/metrics.py``: ``confusion_matrix``, the scores
derived from it (``scores_from_confusion``) and the stateful ``Metrics``
with the reference's ``update_metrics`` / ``compute_scores`` /
``reset_metrics`` API and key scheme (``"{split}/multiF1/{label}"``,
``"{split}/confusion_matrix"``). The matrix stays on its device while it
accumulates; only ``compute_scores`` copies it to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mme_tpu_torch.device import DeviceLike


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


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def scores_from_confusion(cm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every reference statistic from one confusion matrix, in fp32, with
    torchmetrics semantics: per-class accuracy equals per-class recall,
    macro accuracy is the mean recall, a class absent from targets and
    predictions scores 0, weighted F1 weights by target support."""
    cm = cm.to(torch.float32)
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)        # true count per class
    pred_count = cm.sum(dim=0)     # predicted count per class
    total = cm.sum()

    precision = _safe_div(tp, pred_count)
    recall = _safe_div(tp, support)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": recall,
        "macro_f1": f1.mean(),
        "weighted_f1": _safe_div((f1 * support).sum(), total),
        "macro_recall": recall.mean(),
        "macro_precision": precision.mean(),
        "macro_accuracy": recall.mean(),
        "micro_accuracy": _safe_div(tp.sum(), total),
    }


class Metrics:
    """The reference ``Metrics`` API over one int32 confusion matrix kept on
    ``device``; a matrix merged from another device moves the sum there."""

    def __init__(self, num_classes: int, id2label: Dict[int, str],
                 device: DeviceLike = "cpu"):
        self.num_classes = num_classes
        self.id2label = id2label
        self.device = torch.device(device)
        self.reset_metrics()

    def reset_metrics(self) -> None:
        self.cm = torch.zeros((self.num_classes, self.num_classes),
                              dtype=torch.int32, device=self.device)

    def update_metrics(self, preds: torch.Tensor, target: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> None:
        self.merge(confusion_matrix(preds, target, self.num_classes, weights))

    def merge(self, cm: torch.Tensor) -> None:
        """Fold in a confusion matrix made by a step; no host sync."""
        if cm.device != self.cm.device:
            self.device = cm.device
            self.cm = self.cm.to(cm.device)
        self.cm = self.cm + cm.to(torch.int32)

    def compute_scores(self, name: str) -> Tuple[
            Dict[str, float], Dict[str, float], Dict[str, float],
            Dict[str, float], float, float, float, float, float, np.ndarray]:
        """The reference 10-tuple: four per-class dicts keyed
        ``"{name}/multi{Acc,F1,Rec,Prec}/{label}"``, then macro accuracy,
        macro F1, weighted F1, macro recall, macro precision and the
        confusion matrix."""
        cm = self.cm.cpu()
        s = scores_from_confusion(cm)
        lbl = self.id2label
        per_class = [{f"{name}/multi{key}/{lbl[i]}": float(s[field][i])
                      for i in range(self.num_classes)}
                     for key, field in (("Acc", "accuracy"), ("F1", "f1"),
                                        ("Rec", "recall"),
                                        ("Prec", "precision"))]
        return (*per_class,
                float(s["macro_accuracy"]), float(s["macro_f1"]),
                float(s["weighted_f1"]), float(s["macro_recall"]),
                float(s["macro_precision"]), cm.numpy())

    def summary(self, name: str, include_confusion: bool = False
                ) -> Dict[str, float]:
        """Flat scalar dict in the reference's ``log()`` key scheme;
        ``include_confusion`` adds the matrix as nested lists."""
        (multi_acc, multi_f1, multi_rec, multi_prec,
         acc, f1_macro, f1_weighted, rec, prec, cm) = self.compute_scores(name)
        d = {
            f"{name}/acc": acc,
            f"{name}/precision": prec,
            f"{name}/recall": rec,
            f"{name}/weighted-f1-score": f1_weighted,
            f"{name}/macro-f1-score": f1_macro,
        }
        d.update(multi_f1)
        d.update(multi_rec)
        d.update(multi_prec)
        d.update(multi_acc)
        if include_confusion:
            d[f"{name}/confusion_matrix"] = cm.tolist()
        return d
