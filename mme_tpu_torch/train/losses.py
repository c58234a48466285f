"""Losses: cross entropy with torch-compatible class weighting, the
epoch-parity weight switch and the soft F-beta / precision losses.

Port of ``mme_tpu/train/losses.py``. Every loss has the signature
``(logits, labels, class_weights, sample_mask)``; the batch loss of the
weighted cross entropy is ``sum_i w[y_i]·nll_i / sum_i w[y_i]``, and
``sample_mask`` (1/0) leaves padded batch rows out.

Every sum over the batch goes through ``parallel/mesh.py::batch_sum``, so
under a dp step each rank's loss is the global batch's: the numerator and
the denominator of the cross entropy, and the soft tp / fp / fn counts of
the F-beta and precision losses, are summed over the ranks (differentiably)
before the ratio, as one process holding the whole batch computes them.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mme_tpu_torch.parallel.mesh import batch_sum


def class_weights_from_counts(counts: np.ndarray) -> np.ndarray:
    """``w_c = 1 − n_c/N``."""
    counts = np.asarray(counts, np.float64)
    return (1.0 - counts / counts.sum()).astype(np.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Optionally class-weighted) mean cross entropy in fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = labels.to(torch.int64)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    w = (class_weights.float()[labels] if class_weights is not None
         else torch.ones_like(nll))
    if sample_mask is not None:
        w = w * sample_mask.to(w.dtype)
    return batch_sum((nll * w).sum()) / torch.clamp(batch_sum(w.sum()),
                                                    min=1e-9)


def epoch_parity_weights(class_weights: torch.Tensor, epoch: int,
                         epoch_switch: int) -> torch.Tensor:
    """Even ``epoch % epoch_switch`` → uniform weights (plain CE), else the
    class weights."""
    if (epoch % epoch_switch) != 0:
        return class_weights
    return torch.ones_like(class_weights)


def _soft_pr(logits: torch.Tensor, labels: torch.Tensor,
             sample_mask: Optional[torch.Tensor], epsilon: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class soft precision and recall from softmax probabilities."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.to(torch.int64), logits.shape[-1]).float()
    if sample_mask is not None:
        m = sample_mask.float()[:, None]
        probs = probs * m
        onehot = onehot * m
    tp, fp, fn = batch_sum(torch.stack([
        (onehot * probs).sum(dim=0), ((1.0 - onehot) * probs).sum(dim=0),
        (onehot * (1.0 - probs)).sum(dim=0)]))
    return tp / (tp + fp + epsilon), tp / (tp + fn + epsilon)


def _one_minus_weighted_mean(score: torch.Tensor,
                             class_weights: Optional[torch.Tensor]
                             ) -> torch.Tensor:
    w = (class_weights.float() if class_weights is not None
         else torch.ones_like(score))
    return 1.0 - (score * w).sum() / torch.clamp(w.sum(), min=1e-9)


def soft_fbeta_loss(logits: torch.Tensor, labels: torch.Tensor,
                    class_weights: Optional[torch.Tensor] = None,
                    sample_mask: Optional[torch.Tensor] = None,
                    *, beta: float = 1.0,
                    epsilon: float = 1e-7) -> torch.Tensor:
    """Differentiable 1 − weighted-mean F_beta over classes, in [0, 1]."""
    precision, recall = _soft_pr(logits, labels, sample_mask, epsilon)
    b2 = beta * beta
    fbeta = (1.0 + b2) * precision * recall / (b2 * precision + recall
                                               + epsilon)
    return _one_minus_weighted_mean(
        torch.clamp(fbeta, epsilon, 1.0 - epsilon), class_weights)


def soft_precision_loss(logits: torch.Tensor, labels: torch.Tensor,
                        class_weights: Optional[torch.Tensor] = None,
                        sample_mask: Optional[torch.Tensor] = None,
                        *, epsilon: float = 1e-7) -> torch.Tensor:
    """1 − weighted-mean soft precision."""
    precision, _ = _soft_pr(logits, labels, sample_mask, epsilon)
    return _one_minus_weighted_mean(
        torch.clamp(precision, epsilon, 1.0 - epsilon), class_weights)


def make_loss_fn(name: str, beta: float = 1.0) -> Callable:
    """Map the ``--loss`` flag to a loss callable. "CrossEntropy" and
    "NewCrossEntropy" share :func:`cross_entropy`: the epoch-parity switch
    lives in the weight vector (:func:`epoch_parity_weights`)."""
    if name in ("CrossEntropy", "NewCrossEntropy"):
        return cross_entropy
    if name == "FBeta":
        return functools.partial(soft_fbeta_loss, beta=beta)
    if name == "Precision":
        return soft_precision_loss
    raise ValueError(f"unknown loss {name!r} (CrossEntropy, "
                     f"NewCrossEntropy, FBeta, Precision)")
