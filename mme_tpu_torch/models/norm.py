"""Flax-semantics normalisation layers with learned scale and bias:
``BatchNorm`` (running statistics in buffers) and ``GroupNorm``.

Both compute their statistics in fp32 whatever the input's dtype, with
flax's fast variance ``E[x²] − E[x]²`` clipped at 0, and normalise as flax
does: ``(x − mean) · (rsqrt(var + eps) · scale) + bias``, cast to ``dtype``.

``BatchNorm`` keeps flax's ``batch_stats`` as the buffers ``mean`` (zeros)
and ``var`` (ones). In training mode (``.train()``) it normalises with the
batch's statistics and updates the buffers as flax does,
``ra = momentum · ra + (1 − momentum) · batch``, with the **biased** batch
variance; ``torch.nn.BatchNorm*`` stores the unbiased n/(n−1) estimate
instead, so its running variance drifts from JAX's. In eval mode it
normalises with the buffers. Under a dp step the batch statistics are the
global batch's, as flax's inside one jitted step over a sharded batch: the
sums of x and x² are summed over the ranks (``parallel/mesh.py::
batch_sum``, differentiably) before the mean and variance.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.parallel.mesh import batch_axis, batch_count, batch_sum


def _stats(x: torch.Tensor, dims: Sequence[int]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 mean and biased variance over ``dims`` (kept), as flax's
    ``_compute_stats`` with ``use_fast_variance``."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    mean2 = (xf * xf).mean(dim=dims, keepdim=True)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _global_stats(x: torch.Tensor, dims: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_stats` over the global batch: the ranks' sums of x and x²
    are summed before the ratios (every rank holds as many rows)."""
    xf = x.float()
    n = batch_count(x.shape[0]) * (x.numel() // (x.shape[0] * x.shape[1]))
    sums = batch_sum(torch.stack([xf.sum(dim=dims, keepdim=True),
                                  (xf * xf).sum(dim=dims, keepdim=True)]))
    mean, mean2 = sums[0] / n, sums[1] / n
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    mul = torch.rsqrt(var + eps) * weight
    return ((x.float() - mean) * mul + bias).to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 of a channels-first tensor [B, C, ...] (flax
    ``nn.BatchNorm`` over the last axis of the channels-last one):
    ``weight`` (flax ``scale``), ``bias``, and the buffers ``mean`` and
    ``var``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean, var = (_stats(x, dims) if batch_axis() is None
                         else _global_stats(x, dims))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean.reshape(-1))
                self.var.copy_(m * self.var + (1.0 - m) * var.reshape(-1))
        else:
            mean, var = self.mean.reshape(shape), self.var.reshape(shape)
        return _normalize(x, mean, var, self.weight.reshape(shape),
                          self.bias.reshape(shape), self.eps, self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over the last axis of a channels-last tensor [B, ..., C]
    (flax ``nn.GroupNorm``): statistics per sample and group over every
    other axis."""

    def __init__(self, features: int, num_groups: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{features} channels")
        dev = resolve_device(device)
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, g = x.shape[0], x.shape[-1], self.num_groups
        grouped = x.reshape(B, -1, g, C // g)
        mean, var = _stats(grouped, (1, 3))
        y = _normalize(grouped, mean, var, self.weight.reshape(g, C // g),
                       self.bias.reshape(g, C // g), self.eps, self.dtype)
        return y.reshape(x.shape)
