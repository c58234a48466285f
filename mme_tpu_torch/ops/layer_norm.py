"""LayerNorm with flax numerics.

Port of the flax-numerics path of ``mme_tpu/ops/layer_norm.py::
FusedLayerNorm`` (its fallback at ``:212-219``): fp32 statistics, the fast
variance ``max(0, E[x²] − E[x]²)``, scale and bias used in fp32, and one
final cast. ``torch.nn.functional.layer_norm`` computes the variance another
way, so the port writes its own. The fused LayerNorm kernel (opt-in in JAX,
``MME_FUSED_LN``) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis of ``x``; the result is in ``dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((x32 - mean) * mul + bias.float()).to(dtype)


class FusedLayerNorm(nn.Module):
    """Last-axis LayerNorm with ``weight`` (flax ``scale``) and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)
