"""Plain float32 building blocks of the reference models.

Every matrix product, convolution and attention product goes through
:func:`quant`, which is the identity unless a control run asks for fp8
operands (``set_precision("fp8")``: each operand rounded to float8 e4m3 at
a per-tensor scale, the products summed in float32, gradients passed
straight through the rounding). TF32 is a global switch of PyTorch and is
set by the caller (:func:`reference.fp32_math`).

The modules' parameter names are the state-dict keys of the measured
models, so one state dict loads into both. Each module records what its
weight is (``KIND``) for the benchmark's weight draw.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = {"mode": "fp32"}
FP8_MAX = 448.0   # largest finite float8 e4m3fn


def set_precision(mode: str) -> None:
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"unknown reference precision {mode!r}")
    _PRECISION["mode"] = mode


def quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or in fp8 mode ``x`` rounded to e4m3 at a per-tensor
    scale (its largest magnitude maps to 448), with the gradient passed
    through unchanged."""
    if _PRECISION["mode"] != "fp8":
        return x
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x).detach()


def empty(*shape: int, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class Linear(nn.Module):
    """y = x Wᵀ + b, W [out, in]."""

    KIND = "linear"

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.weight = empty(n_out, n_in, device=device)
        self.bias = empty(n_out, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(quant(x), quant(self.weight), self.bias)


class Embedding(nn.Module):
    KIND = "embedding"

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = empty(num, dim, device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


class LayerNorm(nn.Module):
    """Last-axis LayerNorm, biased variance, in float32."""

    KIND = "norm"

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = empty(dim, device=device)
        self.bias = empty(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight + self.bias


class Conv1d(nn.Module):
    """Channels-last 1-D convolution [B, T, C_in] → [B, T', C_out]; W is
    [out, in/groups, k]."""

    KIND = "conv"

    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = empty(n_out, n_in // groups, k, device=device)
        self.bias = empty(n_out, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(quant(x.transpose(1, 2)), quant(self.weight), self.bias,
                     self.stride, self.padding, 1, self.groups)
        return y.transpose(1, 2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def key_bias(keep: torch.Tensor) -> torch.Tensor:
    """[B, S] keep-mask (1 = attend) → [B, 1, 1, S] additive bias: masked
    keys get a weight of exactly 0 after the softmax."""
    return (1.0 - keep.float())[:, None, None, :] * -1e30


QKV_BIAS = {"full": (1.0, 1.0, 1.0), "qv": (1.0, 0.0, 1.0)}


class Attention(nn.Module):
    """Multi-head self-attention with one [3·H·D, hidden] projection and a
    [3, H, D] bias of which ``bias_mode`` says which parts act ("qv": the
    key bias is held at zero, as in VideoMAE)."""

    KIND = "attention"

    def __init__(self, hidden: int, heads: int, bias_mode: str, device=None):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        self.qkv = Linear(hidden, 3 * hidden, bias=False, device=device)
        self.qkv.KIND = "qkv"
        self.qkv_bias = empty(3, heads, self.head_dim, device=device)
        self.register_buffer("bias_mask", torch.tensor(
            QKV_BIAS[bias_mode], device=device).reshape(3, 1, 1),
            persistent=False)
        self.out = Linear(hidden, hidden, device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        B, S, _ = x.shape
        qkv = self.qkv(x) + (self.qkv_bias * self.bias_mask).reshape(-1)
        qkv = qkv.view(B, S, 3, self.heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = quant(q) @ quant(k).transpose(-1, -2) / math.sqrt(
            self.head_dim)
        if bias is not None:
            scores = scores + bias
        p = torch.softmax(scores, dim=-1)
        ctx = (quant(p) @ quant(v)).transpose(1, 2).reshape(B, S, -1)
        return self.out(ctx)


class Mlp(nn.Module):
    def __init__(self, hidden: int, inter: int, device=None):
        super().__init__()
        self.fc1 = Linear(hidden, inter, device=device)
        self.fc2 = Linear(inter, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    """A transformer block: pre-LN (x + attn(ln1 x), then + mlp(ln2 x)) or
    post-LN (ln1(x + attn x), then ln2(x + mlp x))."""

    def __init__(self, e: dict, device=None):
        super().__init__()
        self.pre = e["ln_style"] == "pre"
        self.attention = Attention(e["hidden"], e["heads"], e["qkv_bias"],
                                   device=device)
        self.mlp = Mlp(e["hidden"], e["intermediate"], device=device)
        self.ln1 = LayerNorm(e["hidden"], e["ln_eps"], device=device)
        self.ln2 = LayerNorm(e["hidden"], e["ln_eps"], device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.pre:
            x = x + self.attention(self.ln1(x), bias)
            return x + self.mlp(self.ln2(x))
        x = self.ln1(x + self.attention(x, bias))
        return self.ln2(x + self.mlp(x))


class Encoder(nn.Module):
    """``layer_<i>`` blocks, then ``final_ln`` where the stack has one."""

    def __init__(self, e: dict, device=None):
        super().__init__()
        self.n = e["layers"]
        for i in range(self.n):
            self.add_module(f"layer_{i}", Block(e, device=device))
        self.final_ln = (LayerNorm(e["hidden"], e["ln_eps"], device=device)
                         if e.get("final_ln") else None)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x, bias)
        return x if self.final_ln is None else self.final_ln(x)


def masked_mean(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Mean of x [B, S, H] over the positions keep [B, S] marks (at least
    one counted, so an empty row gives 0)."""
    m = keep.float()[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
