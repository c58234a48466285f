"""Shared transformer building blocks.

Port of ``mme_tpu/models/layers.py``: ``EncoderSpec``, ``activation``,
``MultiHeadAttention`` (one fused QKV projection), ``Mlp``, pre- and
post-LN ``EncoderBlock`` and ``TransformerEncoder``; plus ``Dense`` and
``Embed``, the port's counterparts of flax's ``nn.Dense`` and ``nn.Embed``.
``Mlp`` takes the fused kernel of ``ops/fused_mlp.py`` where ``MME_FUSED_MLP``
opts in. The sequence/pipeline-parallel and scan-over-layers branches of the
JAX module are not ported yet.

Mixed precision follows flax's policy: parameters stay fp32 (or whatever
dtype the caller stored them in) and are cast to the compute dtype where
they are used; LayerNorm and softmax run in fp32.

Training mode: ``nn.Module.training`` plays flax's ``deterministic=False``.
Dropout sits where the JAX modules have it (attention output before the
out-projection, MLP output, attention branch before the residual add) and
draws from the ``torch.Generator`` handed down from the train step, never
from the global RNG; a module in training mode with a dropout rate and no
generator raises. ``EncoderSpec.remat`` recomputes each block in the
backward pass with the generator rewound, so the recomputed masks are the
first pass's.

Parameters are allocated uninitialised: weights come from a flax tree
through ``mme_tpu_torch/convert.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.ops.attention import dot_product_attention_shd
from mme_tpu_torch.ops.fused_mlp import fused_mlp, use_fused_mlp
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Architecture knobs shared by every encoder family."""

    hidden: int = 768
    heads: int = 12
    layers: int = 12
    intermediate: int = 3072
    ln_style: str = "post"           # "post" (BERT) | "pre" (ViT/stable-LN)
    qkv_bias: str = "full"           # "full" | "qv" (VideoMAE) | "none"
    ln_eps: float = 1e-12
    act: str = "gelu"                # exact gelu to match HF defaults
    dropout: float = 0.0
    attention_dropout: float = 0.0
    final_ln: bool = False            # pre-LN stacks end with a LayerNorm
    # the scratch MHA's choice of scaling q before or the scores after the
    # softmax's product; the two are the same function, so both fold into
    # the one 1/sqrt(d) scaling, as in JAX
    early_div: bool = False
    dtype: torch.dtype = torch.float32
    remat: bool = False               # recompute each block in the backward


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_new":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"unknown activation {name}")


def dropout(x: torch.Tensor, rate: float, training: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout from an explicit generator (flax ``nn.Dropout``):
    keep with probability ``1 - rate``, scale the kept by ``1/(1 - rate)``.
    Identity outside training mode or at rate 0."""
    if not training or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs the step's "
                         "torch.Generator (rng=...); call .eval() for the "
                         "deterministic forward")
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def empty_param(shape: Union[int, Sequence[int]],
                device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class Dense(nn.Module):
    """``y = x Wᵀ + b`` in ``dtype``; ``weight`` is [out, in] (flax's
    ``kernel`` transposed)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.weight = empty_param((out_features, in_features), dev)
        self.bias = empty_param(out_features, dev) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Embed(nn.Module):
    """Embedding table [num, features]; rows come out in ``dtype``."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.dtype = dtype
        self.weight = empty_param((num, features), resolve_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


_QKV_BIAS_MODES = {"full": (1.0, 1.0, 1.0), "qv": (1.0, 0.0, 1.0),
                   "none": (0.0, 0.0, 0.0)}


class MultiHeadAttention(nn.Module):
    """Self-attention with one fused QKV projection ``[hidden] → [3, H, D]``.

    ``qkv_bias`` is a [3, H, D] parameter masked by the spec's mode:
    ``"qv"`` is VideoMAE's learned q/v bias with a frozen zero k bias,
    ``"none"`` has no parameter at all. q, k and v go to attention as
    strided views of the projection's output, with no copy."""

    def __init__(self, spec: EncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        s = spec
        self.heads = s.heads
        self.head_dim = s.hidden // s.heads
        self.attention_dropout = s.attention_dropout
        # holds the [3·H·D, hidden] weight; forward applies it together
        # with the masked qkv_bias in one F.linear
        self.qkv = Dense(s.hidden, 3 * s.hidden, use_bias=False,
                         dtype=s.dtype, device=dev)
        mode = _QKV_BIAS_MODES[s.qkv_bias]
        if any(mode):
            self.qkv_bias = empty_param((3, s.heads, self.head_dim), dev)
            self.register_buffer(
                "qkv_bias_mask",
                torch.tensor(mode, device=dev).reshape(3, 1, 1),
                persistent=False)
        else:
            self.qkv_bias = None
        self.out = Dense(s.hidden, s.hidden, dtype=s.dtype, device=dev)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, _ = x.shape
        dt = self.qkv.dtype
        b = None
        if self.qkv_bias is not None:
            b = (self.qkv_bias.to(dt) * self.qkv_bias_mask.to(dt)).reshape(-1)
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt), b)
        qkv = qkv.view(B, S, 3, self.heads, self.head_dim)
        out = dot_product_attention_shd(qkv[:, :, 0], qkv[:, :, 1],
                                        qkv[:, :, 2], bias)
        # on the attention output, not on the probabilities (as in JAX)
        out = dropout(out, self.attention_dropout, self.training, rng)
        return self.out(out.reshape(B, S, self.heads * self.head_dim))


class Mlp(nn.Module):
    """fc1 → activation → fc2 → output dropout. Where
    ``ops/fused_mlp.py::use_fused_mlp`` says so (``MME_FUSED_MLP``, default
    off) the three run as one kernel on the rows ``[B·S, H]``, weights cast
    to the compute dtype and biases in fp32; the dropout stays outside it
    and draws from the step's generator either way."""

    def __init__(self, spec: EncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.act_name = s.act
        self.fc1 = Dense(s.hidden, s.intermediate, dtype=s.dtype,
                         device=device)
        self.fc2 = Dense(s.intermediate, s.hidden, dtype=s.dtype,
                         device=device)
        self.act = activation(s.act)
        self.dropout = s.dropout

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.fc1.dtype
        hidden, inter = self.fc1.weight.shape[1], self.fc1.weight.shape[0]
        if use_fused_mlp(x, hidden, inter, dt):
            out = fused_mlp(
                x.reshape(-1, hidden).to(dt), self.fc1.weight.to(dt),
                self.fc1.bias.float(), self.fc2.weight.to(dt),
                self.fc2.bias.float(), self.act_name).reshape(x.shape)
        else:
            out = self.fc2(self.act(self.fc1(x)))
        return dropout(out, self.dropout, self.training, rng)


class EncoderBlock(nn.Module):
    """One transformer block, pre- or post-LN."""

    def __init__(self, spec: EncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.pre_ln = s.ln_style == "pre"
        self.dropout = s.dropout
        self.attention = MultiHeadAttention(s, device=device)
        self.mlp = Mlp(s, device=device)
        self.ln1 = FusedLayerNorm(s.hidden, s.ln_eps, s.dtype, device=device)
        self.ln2 = FusedLayerNorm(s.hidden, s.ln_eps, s.dtype, device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        def attn(y):
            return dropout(self.attention(y, bias, rng), self.dropout,
                           self.training, rng)
        if self.pre_ln:
            x = x + attn(self.ln1(x))
            return x + self.mlp(self.ln2(x), rng)
        x = self.ln1(x + attn(x))                   # post-LN (BERT)
        return self.ln2(x + self.mlp(x, rng))


def remat_call(fn: Callable[..., torch.Tensor],
               rng: Optional[torch.Generator], *args) -> torch.Tensor:
    """``fn(*args, rng)`` under activation checkpointing: its intermediates
    are dropped and recomputed in the backward pass. The recomputation runs
    with ``rng`` rewound to the state of the first pass, so every dropout
    mask comes out the same, and leaves the generator where the backward
    pass found it."""
    if rng is None:
        return checkpoint(lambda *a: fn(*a, None), *args,
                          use_reentrant=False, preserve_rng_state=False)
    start = rng.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a, rng)
        now = rng.get_state()
        rng.set_state(start)
        try:
            return fn(*a, rng)
        finally:
            rng.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class TransformerEncoder(nn.Module):
    """Stack of ``layer_<i>`` EncoderBlocks, then ``final_ln`` if the spec
    asks for it. ``spec.remat`` checkpoints every block while gradients are
    being recorded."""

    def __init__(self, spec: EncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        self.n_layers = spec.layers
        self.remat = spec.remat
        for i in range(spec.layers):
            self.add_module(f"layer_{i}", EncoderBlock(spec, device=device))
        self.final_ln = (FusedLayerNorm(spec.hidden, spec.ln_eps, spec.dtype,
                                        device=device)
                         if spec.final_ln else None)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            x = (remat_call(block, rng, x, bias) if remat
                 else block(x, bias, rng))
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x
