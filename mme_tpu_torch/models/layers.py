"""Shared transformer building blocks.

Port of ``mme_tpu/models/layers.py``: ``EncoderSpec``, ``activation``,
``MultiHeadAttention`` (one fused QKV projection), ``Mlp``, pre- and
post-LN ``EncoderBlock`` and ``TransformerEncoder``; plus ``Dense``,
``Embed`` and ``Conv``, the port's counterparts of flax's ``nn.Dense``,
``nn.Embed`` and ``nn.Conv``.
``Mlp`` takes the fused kernel of ``ops/fused_mlp.py`` where ``MME_FUSED_MLP``
opts in. ``EncoderSpec.seq_mesh`` / ``seq_axis`` run the attention core as
ring attention over that axis of a mesh of ranks (sequence parallelism,
``ops/ring_attention.py``); ``pp_mesh`` / ``pp_axis`` / ``pp_micro`` run
``TransformerEncoder``'s layers as a GPipe pipeline over that axis, one
stage of L / P layers per rank (pipeline parallelism,
``parallel/pipeline.py``; the parameters keep the unrolled layout, so
checkpoints do not depend on it); scan-over-layers has no eager
counterpart.

Tensor parallelism (Megatron): once ``parallel/sharding_rules.py::
shard_model`` has cut the qkv / out and fc1 / fc2 weights over an ``mp``
axis, ``MultiHeadAttention`` runs its local heads and ``Mlp`` its local
slice of the intermediate, each between ``parallel/mesh.py::copy_to_axis``
and ``reduce_from_axis``; the row-parallel layer's bias is added after the
reduction, on every rank.

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

import contextlib
import dataclasses
from typing import (Callable, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.ops.attention import dot_product_attention_shd
from mme_tpu_torch.ops.fused_mlp import fused_mlp, use_fused_mlp
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm
from mme_tpu_torch.parallel.mesh import (AxisGroup, batch_rand,
                                         copy_to_axis, reduce_from_axis)
from mme_tpu_torch.parallel.pipeline import MicrobatchDraws
from mme_tpu_torch.parallel.sharding_rules import shard_of


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
    # sequence parallelism: with both set, the attention core runs as ring
    # attention over ``seq_mesh``'s ``seq_axis`` (a ``parallel/mesh.py::
    # Mesh``); the activations outside it stay whole on every rank
    seq_mesh: Optional[object] = None
    seq_axis: Optional[str] = None
    # pipeline parallelism: with both set (an axis of more than one rank),
    # the layer stack runs as a GPipe pipeline of ``pp_micro``
    # microbatches over ``pp_mesh``'s ``pp_axis``
    pp_mesh: Optional[object] = None
    pp_axis: Optional[str] = None
    pp_micro: int = 4


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
            rng: Optional[torch.Generator],
            split: Optional[AxisGroup] = None) -> torch.Tensor:
    """Inverted dropout from an explicit generator (flax ``nn.Dropout``):
    keep with probability ``1 - rate``, scale the kept by ``1/(1 - rate)``.
    Identity outside training mode or at rate 0. ``split``: ``x`` holds
    this rank's block of a last dimension cut over that axis (the local
    heads); the whole mask is drawn and the block kept, so every rank's
    generator stays in step and the mask is one rank's. ``rng`` may be a
    pipeline stage's ``MicrobatchDraws`` (``parallel/pipeline.py``): the
    numbers drawn for this call beforehand."""
    if not training or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs the step's "
                         "torch.Generator (rng=...); call .eval() for the "
                         "deterministic forward")
    if isinstance(rng, MicrobatchDraws):
        u = rng.take(x.shape)
    elif split is None or split.size == 1:
        u = batch_rand(x.shape, rng, x.device)
    else:
        n = x.shape[-1]
        u = batch_rand(x.shape[:-1] + (n * split.size,), rng,
                       x.device).narrow(-1, split.index * n, n)
    keep = u >= rate
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


Padding = Union[str, Sequence[Tuple[int, int]]]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax's ``"SAME"`` pair for one axis: ``ceil(size / stride)`` outputs,
    the odd pad unit at the end (a stride-2 k=3 conv over an even side
    pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """N-d convolution (N = 1, 2, 3) of a channels-first tensor
    [B, C, *spatial] in ``dtype``, with flax's padding: ``"VALID"``,
    ``"SAME"`` or one (low, high) pair per spatial axis. ``weight`` is
    [out, in, *kernel] (flax's [*kernel, in, out] permuted); ``bias`` is
    optional."""

    def __init__(self, in_dim: int, out_dim: int, kernel: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 padding: Padding = "VALID", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.kernel = tuple(kernel)
        self.strides = tuple(strides) if strides else (1,) * len(kernel)
        self.padding, self.dtype = padding, dtype
        self.weight = empty_param((out_dim, in_dim) + self.kernel, dev)
        self.bias = empty_param(out_dim, dev) if use_bias else None
        self.conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[len(kernel)]

    def _pairs(self, spatial: Sequence[int]) -> Sequence[Tuple[int, int]]:
        if self.padding == "VALID":
            return [(0, 0)] * len(spatial)
        if self.padding == "SAME":
            return [same_padding(n, k, s) for n, k, s in
                    zip(spatial, self.kernel, self.strides)]
        return self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pairs = self._pairs(x.shape[2:])
        if all(lo == hi for lo, hi in pairs):
            pad = tuple(lo for lo, _ in pairs)
        else:
            # F.pad takes the last axis first
            x = F.pad(x, [p for pair in reversed(pairs) for p in pair])
            pad = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return self.conv(x, self.weight.to(self.dtype), b, self.strides,
                         pad)


_QKV_BIAS_MODES = {"full": (1.0, 1.0, 1.0), "qv": (1.0, 0.0, 1.0),
                   "none": (0.0, 0.0, 0.0)}


class MultiHeadAttention(nn.Module):
    """Self-attention with one fused QKV projection ``[hidden] → [3, H, D]``.

    ``qkv_bias`` is a [3, H, D] parameter masked by the spec's mode:
    ``"qv"`` is VideoMAE's learned q/v bias with a frozen zero k bias,
    ``"none"`` has no parameter at all. q, k and v go to attention as
    strided views of the projection's output, with no copy.

    With the spec's ``seq_mesh`` and ``seq_axis`` (an axis of more than one
    rank) the core is ring attention: the sequence is padded to a multiple
    of the axis size (padded keys get a -1e30 bias, padded query rows are
    cut off after), each rank takes its block of q, k and v
    (``parallel/mesh.py::seq_shard``, whose backward gathers the blocks'
    gradients, so the qkv projection's weight gradient sees the whole
    sequence), and the blocks' outputs are gathered whole again
    (``seq_gather``, whose backward keeps this rank's slice). Only
    per-key biases [B, 1, 1, S] are taken. Every rank of the axis ends
    the backward with the single-rank gradients. ``seq_parallel = False``
    runs the core whole on this rank (a serving export from one rank).

    Cut over an ``mp`` axis (``parallel/sharding_rules.py``), the block
    runs this rank's heads: "copy to mp" on x, the local qkv (three row
    blocks of the local heads) and its bias, the core on the local heads
    (the models' key-mask biases [B, 1, 1, S] broadcast over them), the
    attention dropout's block of the whole mask, the local ``out`` without its bias, "reduce
    from mp", then ``out.bias``. Where the rule leaves qkv whole (heads
    that mp does not divide) and cuts ``out`` only, each rank feeds
    ``out`` its columns of the whole core's output."""

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
        self.seq_mesh, self.seq_axis = s.seq_mesh, s.seq_axis
        self.seq_parallel = (s.seq_mesh is not None and s.seq_axis is not None
                             and s.seq_mesh.shape[s.seq_axis] > 1)

    def _ring_core(self, q, k, v, bias):
        from mme_tpu_torch.ops.ring_attention import ring_attention
        from mme_tpu_torch.parallel.mesh import seq_gather, seq_shard

        B, S = q.shape[0], q.shape[1]
        key_bias = None
        if bias is not None:
            if not (bias.dim() == 4 and bias.shape[1] == 1
                    and bias.shape[2] == 1):
                raise ValueError("ring attention takes per-key biases "
                                 f"[B, 1, 1, S] only; got {tuple(bias.shape)}")
            key_bias = bias[:, 0, 0, :].float()
        ax = self.seq_mesh.axis(self.seq_axis)
        pad = (-S) % ax.size
        if pad:
            if key_bias is None:
                key_bias = torch.zeros((B, S), dtype=torch.float32,
                                       device=q.device)
            key_bias = F.pad(key_bias, (0, pad), value=-1e30)
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        q, k, v = (seq_shard(t, ax) for t in (q, k, v))
        if key_bias is not None:
            key_bias = seq_shard(key_bias, ax)
        out = ring_attention(q, k, v, self.seq_mesh, self.seq_axis,
                             key_bias=key_bias)
        return seq_gather(out, ax)[:, :S]

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, _ = x.shape
        dt = self.qkv.dtype
        tp = shard_of(self.qkv.weight)
        row = shard_of(self.out.weight)
        if tp is not None:
            x = copy_to_axis(x, tp.axis)
        b = None
        if self.qkv_bias is not None:
            b = (self.qkv_bias.to(dt) * self.qkv_bias_mask.to(dt)).reshape(-1)
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt), b)
        heads = qkv.shape[-1] // (3 * self.head_dim)
        qkv = qkv.view(B, S, 3, heads, self.head_dim)
        if self.seq_parallel:
            out = self._ring_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                  bias)
        else:
            out = dot_product_attention_shd(qkv[:, :, 0], qkv[:, :, 1],
                                            qkv[:, :, 2], bias)
        # on the attention output, not on the probabilities (as in JAX)
        out = dropout(out.reshape(B, S, heads * self.head_dim),
                      self.attention_dropout, self.training, rng,
                      split=None if tp is None else tp.axis)
        if row is None:
            return self.out(out)
        if tp is None:
            # whole heads, row-parallel out: this rank's columns
            n = out.shape[-1] // row.axis.size
            out = copy_to_axis(out, row.axis).narrow(-1, row.axis.index * n,
                                                     n)
        y = reduce_from_axis(F.linear(out.to(dt), self.out.weight.to(dt)),
                             row.axis)
        return y + self.out.bias.to(dt)


@contextlib.contextmanager
def single_rank(model: nn.Module) -> Iterator[None]:
    """Inside, every ``MultiHeadAttention`` of ``model`` runs its core
    whole on this rank and every ``TransformerEncoder`` its layers one
    after another (a serving export traced on one rank of an sp or pp
    mesh: ``torch.export`` cannot trace the ring's or the pipeline's
    messages); the weights and the function are the same."""
    flags = [(m, "seq_parallel") for m in model.modules()
             if isinstance(m, MultiHeadAttention)]
    flags += [(m, "pipelined") for m in model.modules()
              if isinstance(m, TransformerEncoder)]
    saved = [getattr(m, a) for m, a in flags]
    for m, a in flags:
        setattr(m, a, False)
    try:
        yield
    finally:
        for (m, a), v in zip(flags, saved):
            setattr(m, a, v)


class Mlp(nn.Module):
    """fc1 → activation → fc2 → output dropout. Where
    ``ops/fused_mlp.py::use_fused_mlp`` says so (``MME_FUSED_MLP``, default
    off) the three run as one kernel on the rows ``[B·S, H]``, weights cast
    to the compute dtype and biases in fp32; the dropout stays outside it
    and draws from the step's generator either way.

    Cut over an ``mp`` axis: "copy to mp", the local fc1 slice (and its
    bias), the activation, the local fc2 slice without its bias, "reduce
    from mp", then ``fc2.bias``. The fused kernel adds b2 inside, so it is
    given zeros there (its gradient is dropped) and b2 joins after the
    sum on every rank: each rank's replica of b2 then gets the whole
    gradient."""

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
        tp = shard_of(self.fc1.weight)
        if tp is not None:
            x = copy_to_axis(x, tp.axis)
        if use_fused_mlp(x, hidden, inter, dt):
            b2 = (self.fc2.bias.float() if tp is None else
                  torch.zeros(hidden, dtype=torch.float32, device=x.device))
            out = fused_mlp(
                x.reshape(-1, hidden).to(dt), self.fc1.weight.to(dt),
                self.fc1.bias.float(), self.fc2.weight.to(dt), b2,
                self.act_name).reshape(x.shape)
        elif tp is None:
            out = self.fc2(self.act(self.fc1(x)))
        else:
            out = F.linear(self.act(self.fc1(x)), self.fc2.weight.to(dt))
        if tp is not None:
            out = reduce_from_axis(out, tp.axis) + self.fc2.bias.to(out.dtype)
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

    def dropout_shapes(self, shape: Tuple[int, ...]
                       ) -> List[Tuple[int, ...]]:
        """The shapes of the uniform draws :meth:`forward` makes in
        training mode on an input of ``shape``, in its order: the
        attention output's, the attention branch's, the MLP output's (each
        where its rate is above 0)."""
        rates = (self.attention.attention_dropout, self.dropout,
                 self.mlp.dropout)
        return [shape for r in rates if r > 0.0]

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
    being recorded.

    With the spec's ``pp_mesh`` and ``pp_axis`` (an axis of P > 1 ranks)
    the stack runs as a pipeline over that axis
    (``parallel/pipeline.py::pipeline_encoder_apply``): this rank applies
    its stage's L / P blocks to ``pp_micro`` microbatches, and
    ``final_ln`` runs after the pipeline on every rank, as in JAX. Every
    rank holds every block; the blocks' parameters are tagged as stage
    leaves (``sharding_rules.mark_stage``), so the step sums their
    gradients over the axis. ``pipelined = False`` runs the stack on this
    rank alone (a serving export, :func:`single_rank`)."""

    def __init__(self, spec: EncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        self.n_layers = spec.layers
        self.remat = spec.remat
        for i in range(spec.layers):
            self.add_module(f"layer_{i}", EncoderBlock(spec, device=device))
        self.final_ln = (FusedLayerNorm(spec.hidden, spec.ln_eps, spec.dtype,
                                        device=device)
                         if spec.final_ln else None)
        self.has_dropout = spec.dropout > 0.0 or spec.attention_dropout > 0.0
        self.pp, self.pp_micro = None, spec.pp_micro
        if (spec.pp_mesh is not None and spec.pp_axis is not None
                and spec.pp_mesh.shape[spec.pp_axis] > 1):
            from mme_tpu_torch.parallel.pipeline import check_stages
            from mme_tpu_torch.parallel.sharding_rules import mark_stage
            self.pp = spec.pp_mesh.axis(spec.pp_axis)
            check_stages(spec.layers, self.pp.size)
            mark_stage([p for i in range(spec.layers)
                        for p in getattr(self, f"layer_{i}").parameters()],
                       self.pp)
        self.pipelined = self.pp is not None

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pipelined:
            from mme_tpu_torch.parallel.pipeline import pipeline_encoder_apply
            return pipeline_encoder_apply(self, x, bias, rng)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            x = (remat_call(block, rng, x, bias) if remat
                 else block(x, bias, rng))
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x
