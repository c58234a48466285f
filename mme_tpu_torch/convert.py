"""Weights between the flax parameter tree of ``mme_tpu`` and the port.

The port's module tree mirrors the flax tree name for name, so a flax leaf
``a/b/kernel`` becomes the state-dict entry ``a.b.weight``. Layouts:

- ``Dense`` kernel [in, out] → ``weight`` [out, in];
- the fused attention ``qkv`` kernel [hidden, 3, H, D] → [3·H·D, hidden];
- ``Conv`` kernel [*k, in/groups, out] → [out, in/groups, *k] for 1-, 2-
  and 3-D convolutions (the grouped positional conv included). A rank-4
  kernel is the attention's when its module is named ``qkv`` and a 2-D
  conv's otherwise;
- LayerNorm, GroupNorm and BatchNorm ``scale`` → ``weight``; ``Embed``
  ``embedding`` → ``weight``;
- everything else (biases, ``qkv_bias`` [3, H, D], ``masked_spec_embed``,
  the MoE expert stacks ``w1`` [E, H, I], ``b1``, ``w2`` [E, I, H], ``b2``)
  keeps its name and shape.

A BatchNorm's ``batch_stats`` (``mean``, ``var``) are the module's buffers
of the same names.

:func:`from_flax` reads the flax trees as nested dicts of numpy arrays;
:func:`to_flax` goes back from a port model, with its parameters or with any
tensors aligned with them (gradients: :func:`grads_to_flax`), and
:func:`stats_to_flax` gives its running statistics, so a test can hold them
against JAX's leaf by leaf; :func:`factored_views` gives the factored
optimizer the flax layout's rows and columns of every leaf;
:func:`init_variables` draws a flax-layout ``params`` (and
``batch_stats``) tree of any port model with numpy at flax's default
initializer scales, for runs without JAX and without pretrained weights;
:func:`init_params` does it for a ``FUSION_MODELS`` entry, and
:func:`flax_shapes` gives the tree's shapes alone.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.models.audio import Conv1d
from mme_tpu_torch.models.fusion import FUSION_MODELS, TAVSpec
from mme_tpu_torch.models.layers import (Conv, Dense, Embed,
                                         MultiHeadAttention)
from mme_tpu_torch.models.moe import MoEMlp
from mme_tpu_torch.models.norm import BatchNorm, GroupNorm
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm
from mme_tpu_torch.train import optim

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to ±2


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _to_port(flax_perm: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(flax_perm))


def _conv_perm(rank: int) -> Tuple[int, ...]:
    """Port conv weight [out, in, *k] → flax kernel [*k, in, out]."""
    return tuple(range(2, rank)) + (1, 0)


def from_flax(params: Any, batch_stats: Any = None
              ) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``params`` tree (nested mappings of arrays), and a
    ``batch_stats`` tree for a model with BatchNorms, → the port's state
    dict (fp32 CPU tensors)."""
    state = OrderedDict()
    for path, a in _flatten(params):
        leaf = path[-1]
        a = a.astype(np.float32)
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and len(path) > 1 and path[-2] == "qkv":
                a = a.reshape(a.shape[0], -1).T
            elif a.ndim in (3, 4, 5):
                a = a.transpose(_to_port(_conv_perm(a.ndim)))
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {a.ndim}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        state[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.ascontiguousarray(a))
    for path, a in _flatten(batch_stats or {}):
        state[".".join(path)] = torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32)))
    return state


def _leaves(model: nn.Module):
    """(flax path, parameter, kind, heads) for every parameter of
    ``model``; kind is the flax leaf's layout."""
    attn = {name: m for name, m in model.named_modules()
            if isinstance(m, MultiHeadAttention)}
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            path = tuple(name.split(".")) if name else ()
            kind, leaf = "plain", pname
            if pname == "weight":
                if isinstance(mod, Dense):
                    parent = name.rpartition(".")[0]
                    kind = ("qkv" if name.endswith(".qkv") and parent in attn
                            else "dense")
                    leaf = "kernel"
                elif isinstance(mod, (Conv1d, Conv)):
                    kind, leaf = "conv", "kernel"
                elif isinstance(mod, Embed):
                    kind, leaf = "embed", "embedding"
                elif isinstance(mod, (FusedLayerNorm, GroupNorm, BatchNorm)):
                    kind, leaf = "ones", "scale"
            elif pname == "masked_spec_embed":
                kind = "uniform"
            elif isinstance(mod, MoEMlp) and pname in ("w1", "w2"):
                kind = "experts"
            heads = None
            if kind == "qkv":
                m = attn[name.rpartition(".")[0]]
                heads = (m.heads, m.head_dim)
            yield path + (leaf,), p, kind, heads


def _stats(model: nn.Module):
    """(flax path, buffer) of every BatchNorm's running statistics."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            for leaf in ("mean", "var"):
                yield tuple(name.split(".")) + (leaf,), getattr(mod, leaf)


def _flax_shape(shape, kind, heads):
    if kind == "dense":
        return (shape[1], shape[0])
    if kind == "conv":
        return tuple(shape[i] for i in _conv_perm(len(shape)))
    if kind == "qkv":
        return (shape[1], 3) + heads
    return tuple(shape)


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_flax(model: nn.Module,
            values: Optional[Sequence[torch.Tensor]] = None
            ) -> Dict[str, Any]:
    """The port model's weights as a flax-layout tree of numpy arrays; or,
    in the same layout, ``values``: one tensor per parameter, in the order
    of ``model.parameters()``."""
    if values is not None:
        by_param = {id(p): v for p, v in zip(model.parameters(), values)}
    tree: Dict[str, Any] = {}
    for path, p, kind, heads in _leaves(model):
        a = p if values is None else by_param[id(p)]
        a = a.detach().float().cpu().numpy()
        if kind == "dense":
            a = a.T
        elif kind == "conv":
            a = a.transpose(_conv_perm(a.ndim))
        elif kind == "qkv":
            a = a.T.reshape(_flax_shape(p.shape, kind, heads))
        _set(tree, path, np.ascontiguousarray(a))
    return tree


def stats_to_flax(model: nn.Module) -> Dict[str, Any]:
    """The model's BatchNorm running statistics as a flax ``batch_stats``
    tree of numpy arrays (empty for a model without BatchNorms)."""
    tree: Dict[str, Any] = {}
    for path, b in _stats(model):
        _set(tree, path, b.detach().float().cpu().numpy().copy())
    return tree


def grads_to_flax(model: nn.Module,
                  grads: Optional[Sequence[torch.Tensor]] = None
                  ) -> Dict[str, Any]:
    """Gradients in the flax layout: ``grads`` aligned with
    ``model.parameters()``, or each parameter's ``.grad``. A missing
    gradient (None: the forward did not reach the parameter) is zero, as
    JAX reports it."""
    params = list(model.parameters())
    if grads is None:
        grads = [p.grad for p in params]
    return to_flax(model, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)])


def factored_views(model: nn.Module, min_size: Optional[int] = None):
    """Per parameter of ``model``, the pair of functions between the port's
    layout and the [rows, cols] view whose row and column sums the factored
    optimizer keeps (``train/optim.py::adamw_factored``), or None for a leaf
    that keeps its full second moment. The view is the JAX package's: the
    leaf in its flax layout with the leading dims flattened and the last
    kept, for leaves of rank 2 or more and at least ``min_size`` elements
    (default: the optimizer's ``FACTOR_MIN_SIZE``)."""
    if min_size is None:
        min_size = optim.FACTOR_MIN_SIZE
    views = []
    for _, p, kind, heads in _leaves(model):
        shape = tuple(p.shape)
        flax = _flax_shape(shape, kind, heads)
        if len(flax) < 2 or p.numel() < min_size:
            views.append(None)
        elif kind == "dense":
            views.append((lambda t: t.t(), lambda v: v.t()))
        elif kind == "conv":
            perm = _conv_perm(len(shape))
            views.append((
                lambda t, p=perm, s=shape: t.permute(p).reshape(-1, s[0]),
                lambda v, p=perm, f=flax: v.reshape(f).permute(
                    _to_port(p))))
        elif kind == "qkv":
            d = heads[1]
            views.append((
                lambda t, d=d: t.t().reshape(-1, d),
                lambda v, s=shape: v.reshape(s[1], s[0]).t()))
        else:
            views.append((lambda t, s=shape: t.reshape(-1, s[-1]),
                          lambda v, s=shape: v.reshape(s)))
    return views


class ShapeDtype(NamedTuple):
    """A leaf with a shape and a dtype and no values."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def flax_shapes(model: nn.Module) -> Dict[str, Any]:
    """The flax-layout ``params`` tree of ``model`` (built on any device,
    ``meta`` included) with a :class:`ShapeDtype` leaf each, drawing
    nothing: what ``jax.eval_shape`` gives for a flax model's init, and
    what ``models/pretrained.py::merge_params`` takes as its target."""
    tree: Dict[str, Any] = {}
    for path, p, kind, heads in _leaves(model):
        _set(tree, path, ShapeDtype(_flax_shape(p.shape, kind, heads),
                                    np.dtype(np.float32)))
    return tree


def init_variables(model: nn.Module, seed: int = 0) -> Dict[str, Any]:
    """Flax-layout variables of ``model`` (built on any device, ``meta``
    included) drawn with numpy at flax's default scales: ``{"params": ...}``
    and, for a model with BatchNorms, ``"batch_stats"``. Kernels are
    lecun-normal (truncated at ±2σ, fan-in = the kernel's input size: for a
    conv the receptive field times the input channels; for the [E, H, I]
    expert stacks flax counts E as a receptive field, so E·H, and E·I for
    ``w2``), embeddings normal with std 1/√features, norm scales 1, biases
    0, ``masked_spec_embed`` uniform in [0, 1); running means 0 and
    variances 1."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for path, p, kind, heads in _leaves(model):
        shape = _flax_shape(p.shape, kind, heads)
        if kind in ("dense", "conv", "qkv", "experts"):
            fan_in = shape[0] if kind == "qkv" else int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape, dtype=np.float32)
            out = np.abs(a) > 2.0
            while out.any():
                a[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
                out = np.abs(a) > 2.0
            a *= np.float32(np.sqrt(1.0 / fan_in) / _TRUNC_STD)
        elif kind == "embed":
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(1.0 / np.sqrt(shape[-1]))
        elif kind == "ones":
            a = np.ones(shape, np.float32)
        elif kind == "uniform":
            a = rng.random(shape, dtype=np.float32)
        else:
            a = np.zeros(shape, np.float32)
        _set(tree, path, a)
    variables = {"params": tree}
    stats: Dict[str, Any] = {}
    for path, b in _stats(model):
        _set(stats, path, (np.zeros if path[-1] == "mean" else np.ones)(
            tuple(b.shape), np.float32))
    if stats:
        variables["batch_stats"] = stats
    return variables


def init_params(spec: TAVSpec, seed: int = 0,
                model: str = "TAVModel") -> Dict[str, Any]:
    """:func:`init_variables`' ``params`` of ``FUSION_MODELS[model]``
    (``TAVModel`` for the class name or an unknown name) at ``spec``."""
    cls = FUSION_MODELS.get(model, FUSION_MODELS["MAE_encoder"])
    return init_variables(cls(spec, device="meta"), seed)["params"]
