"""Tensor- and expert-parallel parameter sharding: which leaves each rank
holds a block of, and the bookkeeping that block needs.

Port of ``mme_tpu/parallel/sharding_rules.py``. JAX maps each flax path to
a ``PartitionSpec`` over the ``("dp", "mp")`` mesh and XLA inserts the
collectives; here :func:`tp_spec_for_path` is JAX's rule, applied to each
parameter's flax path and flax shape (``convert.py``'s name map), so the
same leaves shard in both packages, and a leaf whose split dimension ``mp``
does not divide stays replicated, as in JAX. Megatron's column → row
pattern per transformer block:

- the fused qkv kernel (heads; the port's ``[3·H·D, hidden]`` weight is
  three row blocks q, k, v, each cut by heads) and ``qkv_bias`` [3, H, D]
  are column-parallel, ``attention/out`` row-parallel;
- ``mlp/fc1`` (kernel and bias) is column-parallel on the intermediate,
  ``mlp/fc2`` row-parallel;
- everything else is replicated: embeddings, LayerNorms, the row-parallel
  layers' biases (added after the reduction), BatchNorm statistics.

:func:`shard_model` cuts each such parameter down to this rank's block in
place (``p.data`` becomes the block) and tags it with a :class:`Shard`;
``models/layers.py`` reads the tags and runs the local heads and the local
F slice between ``parallel/mesh.py::copy_to_axis`` and
``reduce_from_axis``. The same function splits the expert stacks of every
``MoEMlp`` built with an ``ep_axis`` on a mesh that has it (expert
parallelism, dim 0 over that axis). Optimizer moments are created from
the cut parameters, so they share the layout; checkpoints gather the
blocks and restores cut them again (``train/checkpoint.py``),
:func:`whole_model` puts the whole tensors back for an export, and
:func:`sync_grads` / :func:`shard_sum` give the step and the optimizer
the gradient mean and the norms of the unsharded model. Pipeline stages
cut nothing: every rank holds every layer, and :func:`mark_stage` tags a
pipelined stack's leaves so that :func:`sync_grads` sums their gradients,
which only the owning stage's rank computes, over the ``pp`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.parallel.mesh import AxisGroup, Mesh

_TAG = "mme_shard"
_STAGE_TAG = "mme_stage"


def tp_spec_for_path(name: str, ndim: int, mp_axis: str = "mp"
                     ) -> Tuple[Optional[str], ...]:
    """JAX's rule: the partition spec of the flax leaf ``name``
    (``"a/b/kernel"``) of rank ``ndim``; ``()`` replicates."""
    if name.endswith("qkv/kernel") and ndim == 4:
        return (None, None, mp_axis, None)           # heads column-parallel
    if name.endswith("qkv_bias") and ndim == 3:
        return (None, mp_axis, None)
    if name.endswith("attention/out/kernel") and ndim == 2:
        return (mp_axis, None)                       # row-parallel
    if name.endswith("mlp/fc1/kernel") and ndim == 2:
        return (None, mp_axis)                       # column-parallel
    if name.endswith("mlp/fc1/bias") and ndim == 1:
        return (mp_axis,)
    if name.endswith("mlp/fc2/kernel") and ndim == 2:
        return (mp_axis, None)                       # row-parallel
    return ()


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter cut along ``dim`` over ``axis``: coordinate i holds the
    i-th of ``axis.size`` equal parts. ``blocks`` > 1: ``dim`` holds that
    many equal row blocks (the qkv weight's q, k and v), and each block is
    cut."""

    axis: AxisGroup
    dim: int
    blocks: int = 1

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor (a view)."""
        v = full.unflatten(self.dim, (self.blocks, -1))
        n = v.shape[self.dim + 1] // self.axis.size
        return v.narrow(self.dim + 1, self.axis.index * n, n).flatten(
            self.dim, self.dim + 1)

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's part (a collective over
        ``axis``: every rank of it calls)."""
        v = local.unflatten(self.dim, (self.blocks, -1)).contiguous()
        return self.axis.all_gather(v, self.dim + 1).flatten(
            self.dim, self.dim + 1)


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    """The :class:`Shard` of a parameter :func:`shard_model` cut, else
    None."""
    return getattr(t, _TAG, None)


def mark_stage(params: Sequence[nn.Parameter], axis: AxisGroup) -> None:
    """Tag ``params`` as pipeline-stage leaves of ``axis`` (the layers of a
    ``TransformerEncoder`` run as a pipeline over it): every rank holds
    them whole, and only the rank of the owning stage computes their
    gradients."""
    for p in params:
        setattr(p, _STAGE_TAG, axis)


def stage_of(t: torch.Tensor) -> Optional[AxisGroup]:
    """The pipeline axis of a stage leaf :func:`mark_stage` tagged, else
    None."""
    return getattr(t, _STAGE_TAG, None)


def _cut(p: nn.Parameter, shard: Shard) -> None:
    with torch.no_grad():
        p.data = shard.local(p.data).clone()
    setattr(p, _TAG, shard)


def tp_plan(model: nn.Module, mp: int, mp_axis: str = "mp"
            ) -> Dict[str, Tuple[int, int]]:
    """The port parameters JAX's rule shards over ``mp`` ranks, by
    parameter name: ``(dim, blocks)`` in the port's layout. A leaf the
    rule names whose flax dimension ``mp`` does not divide is left out
    (replicated)."""
    from mme_tpu_torch.convert import _flax_shape, _leaves
    from mme_tpu_torch.models.layers import Mlp, MultiHeadAttention

    names = {id(p): n for n, p in model.named_parameters()}
    mods = dict(model.named_modules())
    plan: Dict[str, Tuple[int, int]] = {}
    for path, p, kind, heads in _leaves(model):
        flax = _flax_shape(tuple(p.shape), kind, heads)
        spec = tp_spec_for_path("/".join(path), len(flax), mp_axis)
        if mp_axis not in spec:
            continue
        fdim = spec.index(mp_axis)
        if flax[fdim] % mp:
            continue
        owner = ".".join(path[:-1])
        parent = owner.rpartition(".")[0]
        if not (isinstance(mods.get(owner), MultiHeadAttention)
                or isinstance(mods.get(parent), (MultiHeadAttention, Mlp))):
            raise ValueError(f"{'/'.join(path)}: the tp rule shards it, but "
                             "it is not an attention or MLP leaf")
        if kind == "qkv":
            plan[names[id(p)]] = (0, 3)     # [3·H·D, hidden]: heads per block
        elif kind == "dense":
            plan[names[id(p)]] = (1 - fdim, 1)   # [out, in] of [in, out]
        else:
            plan[names[id(p)]] = (fdim, 1)
    return plan


def shard_model(model: nn.Module, mesh: Optional[Mesh],
                mp_axis: str = "mp") -> nn.Module:
    """Cut ``model``'s parameters to this rank's blocks, in place: JAX's
    tensor-parallel rule over ``mesh``'s ``mp_axis`` (nothing when the mesh
    has no such axis or it holds one rank: tp is off), and the expert
    stacks of every ``MoEMlp`` with an expert axis. Call it once, on the
    whole (replicated) weights, before the optimizer state is created."""
    from mme_tpu_torch.models.moe import MoEMlp

    if mesh is not None and mesh.shape.get(mp_axis, 1) > 1:
        axis = mesh.axis(mp_axis)
        plan = tp_plan(model, axis.size, mp_axis)
        for name, p in model.named_parameters():
            if name in plan:
                _cut(p, Shard(axis, *plan[name]))
        n = sum(1 for _ in model.parameters())
        print(f"tp: {len(plan)} of {n} leaves sharded over "
              f"{mp_axis}={axis.size}", flush=True)
    for m in model.modules():
        if isinstance(m, MoEMlp) and m.ep is not None:
            for p in (m.w1, m.b1, m.w2, m.b2):
                if shard_of(p) is None:
                    _cut(p, Shard(m.ep, 0))
    return model


@contextlib.contextmanager
def whole_model(model: nn.Module) -> Iterator[None]:
    """Inside, every cut parameter of ``model`` holds the whole tensor and
    no tag, so the model runs as one rank's (a serving export); after, the
    blocks and tags are back. Entering gathers: every rank of each axis
    enters."""
    cut = [(p, shard_of(p)) for p in model.parameters()
           if shard_of(p) is not None]
    saved = []
    with torch.no_grad():
        for p, s in cut:
            saved.append(p.data)
            p.data = s.full(p.data)
            delattr(p, _TAG)
    try:
        yield
    finally:
        for (p, s), d in zip(cut, saved):
            p.data = d
            setattr(p, _TAG, s)


def full_tensor(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``t`` whole: gathered over its shard's axis, or itself."""
    return t if shard is None else shard.full(t)


def shard_sum(values: Sequence[torch.Tensor],
              shards: Sequence[Optional[Shard]]) -> torch.Tensor:
    """Σ ``values`` (one per leaf, all of one shape: squared norms,
    histograms) as the unsharded model gives it: a cut leaf's value is its
    block's, summed over its axis; a replicated leaf counts once."""
    total = None
    by_axis: Dict[int, Tuple[AxisGroup, List[torch.Tensor]]] = {}
    for v, s in zip(values, shards):
        if s is None:
            total = v if total is None else total + v
        else:
            by_axis.setdefault(id(s.axis), (s.axis, []))[1].append(v)
    for axis, vs in by_axis.values():
        part = axis.all_reduce(torch.stack(vs).sum(0))
        total = part if total is None else total + part
    return total


def _replica_group(mesh: Mesh, names: Sequence[str]) -> Optional[AxisGroup]:
    names = [n for n in names if mesh.shape[n] > 1]
    if not names:
        return None
    if len(names) == 1:
        return mesh.axis(names[0])
    if set(names) == {n for n in mesh.axis_names if mesh.shape[n] > 1}:
        return mesh.world
    raise NotImplementedError(f"a gradient mean over {names} of "
                              f"{mesh.shape}")


def sync_grads(grads: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], mesh: Mesh,
               mp_axis: str = "mp") -> List[torch.Tensor]:
    """The step's gradient mean. Every rank back-propagates the same
    replicated loss: the ranks along a batch axis hold partial gradients
    that sum to that axis' size times the global one, the ranks along an
    sp axis equal ones, and the ranks along ``mp`` different blocks (or,
    for a replicated leaf, equal whole gradients). So a leaf is
    all-reduced over every axis but ``mp`` and divided by their ranks. An
    expert stack cut over such an axis holds the sum over that axis'
    rows already and is all-reduced over the others only; one cut over an
    axis whose ranks hold the same rows got each contribution that many
    times and is divided by it too. A pipeline-stage leaf
    (:func:`stage_of`) has its gradient on the rank of its stage and
    zeros on the other ranks of the ``pp`` axis: it is summed over that
    axis, not averaged (divided by the other axes' ranks only); a leaf
    outside the pipeline has equal gradients on the ``pp`` ranks and is
    averaged like any replicated leaf."""
    rep = [n for n in mesh.axis_names if n != mp_axis]
    base = int(np.prod([mesh.shape[n] for n in rep]))
    out = list(grads)
    groups: Dict[Tuple[Tuple[str, ...], int], List[int]] = {}
    for i, p in enumerate(params):
        s = shard_of(p)
        names, div = rep, base
        if s is not None and s.axis.name != mp_axis:
            if s.axis.name in rep:
                names = [n for n in rep if n != s.axis.name]
            else:
                div *= s.axis.size
        stage = stage_of(p)
        if stage is not None and stage.name in names:
            div //= stage.size
        groups.setdefault((tuple(names), div), []).append(i)
    for (names, div), idx in groups.items():
        axis = _replica_group(mesh, names)
        summed = (axis.all_reduce_many([grads[i] for i in idx])
                  if axis is not None else [grads[i] for i in idx])
        for i, g in zip(idx, summed):
            out[i] = g / div if g is grads[i] else g.div_(div)
    return out
