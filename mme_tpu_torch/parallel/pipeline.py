"""Pipeline parallelism: GPipe microbatches streamed through the stages of
a layer stack, one stage per rank of a ``pp`` axis.

Port of ``mme_tpu/parallel/pipeline.py``. JAX runs the schedule as one
``shard_map`` over ``pp`` with a ``lax.scan`` of M + P − 1 ticks: at every
tick each stage applies its k = L / P layers and a ring ``ppermute`` moves
the results on; stage 0 takes the next microbatch off the queue and the
last stage stores microbatch t − (P − 1). The port's ranks run the same
schedule as explicit messages (``parallel/mesh.py::AxisGroup.send_start``
/ ``recv_start``): stage s takes microbatch m at JAX's tick s + m, from the
queue (stage 0) or from stage s − 1, applies its layers, casts the result
to the input's dtype and sends it to stage s + 1; the last stage keeps it.
Only the real (stage, microbatch) pairs run (JAX's bubble ticks compute on
data that is thrown away), so a stage launches its layers' kernels k·M
times a call. The last stage's outputs are then broadcast to every rank of
the axis, as JAX ``all_gather``s them and takes the last stage's. The
attention bias is the whole batch's on every rank, so each stage slices
its microbatch's rows where JAX's bias travels with the microbatch.

Gradients. The schedule is one ``torch.autograd.Function`` whose inputs
are the stack's input and this stage's parameters (the step takes
``torch.autograd.grad`` of the loss with respect to the parameters, so they
must be inputs to get gradients). Its forward keeps each microbatch's
local graph; its backward runs the reverse schedule, microbatches in
reverse order: receive dY from stage s + 1 (the last stage takes the
output's gradient, and only its own copy: every rank of the axis
back-propagates the same replicated loss, so summing the ranks' copies
would count it P times), ``torch.autograd.grad`` through the local graph to
the stage input and parameters, send dX to stage s − 1. Stage 0's dX is
broadcast to every rank of the axis, so the layers before the stack get
the same gradient on each. A rank has gradients for its own stage's
parameters only (zeros for the rest): ``sharding_rules.sync_grads`` sums
the stage leaves over ``pp`` (``sharding_rules.mark_stage``).

Random numbers. With dropout in training mode every rank draws every
layer's dropout numbers for the whole batch from the step's generator, in
the order the sequential stack draws them
(``models/layers.py::EncoderBlock.dropout_shapes``, through
``mesh.batch_rand``: under dp each rank keeps its rows of the global
batch's numbers), keeps its own layers' and hands each microbatch its rows
(:class:`MicrobatchDraws`, which ``layers.dropout`` reads in place of a
generator). So every (stage, microbatch) pair has masks of its own, the
masks are the ones a single rank running the stack draws, and the step's
generator ends where the sequential stack leaves it, on every rank of the
axis: the dropout after the stack draws the same numbers on each. JAX
folds (stage, microbatch[, dp index]) into its key instead, which draws
other masks of the same law.

The stage-tree helpers (:func:`stack_encoder_params`,
:func:`unstack_to_encoder_params`, :func:`stage_params`) work on flax-
layout trees of numpy leaves, so tests compare the port's stages with
JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mme_tpu_torch.parallel.mesh import AxisGroup, batch_rand

StageFn = Callable[[torch.Tensor, Optional[torch.Tensor], Any],
                   torch.Tensor]


# ------------------------- the stage trees (numpy) -------------------------

def _map(fn: Callable, *trees: Any) -> Any:
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_encoder_params(encoder_params: Dict[str, Any], n_layers: int
                         ) -> Any:
    """``{"layer_0": t0, …}`` → one tree of ``t0``'s structure whose leaves
    have a leading layer dimension (JAX's ``to_scan_params`` block)."""
    return _map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                *(encoder_params[f"layer_{i}"] for i in range(n_layers)))


def unstack_to_encoder_params(stacked: Any, n_layers: int
                              ) -> Dict[str, Any]:
    """Inverse of :func:`stack_encoder_params`."""
    return {f"layer_{i}": _map(lambda x, i=i: x[i], stacked)
            for i in range(n_layers)}


def stage_params(encoder_params: Dict[str, Any], n_layers: int,
                 n_stages: int) -> Any:
    """The stacked layers as ``[P, k, …]`` stages (JAX's ``staged`` in
    ``pipeline_encoder_apply``): stage s holds layers s·k … s·k + k − 1."""
    check_stages(n_layers, n_stages)
    k = n_layers // n_stages
    return _map(lambda x: x.reshape((n_stages, k) + x.shape[1:]),
                stack_encoder_params(encoder_params, n_layers))


def check_stages(n_layers: int, n_stages: int) -> None:
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} "
                         "stages")


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layer indices stage ``stage`` of ``n_stages`` applies."""
    check_stages(n_layers, n_stages)
    k = n_layers // n_stages
    return range(stage * k, stage * k + k)


# ------------------------------ the schedule ------------------------------

class MicrobatchDraws:
    """A microbatch's dropout numbers for its stage's layers, drawn
    beforehand in the order the layers' dropouts take them; passed where
    the blocks take the step's generator."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._next = iter(tensors)

    def take(self, shape: Sequence[int]) -> torch.Tensor:
        u = next(self._next, None)
        if u is None or tuple(u.shape) != tuple(shape):
            raise RuntimeError(f"a stage's dropout asked for {tuple(shape)}; "
                               "the draws made for it do not match")
        return u


def stage_draws(blocks: Sequence[Any], own: Sequence[int],
                shape: Sequence[int], rng: torch.Generator,
                device: torch.device, n_micro: int
                ) -> List[MicrobatchDraws]:
    """Every block's dropout numbers for a batch of ``shape``, drawn from
    ``rng`` in the sequential stack's order; the ``own`` blocks' kept,
    split into ``n_micro`` microbatches' rows."""
    kept: List[torch.Tensor] = []
    for i, block in enumerate(blocks):
        for s in block.dropout_shapes(tuple(shape)):
            u = batch_rand(s, rng, device)
            if i in own:
                kept.append(u)
    parts = [u.chunk(n_micro, dim=0) for u in kept]
    return [MicrobatchDraws([p[m] for p in parts]) for m in range(n_micro)]


class _Schedule:
    """One call's schedule on this rank: its stage function, the axis,
    the microbatches' biases and ``rng`` arguments."""

    def __init__(self, stage_fn: StageFn, axis: AxisGroup, n_micro: int,
                 bias: Optional[torch.Tensor],
                 rngs: Optional[Sequence[Any]]):
        self.stage_fn, self.axis, self.n_micro = stage_fn, axis, n_micro
        self.biases = (None if bias is None
                       else bias.detach().chunk(n_micro, dim=0))
        self.rngs = rngs

    def _stage(self, h: torch.Tensor, m: int) -> torch.Tensor:
        return self.stage_fn(
            h, None if self.biases is None else self.biases[m],
            None if self.rngs is None else self.rngs[m])

    def forward(self, x: torch.Tensor, keep: bool):
        """The forward schedule; the output on every rank, and with
        ``keep`` each microbatch's (stage input, stage output)."""
        axis, s, P = self.axis, self.axis.index, self.axis.size
        micro = x.chunk(self.n_micro, dim=0)
        outs, records, sends = [], [], []
        for m in range(self.n_micro):
            h = (micro[m] if s == 0
                 else axis.recv_start(micro[m], s - 1).wait())
            if keep:
                h = h.detach().requires_grad_()
                with torch.enable_grad():
                    y = self._stage(h, m).to(x.dtype)
                records.append((h, y))
            else:
                y = self._stage(h, m).to(x.dtype)
            if s < P - 1:
                sends.append(axis.send_start(y.detach(), s + 1))
            else:
                outs.append(y.detach())
        for t in sends:
            t.wait()
        out = (torch.cat(outs) if s == P - 1
               else torch.empty_like(x, memory_format=torch.contiguous_format))
        axis.broadcast_(out, P - 1)
        return out, records

    def backward(self, records, dy: torch.Tensor,
                 params: Sequence[torch.Tensor], need_dx: bool):
        """The reverse schedule: dX (stage 0's, on every rank; None
        without ``need_dx``) and this stage's parameter gradients summed
        over the microbatches."""
        axis, s, P = self.axis, self.axis.index, self.axis.size
        dys = dy.chunk(self.n_micro, dim=0)
        wanted = [p for p in params if p.requires_grad]
        dparams: List[Optional[torch.Tensor]] = [None] * len(wanted)
        dxs: List[Optional[torch.Tensor]] = [None] * self.n_micro
        sends = []
        for m in reversed(range(self.n_micro)):
            h, y = records[m]
            g = (dys[m] if s == P - 1
                 else axis.recv_start(y, s + 1).wait())
            got = torch.autograd.grad(y, [h] + wanted, g.to(y.dtype),
                                      allow_unused=True)
            records[m] = None            # the local graph goes
            for i, d in enumerate(got[1:]):
                if d is not None:
                    dparams[i] = d if dparams[i] is None else dparams[i] + d
            dx = got[0] if got[0] is not None else torch.zeros_like(h)
            if s > 0:
                sends.append(axis.send_start(dx.detach(), s - 1))
            else:
                dxs[m] = dx
        for t in sends:
            t.wait()
        dx = None
        if need_dx:
            dx = (torch.cat(dxs) if s == 0
                  else torch.empty(dy.shape, dtype=dy.dtype,
                                   device=dy.device))
            axis.broadcast_(dx, 0)
        by_param = dict(zip(map(id, wanted), dparams))
        return dx, [by_param.get(id(p)) for p in params]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule: _Schedule, x: torch.Tensor, *params):
        out, records = schedule.forward(x, keep=True)
        ctx.schedule, ctx.records, ctx.params = schedule, records, params
        return out

    @staticmethod
    def backward(ctx, dy):
        dx, dparams = ctx.schedule.backward(
            ctx.records, dy, ctx.params, ctx.needs_input_grad[1])
        ctx.records = ctx.params = None
        return (None, dx, *dparams)


def pipeline_apply(stage_fn: StageFn, params: Sequence[torch.Tensor],
                   x: torch.Tensor, axis: AxisGroup, n_micro: int,
                   bias: Optional[torch.Tensor] = None,
                   rngs: Optional[Sequence[Any]] = None
                   ) -> torch.Tensor:
    """Run this rank's stage of a P-stage pipeline over ``axis``.

    ``stage_fn(h, bias, rng) -> y``: this stage's compute on one
    microbatch (``y`` of ``h``'s shape); ``params``: the tensors it reads
    that take gradients. ``x``: [B, …], the same on every rank of the axis
    (stage 0 reads it), split into ``n_micro`` microbatches along dim 0;
    ``bias``: [B, …] or None, sliced the same way; ``rngs``: what
    ``stage_fn`` takes as ``rng`` for each microbatch, or None. Returns
    [B, …] on every rank: the P stages applied to each microbatch in
    turn."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} vs {n_micro} micro")
    if bias is not None and bias.shape[0] != x.shape[0]:
        raise ValueError(f"a bias of {bias.shape[0]} rows for a batch of "
                         f"{x.shape[0]}: the pipeline splits both")
    schedule = _Schedule(stage_fn, axis, n_micro, bias, rngs)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(schedule, x, *params)
    return schedule.forward(x, keep=False)[0]


def pipeline_encoder_apply(encoder, x: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """A ``models/layers.py::TransformerEncoder`` built with a ``pp`` axis
    of P ranks, as a pipeline of ``pp_micro`` microbatches: this rank's
    stage applies its k = L / P blocks (``layer_{s·k}`` …) with the spec's
    remat off, as JAX's stage clears it, then ``final_ln`` runs on the
    broadcast output on every rank. In training mode with dropout the
    stages take the masks :func:`stage_draws` drew from ``rng``."""
    axis, n_micro = encoder.pp, encoder.pp_micro
    every = [getattr(encoder, f"layer_{i}") for i in range(encoder.n_layers)]
    own = stage_layers(encoder.n_layers, axis.size, axis.index)
    blocks = [every[i] for i in own]
    draws = None
    if encoder.training and encoder.has_dropout:
        if rng is None:
            raise ValueError("dropout through the pipeline needs the "
                             "step's torch.Generator (rng=...); call "
                             ".eval() for the deterministic forward")
        draws = stage_draws(every, own, x.shape, rng, x.device, n_micro)

    def stage(h, b, g):
        for block in blocks:
            h = block(h, b, g)
        return h

    params = [p for block in blocks for p in block.parameters()]
    out = pipeline_apply(stage, params, x, axis, n_micro, bias, draws)
    if encoder.final_ln is not None:
        out = encoder.final_ln(out)
    return out
