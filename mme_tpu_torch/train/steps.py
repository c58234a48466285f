"""The generic train and eval steps.

Port of ``mme_tpu/train/steps.py``: ``TrainState``, ``make_optimizer``,
``make_train_step`` and ``make_eval_step``. One step function serves every
loop variant: the epoch-parity loss switch arrives as a weight vector and
dialog-aligned accumulation as a per-step ``apply_update`` flag with a
``loss_scale``. ``grad_norm`` is the global scalar, or with
``log_module_norms`` / ``log_histograms`` the dictionary of per-module norms
and :func:`magnitude_histogram` summaries.

Where JAX's step is a pure function returning a new state, the port's
mutates: the parameters are the model's own ``nn.Parameter``s, updated in
place, and the step returns the state object it was given. PyTorch runs
eagerly, so there is nothing to jit and the accumulate/apply branch is a
Python ``if`` on a host boolean.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.evals.metrics import confusion_matrix
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.optim import (AdamWState, Optimizer, View, adamw,
                                       adamw_factored, adamw_lowmem,
                                       global_norm_f32)

Rng = Union[int, torch.Generator]


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's parameters themselves (the step updates
    them in place); ``accum_grads`` is None when accumulation is off.
    ``names``, one per parameter, key the parameters in a checkpoint
    (``train/checkpoint.py``); without them a parameter's index does."""

    step: int
    params: List[nn.Parameter]
    opt_state: AdamWState
    accum_grads: Optional[List[torch.Tensor]]
    accum_count: int = 0
    names: Optional[List[str]] = None

    @classmethod
    def create(cls, params: Sequence[nn.Parameter], tx: Optimizer,
               use_accum: bool = True,
               generator: Optional[torch.Generator] = None,
               names: Optional[Sequence[str]] = None) -> "TrainState":
        """``use_accum=False`` drops the gradient-accumulation buffer, a
        whole fp32 copy of the parameters; every step then applies."""
        params = list(params)
        zeros = ([torch.zeros_like(p) for p in params] if use_accum
                 else None)
        return cls(step=0, params=params,
                   opt_state=tx.init(params, generator), accum_grads=zeros,
                   names=None if names is None else list(names))


HIST_BUCKETS = 17  # bucket 0: exact zeros; 1..16: |x| exponent ranges


def magnitude_histogram(tensors: Union[torch.Tensor,
                                       Sequence[torch.Tensor]]
                        ) -> torch.Tensor:
    """17-bucket magnitude histogram (int32) over every element of a tensor
    or a list of tensors.

    Bucket 0 counts exact zeros; bucket ``i`` (1..16) counts elements with
    ``floor(log2 |x|)`` in ``[-40 + 3(i-1), -40 + 3i)`` (clipped at the
    ends), about 1e-12 to 3e2. Non-finite elements (NaN, ±Inf) count in the
    top bucket: an exploding tensor must not read as an underflowing one."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    x = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    finite = torch.isfinite(x)
    nz = x != 0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    e = torch.floor(torch.log2(torch.where(nz & finite, x.abs(), one)))
    idx = torch.where(
        nz, 1 + torch.clamp(torch.floor((e + 40) / 3), 0, 15).long(), 0)
    idx = torch.where(finite, idx, HIST_BUCKETS - 1)
    return torch.bincount(idx, minlength=HIST_BUCKETS).to(torch.int32)


def _module_groups(model: nn.Module, params: Sequence[nn.Parameter]
                   ) -> Dict[str, List[int]]:
    """Indices into ``params`` by top-level module name (the top-level keys
    of the flax parameter tree)."""
    index = {id(p): i for i, p in enumerate(params)}
    groups: Dict[str, List[int]] = {}
    for name, p in model.named_parameters():
        if id(p) in index:
            groups.setdefault(name.split(".")[0], []).append(index[id(p)])
    return groups


def make_optimizer(lr_schedule: Callable[[int], float], weight_decay: float,
                   clip: float,
                   trainable_mask: Optional[Sequence[bool]] = None,
                   state_dtype: Optional[str] = None,
                   factored_views: Optional[Sequence[Optional[View]]] = None
                   ) -> Optimizer:
    """clip-by-global-norm → AdamW (torch defaults: b1 .9, b2 .999, eps
    1e-8).

    ``trainable_mask``: one bool per parameter; False freezes the leaf for
    good (no update, not even weight decay). ``state_dtype``: "fp32"
    (default), "bf16" (moments stored in bf16 with stochastic rounding) or
    "factored" (bf16 first moment, row/column second moment; its
    ``factored_views`` are ``train/optim.py::adamw_factored``'s ``views``);
    ``None`` reads ``MME_OPT_STATE``."""
    if state_dtype is None:
        state_dtype = os.environ.get("MME_OPT_STATE", "fp32")
    if state_dtype == "bf16":
        return adamw_lowmem(lr_schedule, weight_decay, clip, trainable_mask)
    if state_dtype == "factored":
        return adamw_factored(lr_schedule, weight_decay, clip,
                              trainable_mask, factored_views)
    if state_dtype != "fp32":
        raise ValueError(f"unknown optimizer state dtype {state_dtype!r} "
                         "(fp32, bf16, factored)")
    return adamw(lr_schedule, weight_decay, clip, trainable_mask)


def _step_generator(rng: Rng, step: int,
                    device: torch.device) -> torch.Generator:
    """A generator is used as it is; a seed is folded with the step count
    into a fresh generator on the model's device, so the same seed gives
    each step its own masks (JAX folds its key with ``state.step``)."""
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=device)
    gen.manual_seed((int(rng) * 0x9E3779B97F4A7C15 + step) % (1 << 63))
    return gen


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Numpy arrays or tensors → tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(model: nn.Module, tx: Optimizer, num_classes: int,
                    loss_fn: Optional[Callable] = None,
                    grads_dtype: Optional[torch.dtype] = None,
                    log_module_norms: bool = False,
                    log_histograms: bool = False,
                    has_aux_loss: bool = False) -> Callable:
    """Build the train step around ``model(batch, rng) -> logits``, or
    ``-> (logits, aux_loss)`` with ``has_aux_loss`` (the MoE
    load-balancing term, added to the loss before it is scaled; the loss
    returned is that sum):

        state, loss, cm, grad_norm = step(
            state, batch, labels, sample_mask, class_weights, loss_scale,
            apply_update, rng)

    ``loss`` is the scaled loss, ``cm`` the batch's confusion matrix,
    ``grad_norm`` the global norm of this batch's (scaled, unclipped)
    gradients. ``rng`` is a ``torch.Generator`` on the model's device, or a
    seed. ``loss_fn(logits, labels, class_weights, sample_mask)`` defaults
    to cross entropy. ``grads_dtype=torch.bfloat16`` (or ``MME_GRADS=bf16``)
    stores the gradients in bf16 between the backward pass and the
    optimizer; clip norms still accumulate in fp32.

    ``log_module_norms`` turns ``grad_norm`` into a dictionary: ``total``,
    and for every top-level module ``k`` the norms ``grad/k`` and
    ``param/k`` (the parameters before this step's update);
    ``log_histograms`` adds ``hist/grad/k`` and ``hist/param/k``
    (:func:`magnitude_histogram`)."""
    if loss_fn is None:
        loss_fn = cross_entropy
    if grads_dtype is None:
        grads_dtype = {"bf16": torch.bfloat16}.get(
            os.environ.get("MME_GRADS", ""))

    def step(state: TrainState, batch: Dict[str, Any], labels, sample_mask,
             class_weights, loss_scale: float, apply_update: bool, rng: Rng):
        params = state.params
        device = params[0].device
        gen = _step_generator(rng, state.step, device)
        batch = to_device(batch, device)
        labels = torch.as_tensor(labels, device=device)
        sample_mask = torch.as_tensor(sample_mask, device=device)
        class_weights = torch.as_tensor(class_weights, device=device)

        model.train()
        out = model(batch, rng=gen)
        logits, aux = out if has_aux_loss else (out, None)
        loss = loss_fn(logits, labels, class_weights, sample_mask)
        if aux is not None:
            loss = loss + aux
        scaled_loss = loss * loss_scale
        grads = torch.autograd.grad(scaled_loss, params, allow_unused=True)
        # a parameter the forward did not reach (SpecAugment's embedding
        # with its probability at 0) has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if grads_dtype is not None:
            grads = [g.to(grads_dtype) if g.dtype == torch.float32 else g
                     for g in grads]
        grad_norm = global_norm_f32(grads)
        if log_module_norms or log_histograms:
            grad_norm = {"total": grad_norm}
            groups = _module_groups(model, params)
            with torch.no_grad():
                for k, idx in groups.items():
                    grad_norm[f"grad/{k}"] = global_norm_f32(
                        [grads[i] for i in idx])
                for k, idx in groups.items():
                    grad_norm[f"param/{k}"] = global_norm_f32(
                        [params[i] for i in idx])
                if log_histograms:
                    for k, idx in groups.items():
                        grad_norm[f"hist/grad/{k}"] = magnitude_histogram(
                            [grads[i] for i in idx])
                    for k, idx in groups.items():
                        grad_norm[f"hist/param/{k}"] = magnitude_histogram(
                            [params[i] for i in idx])

        if state.accum_grads is None:
            tx.update(params, grads, state.opt_state, gen)
        else:
            with torch.no_grad():
                for a, g in zip(state.accum_grads, grads):
                    a.add_(g)
            state.accum_count += 1
            if apply_update:
                mean = [a / state.accum_count for a in state.accum_grads]
                tx.update(params, mean, state.opt_state, gen)
                for a in state.accum_grads:
                    a.zero_()
                state.accum_count = 0

        with torch.no_grad():
            cm = confusion_matrix(logits.argmax(dim=-1), labels, num_classes,
                                  sample_mask)
        state.step += 1
        return state, scaled_loss.detach(), cm, grad_norm

    return step


def make_eval_step(model: nn.Module, num_classes: int,
                   loss_fn: Optional[Callable] = None,
                   has_aux_loss: bool = False) -> Callable:
    """Eval: ``loss, cm, preds = step(batch, labels, sample_mask,
    class_weights)`` with the deterministic forward and no gradients. The
    parameters are the model's, so the JAX step's ``params`` and
    ``batch_stats`` arguments have no counterpart. ``has_aux_loss``: the
    model returns ``(logits, aux)``; aux is a training regulariser and
    stays out of the eval (selection) loss."""
    if loss_fn is None:
        loss_fn = cross_entropy

    def step(batch: Dict[str, Any], labels, sample_mask, class_weights=None):
        device = next(model.parameters()).device
        batch = to_device(batch, device)
        labels = torch.as_tensor(labels, device=device)
        sample_mask = torch.as_tensor(sample_mask, device=device)
        if class_weights is not None:
            class_weights = torch.as_tensor(class_weights, device=device)
        model.eval()
        with torch.no_grad():
            logits = model(batch)
            if has_aux_loss:
                logits = logits[0]
            loss = loss_fn(logits, labels, class_weights, sample_mask)
            preds = logits.argmax(dim=-1)
            cm = confusion_matrix(preds, labels, num_classes, sample_mask)
        return loss, cm, preds

    return step
