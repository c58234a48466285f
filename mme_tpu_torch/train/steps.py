"""The generic train and eval steps.

Port of ``mme_tpu/train/steps.py``: ``TrainState``, ``make_optimizer``,
``make_train_step`` and ``make_eval_step``. One step function serves every
loop variant: the epoch-parity loss switch arrives as a weight vector and
dialog-aligned accumulation as a per-step ``apply_update`` flag with a
``loss_scale``. ``magnitude_histogram`` and the per-module norm dictionary
are not ported yet; ``grad_norm`` is the global scalar.

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
from mme_tpu_torch.train.optim import (AdamWState, Optimizer, adamw,
                                       adamw_lowmem, global_norm_f32)

Rng = Union[int, torch.Generator]


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's parameters themselves (the step updates
    them in place); ``accum_grads`` is None when accumulation is off."""

    step: int
    params: List[nn.Parameter]
    opt_state: AdamWState
    accum_grads: Optional[List[torch.Tensor]]
    accum_count: int = 0

    @classmethod
    def create(cls, params: Sequence[nn.Parameter], tx: Optimizer,
               use_accum: bool = True,
               generator: Optional[torch.Generator] = None) -> "TrainState":
        """``use_accum=False`` drops the gradient-accumulation buffer, a
        whole fp32 copy of the parameters; every step then applies."""
        params = list(params)
        zeros = ([torch.zeros_like(p) for p in params] if use_accum
                 else None)
        return cls(step=0, params=params,
                   opt_state=tx.init(params, generator), accum_grads=zeros)


def make_optimizer(lr_schedule: Callable[[int], float], weight_decay: float,
                   clip: float,
                   trainable_mask: Optional[Sequence[bool]] = None,
                   state_dtype: Optional[str] = None) -> Optimizer:
    """clip-by-global-norm → AdamW (torch defaults: b1 .9, b2 .999, eps
    1e-8).

    ``trainable_mask``: one bool per parameter; False freezes the leaf for
    good (no update, not even weight decay). ``state_dtype``: "fp32"
    (default) or "bf16" (moments stored in bf16 with stochastic rounding);
    ``None`` reads ``MME_OPT_STATE``."""
    if state_dtype is None:
        state_dtype = os.environ.get("MME_OPT_STATE", "fp32")
    if state_dtype == "bf16":
        return adamw_lowmem(lr_schedule, weight_decay, clip, trainable_mask)
    if state_dtype == "factored":
        raise NotImplementedError(
            "state_dtype='factored' (adamw_factored) is not ported yet: see "
            "ROADMAP.md, queue 1")
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
                    grads_dtype: Optional[torch.dtype] = None) -> Callable:
    """Build the train step around ``model(batch, rng) -> logits``:

        state, loss, cm, grad_norm = step(
            state, batch, labels, sample_mask, class_weights, loss_scale,
            apply_update, rng)

    ``loss`` is the scaled loss, ``cm`` the batch's confusion matrix,
    ``grad_norm`` the global norm of this batch's (scaled, unclipped)
    gradients. ``rng`` is a ``torch.Generator`` on the model's device, or a
    seed. ``loss_fn(logits, labels, class_weights, sample_mask)`` defaults
    to cross entropy. ``grads_dtype=torch.bfloat16`` (or ``MME_GRADS=bf16``)
    stores the gradients in bf16 between the backward pass and the
    optimizer; clip norms still accumulate in fp32."""
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
        logits = model(batch, rng=gen)
        scaled_loss = loss_fn(logits, labels, class_weights,
                              sample_mask) * loss_scale
        grads = torch.autograd.grad(scaled_loss, params, allow_unused=True)
        # a parameter the forward did not reach (SpecAugment's embedding
        # with its probability at 0) has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        if grads_dtype is not None:
            grads = [g.to(grads_dtype) if g.dtype == torch.float32 else g
                     for g in grads]
        grad_norm = global_norm_f32(grads)

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
                   loss_fn: Optional[Callable] = None) -> Callable:
    """Eval: ``loss, cm, preds = step(batch, labels, sample_mask,
    class_weights)`` with the deterministic forward and no gradients. The
    parameters are the model's, so the JAX step's ``params`` and
    ``batch_stats`` arguments have no counterpart."""
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
            loss = loss_fn(logits, labels, class_weights, sample_mask)
            preds = logits.argmax(dim=-1)
            cm = confusion_matrix(preds, labels, num_classes, sample_mask)
        return loss, cm, preds

    return step
