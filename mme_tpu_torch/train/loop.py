"""The generic training loop with the reference's whole policy stack.

Port of ``mme_tpu/train/loop.py`` (``LoopCallbacks``, ``run_validation``,
``train_network``, ``evaluate``), step for step:
- epoch-parity switching of the sampler order, the loss weights and
  dialog-aligned accumulation;
- validation every ``log_val`` steps and at the epoch's end, a best save on
  improvement, a patience count and the epoch break;
- the best reload after every epoch;
- the accumulation buffer, hydrated only on dialog-accumulation epochs and
  stripped in every checkpoint;
- a SIGTERM save into the ``latest`` slot (``MME_PREEMPT_SAVE``), resume
  from ``latest`` before ``best``, ``clear_latest`` on success and a
  :meth:`CheckpointManager.wait` before returning.

Resume from ``latest`` goes further than JAX's, which restarts the
preempted epoch with a fresh epoch order: the port replays the epoch orders
drawn before it, skips the batches the preempted run finished and keeps its
patience count, so a preempted and resumed run ends on the parameters of an
uninterrupted one. For that the SIGTERM save comes after the step's log
point (JAX saves before it), and it is exact when the signal falls on a
step that applied its update: the accumulation buffer is stripped in every
checkpoint, so a dialog cut in the middle restarts empty.

Under a mesh (``mesh=``) every rank builds the same global batches from
the same seeded order and keeps its rows along ``dp``
(``parallel/data.py::shard_batches``; the ranks of a ``pp`` axis hold the
same rows, and a tail batch is padded to the static batch size, as in JAX,
so the pipeline's microbatch count divides every batch); evaluation runs
the same model, pipelined where it is, deterministically. The host
bookkeeping (dialog
accumulation, dumps) reads the global batch's mask and labels. Every branch
on a metric (the best save, patience and the epoch break, the SIGTERM
save) reads rank 0's value (``parallel/mesh.py::agree``), so all ranks
take it together, and the loss and confusion matrices the metrics come
from are the global batch's. Only rank 0 writes checkpoints and dumps
(``train/checkpoint.py``); every rank restores.

Differences from JAX. JAX's ``_restore_flex`` fallback for checkpoints written
before stripping existed is dropped: the port has no such checkpoints. The
state is mutated in place (``train/steps.py``), so stripping or hydrating
the buffer replaces only that field on a shallow copy of the state, and a
restore copies into the state's own tensors.

Randomness: ``rng`` is a seed. The step folds it with ``state.step``, and
each batch transform draws from a generator seeded from (seed, step) on the
features' device, so a resumed run draws what an uninterrupted one would.
The epoch order is JAX's ``np.random.default_rng(cfg.seed)``.

Loss and confusion matrices accumulate on the device; the host syncs are
JAX's: the loss at a log point, the grad norm at a log point and the
scores of a validation. Features go to the device through
``data/prefetch.py`` unless ``MME_PREFETCH=0``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.data.dataset import ArrayDataset, batches
from mme_tpu_torch.data.prefetch import prefetch_batches
from mme_tpu_torch.evals.dumps import dump_predictions
from mme_tpu_torch.evals.metrics import Metrics
from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.data import global_rows, shard_batches
from mme_tpu_torch.parallel.mesh import Mesh, agree, batch_reduction
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.losses import epoch_parity_weights
from mme_tpu_torch.train.policies import (DialogAccumulator, dialog_counts,
                                          epoch_order)
from mme_tpu_torch.train.steps import TrainState, to_device

BatchTransform = Callable[[torch.Generator, Dict[str, torch.Tensor]],
                          Dict[str, Any]]


@dataclasses.dataclass
class LoopCallbacks:
    """Observability hooks: every log point's dict goes to ``log``."""

    log: Callable[[Dict[str, Any]], None] = lambda d: None


def _identity_transform(rng, batch):
    return batch


def fold_seed(*words: int) -> int:
    """A 63-bit seed from a tuple of integers (a seed, a step, a use)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


_TRANSFORM, _VALIDATION = 1, 2   # the uses fold_seed keeps apart


def _device_of(state: Any) -> torch.device:
    return state.params[0].device


def _batch_iter(ds: ArrayDataset, order: np.ndarray, batch_size: int,
                device: torch.device, batch_iter=None, skip: int = 0,
                mesh: Optional[Mesh] = None):
    """Host-gathered batches, their features prefetched to ``device``
    unless ``MME_PREFETCH=0``, the first ``skip`` left out. ``batch_iter``
    plugs in another iterator (length bucketing,
    ``data/dataset.py::BucketedBatchIter``). Under a mesh each batch is
    this rank's rows along ``dp``, with the global batch's
    ``GlobalRows`` in place of the indices."""
    src = (batch_iter(ds, order, batch_size) if batch_iter is not None
           else batches(ds, order, batch_size))
    if skip:
        src = itertools.islice(src, skip, None)
    if mesh is not None:
        src = shard_batches(src, mesh)
    if os.environ.get("MME_PREFETCH", "1") != "0":
        src = prefetch_batches(src, device)
    yield from src


def run_validation(eval_step, state: TrainState, ds: ArrayDataset,
                   cfg: ExperimentConfig, metric: Metrics,
                   class_weights: Optional[torch.Tensor],
                   batch_transform: BatchTransform,
                   rng: int, name: str,
                   callbacks: LoopCallbacks,
                   dump_path: Optional[str] = None,
                   batch_iter=None, mesh: Optional[Mesh] = None
                   ) -> Tuple[float, Dict[str, Any]]:
    """One pass over ``ds`` with the deterministic forward; logs and
    returns the mean batch loss and the ``name``-keyed summary.
    ``dump_path`` appends per-sample "label , pred" lines (rank 0)."""
    metric.reset_metrics()
    device = _device_of(state)
    dp = None if mesh is None else mesh.axis("dp")
    loss_acc, cm_acc, steps = None, None, 0
    order = np.arange(len(ds))
    for i, (batch, labels, mask, idx) in enumerate(_batch_iter(
            ds, order, cfg.batch_size, device, batch_iter, mesh=mesh)):
        with batch_reduction(dp):
            batch = batch_transform(_generator(fold_seed(rng, i), device),
                                    to_device(batch, device))
        loss, cm, preds = eval_step(batch, labels, mask, class_weights)
        # accumulate on the device: a float() here would sync every batch
        loss_acc = loss if loss_acc is None else loss_acc + loss
        cm_acc = cm if cm_acc is None else cm_acc + cm
        steps += 1
        if dump_path is not None and distributed.is_writer():
            rows = global_rows(idx, labels, mask)
            dump_predictions(dump_path, rows.labels, preds.cpu().numpy(),
                             rows.mask)
    if cm_acc is not None:
        metric.merge(cm_acc)
    avg = agree((float(loss_acc) if loss_acc is not None else 0.0)
                / max(steps, 1), mesh)
    d = metric.summary(name, include_confusion=True)
    d[f"{name}/loss"] = avg
    callbacks.log(d)
    metric.reset_metrics()
    return avg, d


def _strip_accum(s: Any) -> Any:
    """The state without its accumulation buffer (a shallow copy; other
    objects pass through)."""
    if not isinstance(s, TrainState):
        return s
    return dataclasses.replace(s, accum_grads=None, accum_count=0)


def _hydrate_accum(s: Any) -> Any:
    """The state with a zero accumulation buffer if it has none."""
    if not isinstance(s, TrainState) or s.accum_grads is not None:
        return s
    return dataclasses.replace(
        s, accum_grads=[torch.zeros_like(p) for p in s.params])


def train_network(train_step, eval_step, state: TrainState,
                  train_ds: ArrayDataset, val_ds: ArrayDataset,
                  cfg: ExperimentConfig, metric: Metrics,
                  class_weights: np.ndarray,
                  sample_weights: np.ndarray,
                  rng: int,
                  batch_transform: BatchTransform = _identity_transform,
                  checkpoints: Optional[CheckpointManager] = None,
                  callbacks: LoopCallbacks = LoopCallbacks(),
                  use_weighted_loss: bool = True,
                  resume: bool = False,
                  batch_iter=None,
                  mesh: Optional[Mesh] = None) -> TrainState:
    """Train with the reference policy stack; returns the best state (its
    tensors are ``state``'s own). ``resume=True`` restores the ``latest``
    slot of ``checkpoints`` if there is one, else the best. ``mesh``: the
    batch is split over its ``dp`` axis (module docstring)."""
    device = _device_of(state)
    dp = None if mesh is None else mesh.axis("dp")
    cw = torch.as_tensor(np.asarray(class_weights, np.float32),
                         device=device)
    host_rng = np.random.default_rng(cfg.seed)
    prev_val_loss = float("inf")
    patience_iter = 0

    accum = None
    if train_ds.dialog_ids is not None:
        accum = DialogAccumulator(dialog_counts(train_ds.dialog_ids))

    if checkpoints is None:
        checkpoints = CheckpointManager(cfg.checkpoint_dir)
    start_epoch, start_batch = 0, 0
    if resume:
        # the preemption slot is newer than the best
        if checkpoints.has_latest():
            state, meta = checkpoints.restore_latest(_strip_accum(state))
            prev_val_loss = float(meta.get("val_loss", prev_val_loss))
            start_epoch = int(meta.get("epoch", 0))
            start_batch = int(meta.get("batch", 0))
            patience_iter = int(meta.get("patience", 0))
            # the epoch orders the preempted run drew before its epoch
            for epoch in range(start_epoch):
                epoch_order(host_rng, epoch, cfg.epoch_switch,
                            sample_weights, len(train_ds))
        elif checkpoints.has_best():
            state, meta = checkpoints.restore_best(_strip_accum(state))
            prev_val_loss = float(meta.get("val_loss", prev_val_loss))

    # graceful preemption: finish the step in flight, save the state into
    # the latest slot, stop. MME_PREEMPT_SAVE=0 leaves SIGTERM alone.
    preempt = {"flag": False}
    preempted = False
    old_handler = None
    if os.environ.get("MME_PREEMPT_SAVE", "1") != "0":
        try:
            old_handler = signal.signal(
                signal.SIGTERM,
                lambda sig, frame: preempt.__setitem__("flag", True))
        except ValueError:   # not the main thread
            old_handler = None

    for epoch in range(start_epoch, cfg.epoch):
        order = epoch_order(host_rng, epoch, cfg.epoch_switch,
                            sample_weights, len(train_ds))
        use_dialog_accum = (accum is not None
                            and epoch % cfg.epoch_switch != 0)
        state = (_hydrate_accum(state) if use_dialog_accum
                 else _strip_accum(state))
        step_weights = (epoch_parity_weights(cw, epoch, cfg.epoch_switch)
                        if use_weighted_loss else torch.ones_like(cw))

        loss_acc, cm_acc, steps_done = None, None, 0
        if batch_iter is not None and hasattr(batch_iter, "epoch_len"):
            iters = batch_iter.epoch_len(train_ds, order, cfg.batch_size)
        else:
            iters = int(np.ceil(len(order) / cfg.batch_size))
        epoch_broken = False
        skip = start_batch if epoch == start_epoch else 0
        t0 = time.time()
        for bi, (batch, labels, mask, idx) in enumerate(
                _batch_iter(train_ds, order, cfg.batch_size, device,
                            batch_iter, skip, mesh), start=skip):
            if use_dialog_accum:
                # sequential order: batch position == dataset index. The
                # update applies when a sample of this batch ends a dialog;
                # the step averages the accumulated gradients, so the loss
                # stays unscaled
                apply_update = False
                valid = global_rows(idx, labels, mask).mask
                for j in range(int(np.asarray(valid).sum())):
                    _size, boundary = accum.step(bi * cfg.batch_size + j)
                    apply_update = apply_update or boundary
                apply_update = apply_update or (bi + 1 == iters)
            else:
                apply_update = True

            with batch_reduction(dp):
                tbatch = batch_transform(
                    _generator(fold_seed(rng, state.step, _TRANSFORM),
                               device),
                    to_device(batch, device))
            state, loss, cm, grad_norm = train_step(
                state, tbatch, labels, mask, step_weights, 1.0,
                apply_update, rng)
            # accumulate on the device; a float() here would sync every step
            loss_acc = loss if loss_acc is None else loss_acc + loss
            cm_acc = cm if cm_acc is None else cm_acc + cm
            steps_done += 1

            if ((bi + 1) % cfg.log_val == 0) or (bi + 1 == iters):
                if cm_acc is not None:
                    metric.merge(cm_acc)
                    cm_acc = None
                d = metric.summary("train")
                d["train/loss"] = float(loss_acc) / max(steps_done, 1)
                if isinstance(grad_norm, dict):
                    # per-module norms and histograms (MME_LOG_NORMS,
                    # MME_LOG_HISTS)
                    d["train/grad_norm"] = float(grad_norm["total"])
                    for k, v in grad_norm.items():
                        if k == "total":
                            continue
                        if k.startswith("hist/"):
                            d[f"train/{k}"] = v.cpu().numpy().tolist()
                        else:
                            d[f"train/norms/{k}"] = float(v)
                else:
                    d["train/grad_norm"] = float(grad_norm)
                d["train/steps_per_sec"] = steps_done / max(
                    time.time() - t0, 1e-9)
                d["epoch"] = epoch
                callbacks.log(d)
                metric.reset_metrics()
                # DELIBERATE (as in JAX and the reference): the validation
                # loss, which selects checkpoints, takes the epoch's parity
                # weights
                val_loss, _ = run_validation(
                    eval_step, state, val_ds, cfg, metric, step_weights,
                    batch_transform,
                    fold_seed(rng, state.step, _VALIDATION), "val",
                    callbacks, batch_iter=batch_iter, mesh=mesh)
                if val_loss < prev_val_loss:
                    patience_iter = 0
                    prev_val_loss = val_loss
                    checkpoints.save_best(
                        _strip_accum(state),
                        {"epoch": epoch, "step": int(state.step),
                         "val_loss": val_loss})
                else:
                    patience_iter += 1
                    if patience_iter >= cfg.patience:
                        epoch_broken = True
                        break

            if agree(float(preempt["flag"]), mesh):
                checkpoints.save_latest(
                    _strip_accum(state),
                    {"epoch": epoch, "batch": bi + 1,
                     "step": int(state.step), "val_loss": prev_val_loss,
                     "patience": patience_iter, "preempted": True})
                callbacks.log({"preempted": True, "epoch": epoch,
                               "step": int(state.step)})
                preempted = epoch_broken = True
                break

        # best-checkpoint reload after every epoch
        if checkpoints.has_best():
            state, _meta = checkpoints.restore_best(_strip_accum(state))
        if epoch_broken or patience_iter >= cfg.patience:
            break
        if accum is not None:
            accum = DialogAccumulator(accum.counts)

    if old_handler is not None:
        signal.signal(signal.SIGTERM, old_handler)
    if not preempted:
        # success: drop the preemption slot, so a later resume never
        # prefers a stale preempted state to the best
        checkpoints.clear_latest()
    checkpoints.wait()  # an async best save is durable before return
    return state


def evaluate(eval_step, state: TrainState, test_ds: ArrayDataset,
             cfg: ExperimentConfig, metric: Metrics,
             batch_transform: BatchTransform = _identity_transform,
             rng: int = 0,
             callbacks: LoopCallbacks = LoopCallbacks(),
             dump_path: Optional[str] = None,
             batch_iter=None,
             mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The test pass: unweighted loss and the ``test``-keyed summary."""
    _, summary = run_validation(eval_step, state, test_ds, cfg, metric, None,
                                batch_transform, rng, "test", callbacks,
                                dump_path=dump_path, batch_iter=batch_iter,
                                mesh=mesh)
    return summary
