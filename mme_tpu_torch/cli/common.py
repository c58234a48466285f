"""Shared CLI wiring: from a parsed config and a model to a trained,
evaluated run.

Port of ``mme_tpu/cli/common.py``: ``label_names``, ``invert_label_map``,
``resolve_pickle``, ``print_log``, ``make_bucket_iter`` and
``run_classifier``. ``run_classifier`` takes the port's ``nn.Module`` with
its weights loaded (JAX's takes ``apply_fn`` and a parameter tree) and
builds the rest as JAX does: class and sample weights, AdamW over cosine
warm restarts with the trainable mask, the state without an accumulation
buffer, the loss of ``--loss``, the train and eval steps, a ``RunLogger``,
then the loop and the test pass, and after it the serving exports:
``MME_PREDICT_OUT`` (a JSONL prediction log of the test split) and
``MME_EXPORT_BUNDLE`` (a deployment bundle of the trained model,
``serve.py::export_bundle``).

Knobs that need parts the port does not have yet raise
``NotImplementedError`` before any work: ``MME_MESH`` or more than one
device through ``MME_MP`` / ``MME_DP`` (the parallel axes and mesh
serving, ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import factored_views
from mme_tpu_torch.data.dataset import ArrayDataset, BucketedBatchIter
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.evals.metrics import Metrics
from mme_tpu_torch.serve import Predictor, export_bundle
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.losses import class_weights_from_counts, make_loss_fn
from mme_tpu_torch.train.loop import LoopCallbacks, evaluate, train_network
from mme_tpu_torch.train.policies import sample_weights_from_labels
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step,
                                       to_device)
from mme_tpu_torch.utils.profiling import RunLogger

MELD_EMOTIONS = ["neutral", "joy", "sadness", "anger", "surprise",
                 "fear", "disgust"]
MELD_SENTIMENTS = ["neutral", "positive", "negative"]
IEMOCAP_6 = ["neutral", "frustrated", "angry", "sad", "happy", "excited"]
HATEFUL = ["not_hateful", "hateful"]
MUSTARD_SARCASM = ["not_sarcastic", "sarcastic"]


def label_names(dataset: str, label_task: str, output_dim: int
                ) -> Dict[int, str]:
    """Display names of the classes: an explicit ``--label_task`` beats
    sniffing the dataset name."""
    ds = dataset.lower()
    if label_task == "sarcasm":
        names = MUSTARD_SARCASM
    elif label_task == "sentiment":
        names = MELD_SENTIMENTS
    elif "iemocap" in ds:
        names = IEMOCAP_6
    elif ("mustard" in ds or "sarcasm" in ds) and output_dim == 2:
        names = MUSTARD_SARCASM
    elif "hateful" in ds or output_dim == 2:
        names = HATEFUL
    else:
        names = MELD_EMOTIONS
    names = names[:output_dim]
    while len(names) < output_dim:
        names.append(f"class_{len(names)}")
    return {i: n for i, n in enumerate(names)}


def invert_label_map(label_map) -> Optional[Dict[int, str]]:
    """A name→id label map → the id→name map ``Metrics`` displays; None
    passes through."""
    if label_map is None:
        return None
    return {i: n for n, i in label_map.items()}


def resolve_pickle(dataset: str) -> Optional[str]:
    """``--dataset`` → pickle path, or None for the synthetic data. A named
    dataset whose pickle is missing raises instead of training on noise."""
    if dataset == "synthetic":
        return None
    pkl = dataset if dataset.endswith(".pkl") else f"{dataset}.pkl"
    if not os.path.exists(pkl):
        raise FileNotFoundError(
            f"dataset pickle {pkl!r} not found (--dataset {dataset!r}); "
            "use --dataset synthetic for random smoke data")
    return pkl


def print_log(d: Dict[str, Any]) -> None:
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in d.items()}), flush=True)


def make_bucket_iter(audio_len: int, default_on: bool = True
                     ) -> Optional[BucketedBatchIter]:
    """``MME_BUCKETS`` for the audio-bearing CLIs: a ``BucketedBatchIter``
    or None. Default bounds are quarters of the audio cap, floored at 1000
    samples; ``MME_BUCKETS="a,b,c"`` overrides, ``MME_BUCKETS=off``
    disables, and ``default_on=False`` engages only when it is set."""
    env = os.environ.get("MME_BUCKETS", "")
    if env == "off" or (not env and not default_on):
        return None
    if env:
        bounds = tuple(int(x) for x in env.split(","))
    else:
        bounds = tuple(sorted({max(audio_len * i // 4, 1000)
                               for i in range(1, 4)} | {audio_len}))
    print(f"length buckets: {bounds}", flush=True)
    return BucketedBatchIter(bounds)


def _refuse_unported(cfg: ExperimentConfig) -> None:
    if os.environ.get("MME_MESH", "off") != "off":
        raise NotImplementedError("MME_MESH needs the parallel axes, "
                                  "ROADMAP Queue 1 item 7, not ported yet")
    if cfg.mesh.model > 1 or cfg.mesh.data > 1:
        raise NotImplementedError(
            f"MME_MP={cfg.mesh.model} / MME_DP={cfg.mesh.data} ask for more "
            "than one device; the parallel axes (ROADMAP Queue 1 item 7) "
            "are not ported yet")


def run_classifier(cfg: ExperimentConfig, model: nn.Module,
                   train_ds: ArrayDataset, val_ds: ArrayDataset,
                   test_ds: ArrayDataset,
                   batch_transform=None,
                   trainable_mask: Optional[Sequence[bool]] = None,
                   batch_iter=None,
                   id2label: Optional[Dict[int, str]] = None,
                   checkpoints: Optional[CheckpointManager] = None,
                   has_aux_loss: bool = False,
                   device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Train ``model`` with the full policy stack, evaluate it on
    ``test_ds`` and return the test summary.

    ``model(batch, rng) -> logits`` holds its weights; it is moved to
    ``device``. ``trainable_mask``: one bool per parameter. ``id2label``:
    the dataset's id→name map (default: :func:`label_names`).
    ``checkpoints``: a manager to use instead of one on
    ``cfg.checkpoint_dir``. ``has_aux_loss``: the model returns
    ``(logits, aux)`` (``TAVMoEFormer``); aux joins the training loss and
    not the eval loss. Environment: ``MME_OPT_STATE``,
    ``MME_LOG_NORMS``, ``MME_LOG_HISTS``, ``MME_RUN_DIR``,
    ``MME_EVAL_ONLY`` (restore the best checkpoint and only evaluate),
    ``MME_RESUME``, ``MME_DUMP_PREDICTIONS``, ``MME_PREDICT_OUT``,
    ``MME_EXPORT_BUNDLE``."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    model.to(dev)
    num_classes = cfg.output_dim
    if id2label is None:
        id2label = label_names(cfg.dataset, cfg.label_task, num_classes)
    metric = Metrics(num_classes, id2label, device=dev)

    counts = np.bincount(train_ds.labels, minlength=num_classes)
    cw = class_weights_from_counts(counts)
    sw = sample_weights_from_labels(train_ds.labels, cw)

    steps_per_epoch = int(np.ceil(len(train_ds) / cfg.batch_size))
    views = (factored_views(model)
             if os.environ.get("MME_OPT_STATE") == "factored" else None)
    tx = make_optimizer(
        cosine_warm_restarts(cfg.learning_rate, cfg.T_max, steps_per_epoch),
        cfg.weight_decay, cfg.clip, trainable_mask, factored_views=views)
    names: List[str] = [n for n, _ in model.named_parameters()]
    # no accumulation buffer at creation: the loop hydrates it on dialog
    # accumulation epochs only
    state = TrainState.create(
        model.parameters(), tx, use_accum=False,
        generator=torch.Generator(device=dev).manual_seed(cfg.seed),
        names=names)
    loss_fn = make_loss_fn(cfg.loss, cfg.beta)
    train_step = make_train_step(
        model, tx, num_classes=num_classes, loss_fn=loss_fn,
        log_module_norms=os.environ.get("MME_LOG_NORMS") == "1",
        log_histograms=os.environ.get("MME_LOG_HISTS") == "1",
        has_aux_loss=has_aux_loss)
    eval_step = make_eval_step(model, num_classes=num_classes,
                               loss_fn=loss_fn, has_aux_loss=has_aux_loss)

    # a JSONL metrics trail next to the checkpoints (MME_RUN_DIR moves it)
    run_dir = os.environ.get("MME_RUN_DIR", cfg.checkpoint_dir)
    logger = RunLogger(run_dir)

    def _log(d: Dict[str, Any]) -> None:
        print_log(d)
        logger.log(d)

    cb = LoopCallbacks(log=_log)
    kwargs = {}
    if batch_transform is not None:
        kwargs["batch_transform"] = batch_transform
    ckpts = (checkpoints if checkpoints is not None
             else CheckpointManager(cfg.checkpoint_dir))
    if os.environ.get("MME_EVAL_ONLY"):
        if not ckpts.has_best():
            raise FileNotFoundError(
                f"MME_EVAL_ONLY set but no checkpoint in {ckpts.directory}")
        state, meta = ckpts.restore_best(state)
        print_log({"restored": meta})
    else:
        state = train_network(train_step, eval_step, state, train_ds, val_ds,
                              cfg, metric, cw, sw, cfg.seed,
                              checkpoints=ckpts, callbacks=cb,
                              use_weighted_loss=cfg.loss == "NewCrossEntropy",
                              resume=bool(os.environ.get("MME_RESUME")),
                              batch_iter=batch_iter, **kwargs)
    dump_path = None
    if os.environ.get("MME_DUMP_PREDICTIONS"):
        dump_path = os.path.join(run_dir, f"{cfg.model}Test.txt")
    summary = evaluate(eval_step, state, test_ds, cfg, metric,
                       callbacks=cb, dump_path=dump_path,
                       batch_iter=batch_iter, **kwargs)
    print_log(summary)
    _serving_exports(cfg, model, test_ds, batch_transform, id2label, dev,
                     _log)
    logger.finish()
    return summary


def _serving_exports(cfg: ExperimentConfig, model: nn.Module,
                     test_ds: ArrayDataset, batch_transform,
                     id2label: Dict[int, str], dev: torch.device,
                     log) -> None:
    """``MME_PREDICT_OUT``: ``Predictor.predict_dataset`` rows over the test
    split, through the run's ``batch_transform``, as JSONL.
    ``MME_EXPORT_BUNDLE``: a bundle of the trained model on ``dev``; its
    example goes through the same transform (generator seeded with 0), so
    its features are the transformed ones (normalised float video and
    ``video_keep`` for the TAV model)."""
    predict_out = os.environ.get("MME_PREDICT_OUT")
    if predict_out:
        was_training = model.training
        predictor = Predictor(model, batch_size=cfg.batch_size, device=dev)
        rows = 0
        with open(predict_out, "w") as fh:
            for row in predictor.predict_dataset(
                    test_ds, id2label, batch_transform=batch_transform):
                fh.write(json.dumps(row) + "\n")
                rows += 1
        model.train(was_training)
        log({"predict_out": predict_out, "rows": rows})
    export_dir = os.environ.get("MME_EXPORT_BUNDLE")
    if export_dir:
        example = {k: np.asarray(v[:cfg.batch_size])
                   for k, v in test_ds.features.items()}
        if batch_transform is not None:
            example = {k: v.cpu().numpy() for k, v in batch_transform(
                torch.Generator(device=dev).manual_seed(0),
                to_device(example, dev)).items()}
        info = export_bundle(model, example, export_dir,
                             batch_size=cfg.batch_size, id2label=id2label,
                             device=dev)
        log({"export_bundle": export_dir, **info})
