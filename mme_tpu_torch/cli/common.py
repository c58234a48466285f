"""Shared CLI wiring: from a parsed config and a model to a trained,
evaluated run.

Port of ``mme_tpu/cli/common.py``: ``label_names``, ``invert_label_map``,
``resolve_pickle``, ``print_log``, ``make_bucket_iter`` and
``run_classifier``; ``pickle_splits``, the pickle branch the CLIs share;
and ``BatchModel``, the counterpart of the single-model CLIs'
``apply_fn``. ``run_classifier`` takes the port's ``nn.Module`` with
its weights (and running statistics) loaded (JAX's takes ``apply_fn``, a
parameter tree and ``batch_stats``) and builds the rest as JAX does: class
and sample weights, AdamW over cosine warm restarts with the trainable mask, the state without an accumulation
buffer, the loss of ``--loss``, the train and eval steps, a ``RunLogger``,
then the loop and the test pass, and after it the serving exports:
``MME_PREDICT_OUT`` (a JSONL prediction log of the test split) and
``MME_EXPORT_BUNDLE`` (a deployment bundle of the trained model,
``serve.py::export_bundle``).

Meshes. In a multi-process run (``parallel/distributed.py``) the port
builds JAX's auto ``("dp", "mp")`` mesh over the ranks when ``MME_MESH``
is on (the default) and the global batch divides by dp; ``MME_MP`` sets mp
and ``MME_DP`` dp through ``cfg.mesh``; a caller's mesh (``tav_nn``'s
``("dp", "sp")`` or ``("dp", "pp")``) wins, and its batch is split over
``dp`` only. On one rank the run is unmeshed, as JAX's on one
device. Ranks cannot sit idle, so a world of more than one rank without
such a mesh raises ``ValueError`` (JAX trains on a device subset instead).
Under a mesh the model's weights are replicated from rank 0 and then cut
by ``parallel/sharding_rules.py::shard_model``: over ``mp`` (tensor
parallelism; a mesh without ``mp`` replicates every leaf, as JAX does) and,
for an ``MoEMlp`` built with an expert axis, its expert stacks.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import factored_views
from mme_tpu_torch.data.dataset import ArrayDataset, BucketedBatchIter
from mme_tpu_torch.data.records import (PickleDatasetConfig, apply_filters,
                                        build_label_map, split_dataframe)
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.evals.metrics import Metrics
from mme_tpu_torch.models.layers import single_rank
from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.mesh import Mesh, barrier, make_mesh, replicate
from mme_tpu_torch.parallel.sharding_rules import shard_model, whole_model
from mme_tpu_torch.serve import Predictor, export_bundle
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.losses import class_weights_from_counts, make_loss_fn
from mme_tpu_torch.train.loop import LoopCallbacks, evaluate, train_network
from mme_tpu_torch.train.policies import sample_weights_from_labels
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step,
                                       model_buffers, to_device)
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


def pickle_splits(pkl: str, rcfg: PickleDatasetConfig,
                  build: Callable[[Any], ArrayDataset],
                  filtered: bool = False):
    """The pickle branch the CLIs share: read the pickle with
    ``pickle.load`` (a frame where pandas is installed, or a plain mapping
    of column name → array anywhere), apply ``records.apply_filters``
    first when ``filtered``, build the label map over the whole table
    into ``rcfg.label_map``, split it and ``build`` each split. Returns
    (train, val, test, id→name map or None for integer labels)."""
    with open(pkl, "rb") as fh:
        df = pickle.load(fh)
    if filtered:
        df = apply_filters(df, rcfg)
    # ids factorize over the FULL frame, so a class missing from one split
    # cannot shift the ids of the later classes in it
    rcfg.label_map = build_label_map(df, rcfg.label_col)
    train, val, test = (build(x) for x in split_dataframe(df, rcfg))
    return train, val, test, invert_label_map(rcfg.label_map)


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


class BatchModel(nn.Module):
    """``model(batch, rng) -> logits`` over a classifier that takes arrays,
    ``net(*[batch[k] for k in inputs], rng=rng)``: what the single-model
    CLIs' ``apply_fn`` does in JAX. A 1-D output (the ConvNet's binary
    sigmoid head) becomes the two-class ``[1 - p, p]``; logits come out in
    fp32. The parameters are ``net``'s, named ``net.<flax path>``."""

    def __init__(self, net: nn.Module, inputs: Sequence[str]):
        super().__init__()
        self.net = net
        self.inputs = tuple(inputs)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.net(*(batch[k] for k in self.inputs), rng=rng)
        if out.dim() == 1:
            out = torch.stack([1.0 - out, out], dim=-1)
        return out.float()


def auto_mesh(cfg: ExperimentConfig) -> Optional[Mesh]:
    """JAX's auto mesh over the world's ranks: None on one rank; with
    ``MME_MESH`` on (the default) a ``("dp", "mp")`` mesh of mp =
    ``cfg.mesh.model`` and dp = ``cfg.mesh.data`` (-1: the ranks mp
    leaves) when dp × mp is the world and the global batch divides by dp.
    More than one rank without such a mesh raises."""
    world = distributed.world_size()
    if world == 1:
        return None
    mp = max(cfg.mesh.model, 1)
    dp = cfg.mesh.data if cfg.mesh.data != -1 else world // mp
    if os.environ.get("MME_MESH", "on") == "off":
        why = "MME_MESH=off"
    elif dp * mp != world:
        why = f"dp={dp} x mp={mp} is not the world's {world} ranks"
    elif cfg.batch_size % dp:
        why = f"batch_size={cfg.batch_size} not divisible by dp={dp}"
    else:
        mesh = make_mesh(dp, mp)
        print(f"mesh: dp={dp} mp={mp} over {world} ranks", flush=True)
        return mesh
    raise ValueError(f"{world} ranks and no dp mesh: {why}")


def run_classifier(cfg: ExperimentConfig, model: nn.Module,
                   train_ds: ArrayDataset, val_ds: ArrayDataset,
                   test_ds: ArrayDataset,
                   batch_transform=None,
                   trainable_mask: Optional[Sequence[bool]] = None,
                   batch_iter=None,
                   id2label: Optional[Dict[int, str]] = None,
                   checkpoints: Optional[CheckpointManager] = None,
                   has_aux_loss: bool = False,
                   device: DeviceLike = "cuda",
                   mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Train ``model`` with the full policy stack, evaluate it on
    ``test_ds`` and return the test summary.

    ``model(batch, rng) -> logits`` holds its weights; it is moved to
    ``device``. Its persistent buffers (BatchNorm statistics) ride in the
    state and its checkpoints. ``trainable_mask``: one bool per parameter.
    ``id2label``: the dataset's id→name map (default: :func:`label_names`).
    ``checkpoints``: a manager to use instead of one on
    ``cfg.checkpoint_dir``. ``has_aux_loss``: the model returns
    ``(logits, aux)`` (``TAVMoEFormer``); aux joins the training loss and
    not the eval loss. Environment: ``MME_OPT_STATE``,
    ``MME_LOG_NORMS``, ``MME_LOG_HISTS``, ``MME_RUN_DIR``,
    ``MME_EVAL_ONLY`` (restore the best checkpoint and only evaluate),
    ``MME_RESUME``, ``MME_DUMP_PREDICTIONS``, ``MME_PREDICT_OUT``,
    ``MME_EXPORT_BUNDLE``, ``MME_MESH``. ``mesh``: a caller's mesh (its
    ``dp`` axis splits the batch); else :func:`auto_mesh`. ``device``:
    ``cuda`` is this rank's card (``distributed.rank_device``)."""
    if mesh is None:
        mesh = auto_mesh(cfg)
    elif cfg.batch_size % mesh.shape.get("dp", 1):
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                         f"dp={mesh.shape['dp']}")
    dev = resolve_device(distributed.rank_device(device))
    model.to(dev)
    if mesh is not None:
        replicate(model, mesh)
        if cfg.mesh.model > 1 and "mp" not in mesh.axis_names:
            print(f"MME_MP={cfg.mesh.model}: the mesh {mesh.shape} has no "
                  "mp axis; every leaf replicated", flush=True)
        shard_model(model, mesh)
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
        names=names, buffers=model_buffers(model))
    loss_fn = make_loss_fn(cfg.loss, cfg.beta)
    train_step = make_train_step(
        model, tx, num_classes=num_classes, loss_fn=loss_fn,
        log_module_norms=os.environ.get("MME_LOG_NORMS") == "1",
        log_histograms=os.environ.get("MME_LOG_HISTS") == "1",
        has_aux_loss=has_aux_loss, mesh=mesh)
    eval_step = make_eval_step(model, num_classes=num_classes,
                               loss_fn=loss_fn, has_aux_loss=has_aux_loss,
                               mesh=mesh)

    # a JSONL metrics trail next to the checkpoints (MME_RUN_DIR moves it);
    # rank 0 logs, the others stay quiet
    run_dir = os.environ.get("MME_RUN_DIR", cfg.checkpoint_dir)
    writer = distributed.is_writer()
    logger = RunLogger(run_dir) if writer else None

    def _log(d: Dict[str, Any]) -> None:
        if writer:
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
                              batch_iter=batch_iter, mesh=mesh, **kwargs)
    dump_path = None
    if os.environ.get("MME_DUMP_PREDICTIONS"):
        dump_path = os.path.join(run_dir, f"{cfg.model}Test.txt")
    summary = evaluate(eval_step, state, test_ds, cfg, metric,
                       callbacks=cb, dump_path=dump_path,
                       batch_iter=batch_iter, mesh=mesh, **kwargs)
    if writer:
        print_log(summary)
    _serving_exports(cfg, model, test_ds, batch_transform, id2label, dev,
                     _log, mesh)
    if writer:
        logger.finish()
    return summary


def _serving_exports(cfg: ExperimentConfig, model: nn.Module,
                     test_ds: ArrayDataset, batch_transform,
                     id2label: Dict[int, str], dev: torch.device,
                     log, mesh: Optional[Mesh] = None) -> None:
    """``MME_PREDICT_OUT``: ``Predictor.predict_dataset`` rows over the test
    split, through the run's ``batch_transform``, as JSONL.
    ``MME_EXPORT_BUNDLE``: a bundle of the trained model on ``dev``; its
    example goes through the same transform (generator seeded with 0), so
    its features are the transformed ones (normalised float video and
    ``video_keep`` for the TAV model). Under a mesh every rank serves its
    rows of the predictions (``Predictor(mesh=...)``; the ranks of an
    ``mp`` axis run the same rows with the tp collectives) and rank 0
    writes. A bundle is a program for one rank: every rank gathers the
    cut leaves whole (``sharding_rules.whole_model``) and rank 0 exports
    the model as one rank runs it (``models/layers.py::single_rank``: the
    attention core whole and every layer stack unpipelined while it traces,
    since ``torch.export`` cannot trace the ring's or the pipeline's
    messages)."""
    writer = distributed.is_writer()
    predict_out = os.environ.get("MME_PREDICT_OUT")
    if predict_out:
        was_training = model.training
        predictor = Predictor(model, batch_size=cfg.batch_size, device=dev,
                              mesh=mesh)
        rows = 0
        with open(predict_out if writer else os.devnull, "w") as fh:
            for row in predictor.predict_dataset(
                    test_ds, id2label, batch_transform=batch_transform):
                fh.write(json.dumps(row) + "\n")
                rows += 1
        model.train(was_training)
        log({"predict_out": predict_out, "rows": rows})
    export_dir = os.environ.get("MME_EXPORT_BUNDLE")
    if not export_dir:
        return
    with whole_model(model):
        if not writer:
            barrier()          # rank 0 exports
            return
        example = {k: np.asarray(v[:cfg.batch_size])
                   for k, v in test_ds.features.items()}
        if batch_transform is not None:
            example = {k: v.cpu().numpy() for k, v in batch_transform(
                torch.Generator(device=dev).manual_seed(0),
                to_device(example, dev)).items()}
        with single_rank(model):
            info = export_bundle(model, example, export_dir,
                                 batch_size=cfg.batch_size,
                                 id2label=id2label, device=dev)
        log({"export_bundle": export_dir, **info})
        if mesh is not None:
            barrier()
