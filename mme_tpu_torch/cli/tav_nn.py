"""TAV triple-fusion entry point, the flagship CLI.

Port of ``mme_tpu/cli/tav_nn.py``. ``--dataset synthetic`` (or
``MME_TINY``) trains the tiny-spec fusion stack end to end on generated
MELD-shaped records, through the whole policy stack of ``train/loop.py``.
``--dataset <name>.pkl`` reads a pickled frame of the records contract
(``data/records.py``): the label map over the whole frame, the split
column, dialog ids, the hash tokenizer for a vocabulary other than
50 265, uint8 video from keyframe directories (``MME_KEYFRAME_GLOB``, a
``str.format`` pattern over the row's columns and ``{name}``) or from the
clips, and length buckets on by default (``MME_BUCKETS``). Runs on the
card::

    python -m mme_tpu_torch.cli.tav_nn --dataset synthetic -e 2 -b 8

and on the CPU only through ``main(argv, device="cpu")``.

Knobs: ``--mask`` off gives no SpecAugment and the fixed visual keep-mask;
``MME_DTYPE=bf16`` computes in bf16 over fp32 parameters;
``MME_SHARE_FRONTEND=1`` shares one conv audio frontend between the
PreFormer and the audio tower; ``MME_SCAN_LAYERS=1`` has no eager
counterpart and changes nothing. ``-m`` picks the fusion model from
``models/fusion.py::FUSION_MODELS`` (an unknown name gives ``TAVModel``, as
in JAX); ``-m TAVMoE`` trains with the MoE aux loss in the objective.
``MME_PRETRAINED`` naming a directory of local checkpoints loads the three
pretrained towers and the PreFormer's copies of their embedding stages into
the full-width ``TAVModel`` (``models/pretrained.py::load_tav``), as JAX
does; any other model or width, or no such directory, loads nothing.
``MME_SP=<n>`` runs one tower's attention as ring attention over ``n``
ranks (``MME_SP_TOWER``: fusion, the default, video, audio or text) on a
``("dp", "sp")`` mesh of the world's ranks; ``MME_PP=<n>`` runs one
tower's layer stack as an ``n``-stage GPipe pipeline of ``MME_PP_MICRO``
microbatches (default 4; ``MME_PP_TOWER`` as ``MME_SP_TOWER``) on a
``("dp", "pp")`` mesh; the rest of the ranks form dp, and the two are
exclusive (:func:`parallel_spec`). ``MME_MP=<n>`` cuts the weights over an
``mp`` axis of ``run_classifier``'s mesh (tensor parallelism); under sp or
pp the caller's mesh wins and ``MME_MP`` changes nothing, as in JAX. A
missing pickle raises ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mme_tpu_torch.cli.common import (make_bucket_iter, pickle_splits,
                                      resolve_pickle, run_classifier)
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.data.records import (PickleDatasetConfig,
                                        build_tav_dataset, get_tokenizer)
from mme_tpu_torch.data.synthetic import synthetic_tav_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.fusion import FUSION_MODELS, TAVModel, TAVSpec
from mme_tpu_torch.models.pretrained import load_tav, pretrained_root
from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.mesh import Mesh, make_mesh
from mme_tpu_torch.train.build_tav import (make_video_keep_transform,
                                           modality_embedding_trainable_mask)


TOWERS = ("fusion", "video", "audio", "text")


def parallel_spec(cfg, spec: TAVSpec) -> Tuple[TAVSpec, Optional[Mesh]]:
    """``MME_SP=<n>`` or ``MME_PP=<n>`` (above 1; not both): a ``("dp",
    "sp")`` or ``("dp", "pp")`` mesh of the world's ranks with that axis of
    n, and one tower's encoder (``MME_SP_TOWER`` / ``MME_PP_TOWER``:
    fusion, the default, video, audio or text) set to run its attention as
    ring attention over ``sp``, or its layers as a GPipe pipeline of
    ``MME_PP_MICRO`` microbatches (default 4) over ``pp``; the batch is
    split over dp. Execution changes, parameters do not. JAX's checks, in
    its order and with its messages, raise ``ValueError`` before any work.
    Otherwise (spec, None)."""
    sp = int(os.environ.get("MME_SP", "0") or 0)
    pp = int(os.environ.get("MME_PP", "0") or 0)
    if sp <= 1 and pp <= 1:
        return spec, None
    if sp > 1 and pp > 1:
        raise ValueError("MME_SP and MME_PP are exclusive")
    par, axis = (sp, "sp") if sp > 1 else (pp, "pp")
    knob = "MME_SP" if sp > 1 else "MME_PP"
    tower = os.environ.get(f"{knob}_TOWER", "fusion")
    if tower not in TOWERS:
        raise ValueError(f"{knob}_TOWER={tower!r} is not one of {TOWERS}")
    world = distributed.world_size()
    if world % par:
        raise ValueError(f"{world} ranks not divisible by {knob}={par}")
    dp = world // par
    if cfg.batch_size % dp:
        raise ValueError(f"batch {cfg.batch_size} not divisible by dp={dp}")
    enc = spec.fusion if tower == "fusion" else getattr(spec, tower).encoder
    if pp > 1:
        micro = int(os.environ.get("MME_PP_MICRO", "4"))
        if enc.layers % pp:
            raise ValueError(f"{enc.layers} {tower} layers not divisible "
                             f"into {pp} stages")
        # the global batch splits into microbatches first, then each
        # microbatch's rows over dp
        if cfg.batch_size % micro or (cfg.batch_size // micro) % dp:
            raise ValueError(f"batch {cfg.batch_size} must split into "
                             f"{micro} microbatches of a dp={dp} multiple "
                             "(MME_PP_MICRO)")
    mesh = make_mesh(dp, par, axis_names=("dp", axis))
    if sp > 1:
        enc = dataclasses.replace(enc, seq_mesh=mesh, seq_axis="sp")
    else:
        enc = dataclasses.replace(enc, pp_mesh=mesh, pp_axis="pp",
                                  pp_micro=micro)
    if tower == "fusion":
        spec = dataclasses.replace(spec, fusion=enc)
    else:
        sub = getattr(spec, tower)
        spec = dataclasses.replace(spec, **{tower: dataclasses.replace(
            sub, encoder=enc)})
    print(f"{tower} tower {axis}={par} dp={dp} "
          f"({'ring attention' if sp > 1 else 'GPipe pipeline'})",
          flush=True)
    return spec, mesh


def tav_spec(cfg) -> Tuple[TAVSpec, int, int]:
    """(spec, audio samples, text tokens) of a run: ``--mask``, the tiny
    spec for synthetic data or ``MME_TINY``, ``MME_DTYPE`` and
    ``MME_SHARE_FRONTEND``."""
    spec = TAVSpec(output_dim=cfg.output_dim, dropout=cfg.dropout,
                   learn_pos_embeddings=cfg.learn_PosEmbeddings)
    if not cfg.mask:
        # --mask gates the masking augmentations: off → no SpecAugment and
        # the fixed visual keep-mask of the batch transform
        spec = dataclasses.replace(spec, audio=dataclasses.replace(
            spec.audio, mask_time_prob=0.0, mask_feature_prob=0.0))
    audio_len = cfg.audio_max_samples
    text_len = cfg.text_max_len
    if cfg.dataset == "synthetic" or os.environ.get("MME_TINY"):
        spec = spec.tiny()
        audio_len, text_len = 2000, 16
    if os.environ.get("MME_DTYPE", "") in ("bfloat16", "bf16"):
        spec = spec.with_compute_dtype(torch.bfloat16)
        print("compute dtype: bfloat16", flush=True)
    if os.environ.get("MME_SHARE_FRONTEND", "0") == "1":
        spec = dataclasses.replace(spec, share_audio_frontend=True)
        print("shared audio frontend (tied conv stacks)", flush=True)
    return spec, audio_len, text_len


def build_model(cfg, spec: TAVSpec, device: DeviceLike = "cuda"):
    """``-m``'s fusion model (an unknown name gives ``TAVModel``, as JAX's
    ``FUSION_MODELS.get(name, TAVModel)``) with weights drawn from
    ``--seed``; for ``TAVModel`` at width 768 with ``MME_PRETRAINED``
    naming a directory, the towers found there replace their drawn
    weights (``load_tav``; one ``loaded pretrained tower: <id>`` line
    each)."""
    model_cls = FUSION_MODELS.get(cfg.model, FUSION_MODELS["MAE_encoder"])
    model = model_cls(spec, device=device)
    params = init_params(spec, cfg.seed, model=cfg.model)
    root = pretrained_root()
    if root and spec.hidden == 768 and model_cls is TAVModel:
        params, loaded = load_tav(params, spec, root)
        for name in loaded:
            print(f"loaded pretrained tower: {name}", flush=True)
    model.load_state_dict(from_flax(params), strict=True)
    if os.environ.get("MME_SCAN_LAYERS") == "1":
        print("MME_SCAN_LAYERS: no eager counterpart; layers run one by one "
              "with the same numbers", flush=True)
    return model


def train(cfg, model, spec: TAVSpec, audio_len: int, train_ds, val_ds,
          test_ds, id2label: Optional[Dict[int, str]] = None,
          bucketed: bool = False,
          device: DeviceLike = "cuda",
          mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """``run_classifier`` with the CLI's batch transform, trainable mask
    and length buckets (``bucketed``: on unless ``MME_BUCKETS=off``;
    otherwise only with ``MME_BUCKETS``). ``mesh``: :func:`parallel_spec`'s
    (None: ``run_classifier``'s auto dp mesh)."""
    return run_classifier(
        cfg, model, train_ds, val_ds, test_ds,
        batch_transform=make_video_keep_transform(spec,
                                                  random_mask=cfg.mask),
        trainable_mask=modality_embedding_trainable_mask(
            model, spec.learn_pos_embeddings),
        batch_iter=make_bucket_iter(audio_len, default_on=bucketed),
        id2label=id2label, has_aux_loss=cfg.model == "TAVMoE",
        device=device, mesh=mesh)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    args = arg_parse("tav_nn", argv)
    cfg = config_from_args(args, device=device)
    dev = resolve_device(distributed.rank_device(device))
    np.random.seed(cfg.seed)
    spec, audio_len, text_len = tav_spec(cfg)
    spec, mesh = parallel_spec(cfg, spec)

    pkl = resolve_pickle(cfg.dataset)
    if pkl is not None:
        # uint8 video: 4x smaller records and host→device copies; the batch
        # transform normalises on the device
        rcfg = PickleDatasetConfig(label_col=cfg.label_task,
                                   text_max_len=text_len,
                                   audio_max_samples=audio_len,
                                   seed=cfg.seed, video_uint8=True)
        tok = get_tokenizer(
            None if spec.text.vocab_size != 50265 else
            "j-hartmann/emotion-english-distilroberta-base",
            spec.text.vocab_size)
        kf = os.environ.get("MME_KEYFRAME_GLOB")
        train_ds, val_ds, test_ds, id2label = pickle_splits(
            pkl, rcfg, lambda x: build_tav_dataset(
                x, rcfg, spec.video.num_frames, spec.video.image_size,
                tokenizer=tok, keyframe_glob=kf))
    else:
        id2label = None
        mk = lambda n, s: synthetic_tav_dataset(
            spec, n, text_len=text_len, audio_len=audio_len,
            num_classes=cfg.output_dim, seed=s)
        train_ds, val_ds, test_ds = mk(64, 0), mk(16, 1), mk(16, 2)

    model = build_model(cfg, spec, dev)
    # length buckets: on by default for a pickle's real lengths; synthetic
    # records have one length
    return train(cfg, model, spec, audio_len, train_ds, val_ds, test_ds,
                 id2label, bucketed=pkl is not None, device=dev, mesh=mesh)


if __name__ == "__main__":
    main()
