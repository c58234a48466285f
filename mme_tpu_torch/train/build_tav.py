"""Assembly of the flagship TAV training setup: model, optimizer, steps.

Port of ``mme_tpu/train/build_tav.py``: ``example_tav_batch`` (drawn from a
numpy seed, where JAX draws from a PRNG key), ``make_video_keep_transform``
with its uint8 video normalisation, ``modality_embedding_trainable_mask``
and ``build_tav``: AdamW over the trainable parameters, cosine warm
restarts, PreFormer + TAVForMAE.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import factored_views, from_flax, init_params
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.ops.video import (balanced_keep_mask,
                                     normalize_uint8_video,
                                     uniform_keep_mask)
from mme_tpu_torch.parallel.mesh import Mesh
from mme_tpu_torch.parallel.sharding_rules import shard_model
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step)


def example_tav_batch(spec: TAVSpec, batch_size: int, text_len: int,
                      audio_len: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A random full-length TAV batch as numpy arrays: token ids, all-ones
    masks, a normal waveform, normal fp32 video [B, T, H, W, 3] and a
    balanced keep-mask with exactly ``video_keep_k`` patches per row."""
    rng = np.random.default_rng(seed)
    v = spec.video
    scores = rng.random((batch_size, v.num_patches))
    keep_idx = np.argsort(-scores, axis=-1, kind="stable")[:, :spec.video_keep_k]
    keep = np.zeros((batch_size, v.num_patches), bool)
    np.put_along_axis(keep, keep_idx, True, axis=-1)
    return {
        "input_ids": rng.integers(0, spec.text.vocab_size,
                                  (batch_size, text_len), dtype=np.int32),
        "text_mask": np.ones((batch_size, text_len), np.int32),
        "waveform": rng.standard_normal((batch_size, audio_len),
                                        dtype=np.float32),
        "audio_mask": np.ones((batch_size, audio_len), np.int32),
        "video": rng.standard_normal(
            (batch_size, v.num_frames, v.image_size, v.image_size, 3),
            dtype=np.float32),
        "video_keep": keep,
    }


def make_video_keep_transform(spec: TAVSpec, random_mask: bool = True
                              ) -> Callable:
    """Per-batch visual keep-mask and on-device video normalisation:
    ``transform(rng, batch) -> batch``.

    ``random_mask=True``: a random balanced mask drawn anew from ``rng`` (a
    ``torch.Generator`` on the video's device) for every batch;
    ``False``: the fixed evenly-strided mask. uint8 video is
    ImageNet-normalised on the device (:func:`normalize_uint8_video`)."""

    def transform(rng: Optional[torch.Generator],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if random_mask and rng is None:
            raise ValueError("a random keep-mask needs a torch.Generator "
                             "(rng=...); it never draws from the global RNG")
        b = dict(batch)
        n = len(next(iter(batch.values())))
        v = b.get("video")
        device = v.device if isinstance(v, torch.Tensor) else "cpu"
        if isinstance(v, torch.Tensor) and v.dtype == torch.uint8:
            b["video"] = normalize_uint8_video(v)
        n_tok, keep_k = spec.video.num_patches, spec.video_keep_k
        b["video_keep"] = (
            balanced_keep_mask(n, n_tok, keep_k, rng, device) if random_mask
            else uniform_keep_mask(n, n_tok, keep_k, device))
        return b

    return transform


def modality_embedding_trainable_mask(model: nn.Module, learn: bool
                                      ) -> Optional[List[bool]]:
    """The ``learn_PosEmbeddings`` flag as a trainable mask, one bool per
    parameter of ``model``: None when everything trains, else False for
    every parameter under a ``modality_embedding`` module."""
    if learn:
        return None
    return ["modality_embedding" not in name.split(".")
            for name, _ in model.named_parameters()]


def _with_remat(spec: TAVSpec, remat: Union[bool, str]) -> TAVSpec:
    if not remat:
        return spec
    av_only = remat == "av"

    def on(e):
        return dataclasses.replace(e, remat=True)

    return dataclasses.replace(
        spec,
        text=spec.text if av_only else dataclasses.replace(
            spec.text, encoder=on(spec.text.encoder)),
        audio=dataclasses.replace(spec.audio, encoder=on(spec.audio.encoder)),
        video=dataclasses.replace(spec.video, encoder=on(spec.video.encoder)),
        fusion=spec.fusion if av_only else on(spec.fusion))


def build_tav(spec: TAVSpec, cfg: ExperimentConfig, steps_per_epoch: int,
              params: Optional[Dict[str, Any]] = None,
              remat: Union[bool, str] = True, use_accum: bool = True,
              device: DeviceLike = "cuda", mesh: Optional[Mesh] = None
              ) -> Tuple[TAVModel, TrainState, Callable, Callable]:
    """Returns (model, state, train_step, eval_step).

    ``params``: a flax-layout parameter tree (``convert.from_flax`` loads
    it); without one the weights are drawn by ``convert.init_params`` from
    ``cfg.seed``. ``remat``: True recomputes every encoder's blocks in the
    backward pass; ``"av"`` only the audio and video encoders' (the
    activation hogs: 24 layers of about 300 frames, 12 layers of 1464
    tokens); False none. The conv feature extractor's remat follows the
    audio encoder's or ``spec.audio.remat_conv``. ``mesh``: the steps
    split the batch over its ``dp`` axis (``train/steps.py``), and the
    weights are cut over its ``mp`` axis (``parallel/sharding_rules.py::
    shard_model``) before the optimizer state is made."""
    dev = resolve_device(device)
    spec = _with_remat(spec, remat)
    model = TAVModel(spec, device=dev)
    if params is None:
        params = init_params(spec, cfg.seed)
    model.load_state_dict(from_flax(params), strict=True)
    views = factored_views(model)
    if mesh is not None:
        shard_model(model, mesh)

    tx = make_optimizer(
        cosine_warm_restarts(cfg.learning_rate, cfg.T_max, steps_per_epoch),
        cfg.weight_decay, cfg.clip,
        modality_embedding_trainable_mask(model, spec.learn_pos_embeddings),
        factored_views=views)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = TrainState.create(model.parameters(), tx, use_accum=use_accum,
                              generator=gen)
    train_step = make_train_step(model, tx, num_classes=spec.output_dim,
                                 mesh=mesh)
    eval_step = make_eval_step(model, num_classes=spec.output_dim, mesh=mesh)
    return model, state, train_step, eval_step
