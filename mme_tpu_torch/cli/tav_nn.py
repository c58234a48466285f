"""TAV triple-fusion entry point, the flagship CLI.

Port of ``mme_tpu/cli/tav_nn.py``. ``--dataset synthetic`` (or
``MME_TINY``) trains the tiny-spec fusion stack end to end on generated
MELD-shaped records, through the whole policy stack of ``train/loop.py``.
Runs on the card::

    python -m mme_tpu_torch.cli.tav_nn --dataset synthetic -e 2 -b 8

and on the CPU only through ``main(argv, device="cpu")``.

Knobs: ``--mask`` off gives no SpecAugment and the fixed visual keep-mask;
``MME_DTYPE=bf16`` computes in bf16 over fp32 parameters;
``MME_SHARE_FRONTEND=1`` shares one conv audio frontend between the
PreFormer and the audio tower; ``MME_SCAN_LAYERS=1`` has no eager
counterpart and changes nothing. ``-m`` picks the fusion model from
``models/fusion.py::FUSION_MODELS`` (an unknown name gives ``TAVModel``, as
in JAX); ``-m TAVMoE`` trains with the MoE aux loss in the objective. What
the port lacks raises ``NotImplementedError``: a pickle dataset (ROADMAP
Queue 1 item 3), ``MME_SP`` / ``MME_PP`` above 1 (item 7) and
``MME_PRETRAINED`` (item 6). A missing pickle raises ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from mme_tpu_torch.cli.common import (make_bucket_iter, resolve_pickle,
                                      run_classifier)
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.data.synthetic import synthetic_tav_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.fusion import FUSION_MODELS, TAVSpec
from mme_tpu_torch.train.build_tav import (make_video_keep_transform,
                                           modality_embedding_trainable_mask)


def _refuse_unported() -> None:
    for var in ("MME_SP", "MME_PP"):
        if int(os.environ.get(var, "0") or 0) > 1:
            raise NotImplementedError(
                f"{var} > 1 needs the parallel axes (ROADMAP Queue 1 item 7)")
    if os.environ.get("MME_PRETRAINED"):
        raise NotImplementedError("MME_PRETRAINED needs the pretrained-weight "
                                  "import (ROADMAP Queue 1 item 6)")


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("tav_nn", argv)
    cfg = config_from_args(args)
    _refuse_unported()
    np.random.seed(cfg.seed)

    spec = TAVSpec(output_dim=cfg.output_dim, dropout=cfg.dropout,
                   learn_pos_embeddings=cfg.learn_PosEmbeddings)
    if not cfg.mask:
        # --mask gates the masking augmentations: off → no SpecAugment and
        # the fixed visual keep-mask below
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

    pkl = resolve_pickle(cfg.dataset)
    if pkl is not None:
        raise NotImplementedError(
            f"dataset pickle {pkl!r}: reading records (data/records.py) is "
            "not ported yet (ROADMAP Queue 1 item 3); use --dataset "
            "synthetic")
    mk = lambda n, s: synthetic_tav_dataset(
        spec, n, text_len=text_len, audio_len=audio_len,
        num_classes=cfg.output_dim, seed=s)
    train_ds, val_ds, test_ds = mk(64, 0), mk(16, 1), mk(16, 2)

    # -m selects the fusion architecture; an unknown name falls back to
    # TAVModel, as JAX's FUSION_MODELS.get(name, TAVModel) does
    model_cls = FUSION_MODELS.get(cfg.model, FUSION_MODELS["MAE_encoder"])
    model = model_cls(spec, device=dev)
    model.load_state_dict(
        from_flax(init_params(spec, cfg.seed, model=cfg.model)), strict=True)
    if os.environ.get("MME_SCAN_LAYERS") == "1":
        print("MME_SCAN_LAYERS: no eager counterpart; layers run one by one "
              "with the same numbers", flush=True)
    transform = make_video_keep_transform(spec, random_mask=cfg.mask)
    batch_iter = make_bucket_iter(audio_len, default_on=pkl is not None)
    return run_classifier(
        cfg, model, train_ds, val_ds, test_ds, batch_transform=transform,
        trainable_mask=modality_embedding_trainable_mask(
            model, spec.learn_pos_embeddings),
        batch_iter=batch_iter, has_aux_loss=cfg.model == "TAVMoE",
        device=dev)


if __name__ == "__main__":
    main()
