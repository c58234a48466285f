"""Text+Video entry point: ``-m 1MTL`` → the shared-layer multi-task model
with one task drawn per step (text with p = 0.6, video with p = 0.4); any
other name → the BERT ⊕ VideoMAE late-fusion model.

Port of ``mme_tpu/cli/text_video_nn.py``. ``--dataset synthetic`` shrinks
both towers to ``TextVideoSpec.tiny()`` (12 tokens, 4×32×32 clips, 64
training records). Any other name builds the full towers over 9 989
full-size synthetic training clips of 16×224×224 (about 96 GB of float32
on the host), as JAX does; there is no ``MME_TINY`` here. Runs on the
card::

    python -m mme_tpu_torch.cli.text_video_nn --dataset synthetic -m 1MTL -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``).

The task of a step is a 0-d ``task_id`` added by :func:`make_task_transform`,
in training and in evaluation alike. Serving cuts every feature by rows, so
a 0-d feature cannot pass ``MME_PREDICT_OUT`` or ``MME_EXPORT_BUNDLE``; JAX
fails there after training, the port refuses ``-m 1MTL`` with either knob
before any work with a ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mme_tpu_torch.cli.common import BatchModel, run_classifier
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.text_video import (BertVideoMAELateFusion,
                                             BertVideoMAEMTLShared,
                                             TextVideoSpec)

TASK_PROBS = (0.6, 0.4)
INPUTS = ("input_ids", "text_mask", "video")


def synthetic_tv(spec: TextVideoSpec, n: int, text_len: int,
                 num_classes: int, seed: int) -> ArrayDataset:
    """Token ids with the label planted at 1..2, all-ones text masks, and
    clips [n, F, S, S, 3] in [0, 1) shifted by label / classes (JAX's
    ``_synthetic_tv``, the same arrays)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    ids = rng.randint(5, spec.text.vocab_size, size=(n, text_len))
    ids[:, 1:3] = labels[:, None] + 5
    F, S = spec.video.num_frames, spec.video.image_size
    video = rng.rand(n, F, S, S, 3).astype(np.float32)
    video += (labels / num_classes)[:, None, None, None, None]
    return ArrayDataset({
        "input_ids": ids.astype(np.int32),
        "text_mask": np.ones((n, text_len), np.int32),
        "video": video,
    }, labels.astype(np.int64))


def make_task_transform() -> Callable:
    """The MTL's per-step task: ``task_id`` = 1 (video) where a uniform
    draw from the step's generator exceeds ``TASK_PROBS[0]``, else 0
    (text), as a 0-d int32 tensor."""
    def transform(rng: torch.Generator, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        b = dict(batch)
        b["task_id"] = (torch.rand((), generator=rng, device=rng.device)
                        > TASK_PROBS[0]).to(torch.int32)
        return b
    return transform


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("text_video_nn", argv)
    cfg = config_from_args(args, device=device)
    np.random.seed(cfg.seed)

    mtl = cfg.model == "1MTL"
    if mtl:
        for knob in ("MME_PREDICT_OUT", "MME_EXPORT_BUNDLE"):
            if os.environ.get(knob):
                raise ValueError(
                    f"{knob} with -m 1MTL: the model's task_id is one 0-d "
                    "value per batch, and serving cuts every feature by "
                    "rows, so the run could not serve its test split (JAX "
                    "fails there too, after training); unset it")
    spec = TextVideoSpec(output_dim=cfg.output_dim, dropout=cfg.dropout)
    text_len = cfg.text_max_len
    synthetic = cfg.dataset == "synthetic"
    if synthetic:
        spec = spec.tiny()
        text_len = 12
    net = (BertVideoMAEMTLShared if mtl else BertVideoMAELateFusion)(
        spec, device=dev)
    net.load_state_dict(from_flax(**init_variables(net, cfg.seed)),
                        strict=True)
    n_train = 64 if synthetic else 9989
    mk = lambda n, s: synthetic_tv(spec, n, text_len, cfg.output_dim, s)
    train_ds, val_ds, test_ds = mk(n_train, 0), mk(16, 1), mk(16, 2)
    model = BatchModel(net, INPUTS + (("task_id",) if mtl else ()))
    return run_classifier(
        cfg, model, train_ds, val_ds, test_ds,
        batch_transform=make_task_transform() if mtl else None, device=dev)


if __name__ == "__main__":
    main()
