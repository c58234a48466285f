"""Video classifier entry point: ``-m ResNet`` → the slow-pathway 3-D
ResNet-50 with its proj→768 head; any other name → the scratch Conv3D
classifier.

Port of ``mme_tpu/cli/visual_nn.py``. ``--dataset synthetic`` (or
``MME_TINY``) runs 8×64×64 clips and a (1, 1, 1, 1)-block SlowR50; else
16×224×224 and (3, 4, 6, 3). SlowR50 trains its BatchNorms' running
statistics through ``run_classifier`` (they ride in the train state and its
checkpoints). ``--dataset <name>.pkl`` reads a pickled frame of the
records contract (``data/records.py``): each row's clip decoded by its
``timings`` with the IEMOCAP speaker crop, or its keyframe directory when
``MME_KEYFRAME_GLOB`` gives one (a ``str.format`` pattern over the row's
columns and ``{name}``, the clip's basename). Runs on the card::

    python -m mme_tpu_torch.cli.visual_nn --dataset synthetic -m ResNet -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``); for ``-m ResNet``, at any
size, ``MME_PRETRAINED`` naming a directory that holds a slow_r50
checkpoint loads its backbone and BatchNorm statistics
(``models/pretrained.py::load_slow_r50``; ``proj`` and the classifier stay
drawn), as JAX does. A missing pickle raises ``FileNotFoundError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import (BatchModel, pickle_splits,
                                      resolve_pickle, run_classifier)
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.data.records import PickleDatasetConfig, build_video_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.pretrained import load_slow_r50, pretrained_root
from mme_tpu_torch.models.video import Conv3DClassifier, SlowR50


def synthetic_video(n: int, frames: int, size: int, num_classes: int,
                    seed: int) -> ArrayDataset:
    """Clips [n, frames, size, size, 3] in [0, 1) shifted by label /
    classes (JAX's ``_synthetic_video``, the same arrays)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    video = rng.rand(n, frames, size, size, 3).astype(np.float32)
    video += (labels / num_classes)[:, None, None, None, None]
    return ArrayDataset({"video": video}, labels.astype(np.int64))


def load_weights(net, stages: Sequence[int], seed: int) -> None:
    """Load ``net`` with weights drawn from ``seed``; for ``SlowR50`` (the
    BatchNorm model) with ``MME_PRETRAINED`` naming a directory, its
    backbone and running statistics from the slow_r50 checkpoint found
    there (JAX's gate, ``mme_tpu/cli/visual_nn.py``)."""
    variables = init_variables(net, seed)
    root = pretrained_root()
    if root and isinstance(net, SlowR50):
        params, stats, ok = load_slow_r50(variables["params"],
                                          variables["batch_stats"], root,
                                          stages)
        if ok:
            variables = {"params": params, "batch_stats": stats}
            print("loaded pretrained slow_r50 backbone", flush=True)
    net.load_state_dict(from_flax(**variables), strict=True)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("visual_nn", argv)
    cfg = config_from_args(args, device=device)
    np.random.seed(cfg.seed)

    tiny = cfg.dataset == "synthetic" or bool(os.environ.get("MME_TINY"))
    frames, size = (8, 64) if tiny else (16, 224)
    stages = (1, 1, 1, 1) if tiny else (3, 4, 6, 3)
    resnet = cfg.model.lower() == "resnet"

    pkl = resolve_pickle(cfg.dataset)
    if pkl is not None:
        rcfg = PickleDatasetConfig(label_col=cfg.label_task, seed=cfg.seed)
        kf = os.environ.get("MME_KEYFRAME_GLOB")
        train_ds, val_ds, test_ds, id2label = pickle_splits(
            pkl, rcfg, lambda x: build_video_dataset(
                x, rcfg, frames, size, keyframe_glob=kf))
    else:
        id2label = None
        mk = lambda n, s: synthetic_video(n, frames, size, cfg.output_dim, s)
        train_ds, val_ds, test_ds = mk(64, 0), mk(16, 1), mk(16, 2)

    net = (SlowR50(cfg.output_dim, stage_sizes=stages, device=dev) if resnet
           else Conv3DClassifier(cfg.output_dim, device=dev))
    load_weights(net, stages, cfg.seed)
    return run_classifier(cfg, BatchModel(net, ("video",)), train_ds, val_ds,
                          test_ds, id2label=id2label, device=dev)


if __name__ == "__main__":
    main()
