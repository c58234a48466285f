"""Audio classifier entry point: wav2vec2 on raw waveforms → mean-pool →
classifier.

Port of ``mme_tpu/cli/audio_nn_wav2vec.py``: ``Wav2Vec2Classifier`` on
``Wav2Vec2Spec.base()`` (wav2vec2-base), trained through
``cli/common.py::run_classifier`` with length buckets
(``make_bucket_iter``, ``MME_BUCKETS``). ``--dataset synthetic`` (or
``MME_TINY``) shrinks the tower to JAX's tiny spec (three 32-wide convs, a
2-layer 64-wide encoder) over 4 000-sample waveforms. ``--dataset
<name>.pkl`` reads a pickled frame of the records contract
(``data/records.py``): rows with ``audio_shape`` up to 10 000 are dropped
before the label map is built over the frame, and the wav files are
decoded natively and resampled to 16 kHz. Runs on the card::

    python -m mme_tpu_torch.cli.audio_nn_wav2vec --dataset synthetic -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``); for the full-size conv
stack, ``MME_PRETRAINED`` naming a directory that holds
superb/wav2vec2-base-superb-er loads it into the ``wav2vec2`` tower
(``models/pretrained.py::load_audio_classifier``; the head stays drawn),
as JAX does. A missing pickle raises ``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import (BatchModel, make_bucket_iter,
                                      pickle_splits, resolve_pickle,
                                      run_classifier)
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.records import PickleDatasetConfig, build_audio_dataset
from mme_tpu_torch.data.synthetic import synthetic_audio_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.audio import Wav2Vec2Classifier, Wav2Vec2Spec
from mme_tpu_torch.models.pretrained import (AUDIO_SUPERB,
                                             load_audio_classifier,
                                             pretrained_root)


def tiny_spec(spec: Wav2Vec2Spec) -> Wav2Vec2Spec:
    """The CLI's synthetic-data tower."""
    return dataclasses.replace(
        spec, conv_dims=(32, 32, 32), conv_kernels=(10, 3, 3),
        conv_strides=(5, 2, 2),
        encoder=dataclasses.replace(spec.encoder, hidden=64, heads=4,
                                    layers=2, intermediate=128))


def load_weights(net: Wav2Vec2Classifier, spec: Wav2Vec2Spec,
                 seed: int) -> None:
    """Load ``net`` with weights drawn from ``seed``; for the full-size
    conv stack with ``MME_PRETRAINED`` naming a directory, its ``wav2vec2``
    tower from the superb checkpoint found there (JAX's gate,
    ``mme_tpu/cli/audio_nn_wav2vec.py``)."""
    variables = init_variables(net, seed)
    root = pretrained_root()
    if root and tuple(spec.conv_dims) == (512,) * 7:
        variables["params"], ok = load_audio_classifier(variables["params"],
                                                        spec, root)
        if ok:
            print(f"loaded pretrained audio tower from {root} "
                  f"({AUDIO_SUPERB})", flush=True)
    net.load_state_dict(from_flax(**variables), strict=True)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("audio_nn_wav2vec", argv)
    cfg = config_from_args(args, device=device)
    np.random.seed(cfg.seed)

    spec = Wav2Vec2Spec.base()
    audio_len = cfg.audio_max_samples
    if cfg.dataset == "synthetic" or os.environ.get("MME_TINY"):
        spec = tiny_spec(spec)
        audio_len = 4000
    pkl = resolve_pickle(cfg.dataset)
    if pkl is not None:
        rcfg = PickleDatasetConfig(label_col=cfg.label_task,
                                   audio_max_samples=audio_len,
                                   min_audio_shape=10000, seed=cfg.seed)
        train_ds, val_ds, test_ds, id2label = pickle_splits(
            pkl, rcfg, lambda x: build_audio_dataset(x, rcfg), filtered=True)
    else:
        id2label = None
        mk = lambda n, s: synthetic_audio_dataset(
            n, audio_len=audio_len, num_classes=cfg.output_dim, seed=s)
        train_ds, val_ds, test_ds = mk(128, 0), mk(32, 1), mk(32, 2)

    net = Wav2Vec2Classifier(spec, cfg.output_dim, cfg.dropout, device=dev)
    load_weights(net, spec, cfg.seed)
    return run_classifier(
        cfg, BatchModel(net, ("waveform", "audio_mask")), train_ds, val_ds,
        test_ds, batch_iter=make_bucket_iter(audio_len), id2label=id2label,
        device=dev)


if __name__ == "__main__":
    main()
