"""Text+Audio entry point: the BERT ⊕ wav2vec2 late-fusion
``BertAudioClassifier``.

Port of ``mme_tpu/cli/text_audio_nn.py``. ``--dataset synthetic`` (or
``MME_TINY``) shrinks both towers to ``TextAudioSpec.tiny()`` over 12
tokens and 2 000-sample waveforms; otherwise DistilRoBERTa and
wav2vec2-base at ``text_max_len`` tokens and ``audio_max_samples`` samples
(70 and 160 000 by default). The data is synthetic whatever the name, as in
JAX: 64 / 16 / 16 records from :func:`synthetic_ta`. Runs on the card::

    python -m mme_tpu_torch.cli.text_audio_nn --dataset synthetic -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``); dropout and SpecAugment draw
from the step's generator.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import BatchModel, run_classifier
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.text_audio import BertAudioClassifier, TextAudioSpec

INPUTS = ("input_ids", "text_mask", "waveform", "audio_mask")


def synthetic_ta(spec: TextAudioSpec, n: int, text_len: int, audio_len: int,
                 num_classes: int, seed: int) -> ArrayDataset:
    """Token ids with the label planted at 1..2, all-ones text masks, and a
    label-pitched tone over noise cut at a ragged length with its keep-mask
    (JAX's ``_synthetic_ta``, the same arrays)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    ids = rng.randint(5, spec.text.vocab_size, size=(n, text_len))
    ids[:, 1:3] = labels[:, None] + 5
    t = np.arange(audio_len)[None, :]
    lengths = rng.randint(audio_len // 2, audio_len + 1, size=n)
    mask = (t < lengths[:, None]).astype(np.int32)
    wave = ((np.sin(2 * np.pi * 0.01 * (1 + labels[:, None]) * t)
             + 0.1 * rng.randn(n, audio_len)) * mask).astype(np.float32)
    return ArrayDataset({
        "input_ids": ids.astype(np.int32),
        "text_mask": np.ones((n, text_len), np.int32),
        "waveform": wave, "audio_mask": mask,
    }, labels.astype(np.int64))


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("text_audio_nn", argv)
    cfg = config_from_args(args, device=device)
    np.random.seed(cfg.seed)

    spec = TextAudioSpec(output_dim=cfg.output_dim, dropout=cfg.dropout)
    text_len, audio_len = cfg.text_max_len, cfg.audio_max_samples
    if cfg.dataset == "synthetic" or os.environ.get("MME_TINY"):
        spec = spec.tiny()
        text_len, audio_len = 12, 2000
    net = BertAudioClassifier(spec, device=dev)
    net.load_state_dict(from_flax(**init_variables(net, cfg.seed)),
                        strict=True)
    mk = lambda n, s: synthetic_ta(spec, n, text_len, audio_len,
                                   cfg.output_dim, s)
    train_ds, val_ds, test_ds = mk(64, 0), mk(16, 1), mk(16, 2)
    return run_classifier(cfg, BatchModel(net, INPUTS), train_ds, val_ds,
                          test_ds, device=dev)


if __name__ == "__main__":
    main()
