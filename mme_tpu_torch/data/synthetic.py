"""Synthetic records shaped like the real ones, the CLIs' data-free path.

Port of ``mme_tpu/data/synthetic.py``: ``synthetic_tav_dataset`` (MELD-shaped
triple-modal), ``synthetic_audio_dataset`` and ``synthetic_image_dataset``
(Hateful-Memes-shaped): the same arrays, bit for bit, for the same seed and
shapes, with the label planted in each modality so training can learn. The
text generator waits for its CLI (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np

from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.models.fusion import TAVSpec


def synthetic_tav_dataset(spec: TAVSpec, n: int, text_len: int = 70,
                          audio_len: int = 48000, num_classes: int = 7,
                          seed: int = 0,
                          dialog_size: int = 4) -> ArrayDataset:
    """Token ids [n, L], waveform [n, T] with its keep-mask, video
    [n, F, H, W, 3] as uint8-range floats, and dialog ids in runs of
    ``dialog_size``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)

    ids = rng.randint(5, spec.text.vocab_size, size=(n, text_len))
    # label-correlated tokens at the front
    ids[:, 1:4] = (labels[:, None] + 5 + np.arange(3)[None, :])
    text_mask = np.ones((n, text_len), np.int32)

    lengths = rng.randint(audio_len // 2, audio_len + 1, size=n)
    t = np.arange(audio_len)[None, :]
    audio_mask = (t < lengths[:, None]).astype(np.int32)
    freq = 0.01 * (1 + labels[:, None])
    wave = (np.sin(2 * np.pi * freq * t) +
            0.1 * rng.randn(n, audio_len)) * audio_mask
    wave = wave.astype(np.float32)

    F, S = spec.video.num_frames, spec.video.image_size
    video = rng.rand(n, F, S, S, 3).astype(np.float32)
    video += (labels / num_classes)[:, None, None, None, None]

    dialogs = np.repeat(np.arange((n + dialog_size - 1) // dialog_size),
                        dialog_size)[:n]
    return ArrayDataset(
        {"input_ids": ids.astype(np.int32), "text_mask": text_mask,
         "waveform": wave, "audio_mask": audio_mask, "video": video},
        labels.astype(np.int64), dialog_ids=dialogs)


def synthetic_audio_dataset(n: int, audio_len: int = 48000,
                            num_classes: int = 7, seed: int = 0
                            ) -> ArrayDataset:
    """Waveform [n, T] with a label-pitched tone over noise, zero past a
    ragged length, and its keep-mask."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    lengths = rng.randint(audio_len // 2, audio_len + 1, size=n)
    t = np.arange(audio_len)[None, :]
    mask = (t < lengths[:, None]).astype(np.int32)
    freq = 0.01 * (1 + labels[:, None])
    wave = ((np.sin(2 * np.pi * freq * t) + 0.1 * rng.randn(n, audio_len))
            * mask).astype(np.float32)
    return ArrayDataset({"waveform": wave, "audio_mask": mask},
                        labels.astype(np.int64))


def synthetic_image_dataset(n: int, size: int = 224, num_classes: int = 2,
                            seed: int = 0) -> ArrayDataset:
    """Images [n, size, size, 3] in [0, 1) shifted by label / classes."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    imgs = rng.rand(n, size, size, 3).astype(np.float32)
    imgs += (labels / num_classes)[:, None, None, None]
    return ArrayDataset({"image": imgs}, labels.astype(np.int64))
