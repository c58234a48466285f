"""Inputs of the flagship TAV model.

Port of the serving-side pieces of ``mme_tpu/train/build_tav.py``:
``example_tav_batch`` (drawn from a numpy seed, where JAX draws from a PRNG
key) and the uint8 video normalisation of ``make_video_keep_transform``.
``build_tav`` and the training transform arrive with training.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mme_tpu_torch.data.records import IMAGENET_MEAN, IMAGENET_STD
from mme_tpu_torch.models.fusion import TAVSpec


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


def normalize_uint8_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, H, W, C] → ImageNet-normalised fp32 on the same device.
    All-zero frames (padding) map to exact 0.0, as the fp32 path pads after
    normalisation; an all-black real frame is zeroed too."""
    valid = video.reshape(video.shape[0], video.shape[1], -1).amax(-1) > 0
    mean = torch.as_tensor(IMAGENET_MEAN, device=video.device)
    std = torch.as_tensor(IMAGENET_STD, device=video.device)
    vf = (video.float() / 255.0 - mean) / std
    return vf * valid[:, :, None, None, None]
