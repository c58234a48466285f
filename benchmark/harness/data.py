"""The one traffic generator: a pool of utterances drawn from the seed.

A mix's file gives the pool's size and the laws of its lengths; the
configuration gives the inputs its model takes and their padded shapes.
Lengths come from a fixed grid of quantiles of their law, shuffled by the
seed, so every seed gives the same work in another order; token ids,
waveforms, video and labels are drawn from the seed.

- text: ``text_len`` uniform integers on [min, max] real tokens (``<s>``
  first, ids from 5 up, the pad id after), padded to the configuration's
  ``text_len``;
- speech: log-normal seconds (``median``, ``sigma``) clipped to [min,
  max], at ``sample_rate``, zero past the length, padded to
  ``audio_samples``;
- video: ``num_frames`` × ``image_size``² × 3, uint8 or float32 in [0, 1).
"""

from __future__ import annotations

import statistics
from typing import Dict, Tuple

import numpy as np

INPUT_STREAM = 0x5EED_0002


def generator(seed: int, stream: int = INPUT_STREAM) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([seed, stream]))


def uniform_grid(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return lo + np.floor(q * (hi - lo + 1)).astype(np.int64)


def lognormal_grid(n: int, median: float, sigma: float, lo: float,
                   hi: float) -> np.ndarray:
    """The n quantiles (i + ½)/n of a log-normal law, clipped to [lo, hi]."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def make_pool(config: dict, mix: dict, seed: int
              ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """(features, labels) of ``mix["pool"]`` utterances."""
    rng = generator(seed)
    n = int(mix["pool"])
    inp = config["inputs"]
    names = inp["names"]
    feats: Dict[str, np.ndarray] = {}
    if "input_ids" in names:
        t = config["text"]
        L = inp["text_len"]
        tl = mix["text_len"]
        lens = rng.permutation(uniform_grid(n, tl["min"], min(tl["max"], L)))
        ids = rng.integers(5, t["vocab_size"], (n, L), dtype=np.int64)
        ids[:, 0] = 0
        mask = np.arange(L)[None, :] < lens[:, None]
        ids[~mask] = t["pad_token_id"]
        feats["input_ids"] = ids.astype(np.int32)
        feats["text_mask"] = mask.astype(np.int32)
    if "waveform" in names:
        S, sr = inp["audio_samples"], inp["sample_rate"]
        sp = mix["speech_s"]
        secs = rng.permutation(lognormal_grid(n, sp["median"], sp["sigma"],
                                              sp["min"], sp["max"]))
        lens = np.minimum(np.round(secs * sr).astype(np.int64), S)
        mask = np.arange(S)[None, :] < lens[:, None]
        wave = rng.standard_normal((n, S), dtype=np.float32) * np.float32(0.1)
        wave[~mask] = 0.0
        feats["waveform"] = wave
        feats["audio_mask"] = mask.astype(np.int32)
    if "video" in names:
        v = config["video"]
        shape = (n, v["num_frames"], v["image_size"], v["image_size"],
                 v["channels"])
        if inp["video_dtype"] == "uint8":
            feats["video"] = np.frombuffer(bytearray(
                rng.bytes(int(np.prod(shape)))), np.uint8).reshape(shape)
        else:
            feats["video"] = rng.random(shape, dtype=np.float32)
    labels = rng.integers(0, config["output_dim"], n).astype(np.int64)
    return feats, labels
