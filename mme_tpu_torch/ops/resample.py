"""Windowed-sinc audio resampling, on the host and on any torch device.

Port of ``mme_tpu/ops/resample.py``. ``sinc_resample_kernel`` builds the
polyphase kernel (reduce the rates by their gcd, ``new_r`` phase filters of
``2·width + orig_r`` taps) in numpy, the same bits as JAX's and as the C++
decoder's (``mme_tpu_torch/native/wavio.cpp``); ``resample_numpy`` applies it
on the host, ``resample_waveform`` as one strided ``F.conv1d`` over a batch
of waves on their device (JAX leaves it to one XLA convolution, no Pallas
kernel, so plain PyTorch is its port). The convolution runs in fp32: cuDNN's
TF32 is turned off for it.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6,
                         rolloff: float = 0.99) -> tuple:
    """Returns (kernel [new_r, width2], width, orig_r, new_r), the kernel
    float32 with ``width2 = 2·width + orig_r`` taps."""
    gcd = math.gcd(orig_freq, new_freq)
    orig_r, new_r = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_r, new_r) * rolloff
    width = math.ceil(lowpass_filter_width * orig_r / base_freq)
    idx = np.arange(-width, width + orig_r, dtype=np.float64)[None, :] / orig_r
    t = np.arange(0, -new_r, -1, dtype=np.float64)[:, None] / new_r + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_r
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel.astype(np.float32), width, orig_r, new_r


def resample_waveform(wave: torch.Tensor, orig_freq: int, new_freq: int,
                      lowpass_filter_width: int = 6,
                      rolloff: float = 0.99) -> torch.Tensor:
    """Resample [B, T] (or [T]) fp32 waveforms on their device to
    ``ceil(new_r · T / orig_r)`` samples."""
    kernel, width, orig_r, new_r = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    if orig_r == new_r:
        return wave
    squeeze = wave.dim() == 1
    x = wave[None] if squeeze else wave
    B, T = x.shape
    x = F.pad(x, (width, width + orig_r))[:, None, :]
    k = torch.as_tensor(kernel, device=x.device)[:, None, :]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(x, k, stride=orig_r)            # [B, new_r, windows]
    # out[b, window · new_r + phase], as JAX's NHC layout interleaves
    y = y.transpose(1, 2).reshape(B, -1)
    y = y[:, :int(math.ceil(new_r * T / orig_r))]
    return y[0] if squeeze else y


def resample_numpy(wave: np.ndarray, orig_freq: int, new_freq: int,
                   lowpass_filter_width: int = 6,
                   rolloff: float = 0.99) -> np.ndarray:
    """The host path, with the same kernel: one wave [T]."""
    kernel, width, orig_r, new_r = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    if orig_r == new_r:
        return wave.astype(np.float32)
    wave = np.asarray(wave, np.float32)
    T = wave.shape[-1]
    x = np.pad(wave, (width, width + orig_r))
    num_windows = (len(x) - kernel.shape[1]) // orig_r + 1
    target_len = int(math.ceil(new_r * T / orig_r))
    out = np.zeros(num_windows * new_r, np.float32)
    strided = np.lib.stride_tricks.sliding_window_view(
        x, kernel.shape[1])[::orig_r]
    for phase in range(new_r):
        out[phase::new_r] = strided @ kernel[phase]
    return out[:target_len]
