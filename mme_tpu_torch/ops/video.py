"""Video-path ops: sinusoid tables, keep masks, visible-patch gathering,
uint8 normalisation.

Port of ``mme_tpu/ops/video.py``. ``balanced_keep_mask`` draws from a
``torch.Generator``, so its bits differ from JAX's; it is held to the same
contract (exactly ``keep_k`` kept per row).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mme_tpu_torch.data.records import IMAGENET_MEAN, IMAGENET_STD


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """VideoMAE's fixed sinusoidal position encodings [1, N, D] (HF
    ``get_sinusoid_encoding_table``)."""
    position = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = position / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def balanced_keep_mask(batch: int, num_tokens: int, keep_k: int,
                       generator: Optional[torch.Generator] = None,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Random bool keep-mask [batch, num_tokens] with exactly ``keep_k``
    True per row: the ``keep_k`` largest of uniform scores (top-k, so ties
    cannot change the count)."""
    scores = torch.rand(batch, num_tokens, generator=generator, device=device)
    idx = scores.topk(keep_k, dim=-1).indices
    keep = torch.zeros(batch, num_tokens, dtype=torch.bool, device=device)
    return keep.scatter_(1, idx, True)


def uniform_keep_mask(batch: int, num_tokens: int, keep_k: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Deterministic keep-mask: ``keep_k`` evenly-strided True per row."""
    idx = torch.floor(torch.arange(keep_k, dtype=torch.float32, device=device)
                      * (num_tokens / keep_k)).long()
    row = torch.zeros(num_tokens, dtype=torch.bool, device=device)
    row[idx] = True
    return row.expand(batch, num_tokens)


def gather_visible(x: torch.Tensor, keep: torch.Tensor,
                   keep_k: int) -> torch.Tensor:
    """Select kept tokens in original order: [B, N, D] + keep [B, N] →
    [B, keep_k, D]."""
    # a stable argsort of (not keep) puts the kept indices first, in order
    order = torch.argsort(torch.logical_not(keep).to(torch.uint8), dim=-1,
                          stable=True)
    idx = order[:, :keep_k]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def normalize_uint8_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, H, W, C] → ImageNet-normalised fp32 on the same device.
    All-zero frames (padding) map to exact 0.0, as the fp32 path pads after
    normalisation; an all-black real frame is zeroed too."""
    valid = video.reshape(video.shape[0], video.shape[1], -1).amax(-1) > 0
    mean = torch.as_tensor(IMAGENET_MEAN, device=video.device)
    std = torch.as_tensor(IMAGENET_STD, device=video.device)
    vf = (video.float() / 255.0 - mean) / std
    return vf * valid[:, :, None, None, None]
