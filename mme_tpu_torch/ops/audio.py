"""Audio-path ops: wav2vec2 mask math and masked pooling.

Port of ``mme_tpu/ops/audio.py`` (``conv_output_lengths``,
``feature_vector_attention_mask``, ``masked_mean_pool``). SpecAugment is
training-only and is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# wav2vec2 conv feature-extractor geometry (all reference checkpoints share it)
W2V2_KERNELS = (10, 3, 3, 3, 3, 2, 2)
W2V2_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def conv_output_lengths(input_lengths: torch.Tensor,
                        kernels: Sequence[int] = W2V2_KERNELS,
                        strides: Sequence[int] = W2V2_STRIDES) -> torch.Tensor:
    """Output length of the strided conv stack: floor((L-k)/s) + 1 per
    layer. Floor division, as in JAX: a padded serving row has length 0 and
    goes negative here, which must give an all-zero feature mask."""
    lengths = input_lengths.to(torch.int32)
    for k, s in zip(kernels, strides):
        lengths = (lengths - k) // s + 1
    return lengths


def feature_vector_attention_mask(feature_len: int,
                                  attention_mask: torch.Tensor,
                                  kernels: Sequence[int] = W2V2_KERNELS,
                                  strides: Sequence[int] = W2V2_STRIDES
                                  ) -> torch.Tensor:
    """Downsample a waveform keep-mask [B, T] to feature space [B, F] int32:
    positions before the conv output length are attended."""
    lengths = conv_output_lengths(attention_mask.sum(dim=-1), kernels, strides)
    idx = torch.arange(feature_len, device=attention_mask.device)[None, :]
    return (idx < lengths[:, None]).to(torch.int32)


def masked_mean_pool(x: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over real (non-pad) positions. x: [B, S, H]; mask: [B, S] 1/0."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return (x * m).sum(dim=1) / denom
