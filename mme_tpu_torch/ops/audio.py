"""Audio-path ops: wav2vec2 mask math, SpecAugment and masked pooling.

Port of ``mme_tpu/ops/audio.py``. SpecAugment draws from a
``torch.Generator``, so its masks differ from JAX's bit for bit; they are
held to the same contract (span count formula, ``min_masks``, starts drawn
with replacement from a pool of ``max_spans``, no span past a row's
length).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mme_tpu_torch.parallel.mesh import batch_rand

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


def spec_augment_mask(rng: torch.Generator, batch: int, seq_len: int,
                      mask_prob: float, mask_length: int,
                      attention_mask: Optional[torch.Tensor] = None,
                      min_masks: int = 0,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """SpecAugment span mask [B, S] bool (True = masked): the expected
    masked fraction is about ``mask_prob``, spans are ``mask_length`` long
    and none reaches past a row's real length. Span starts are drawn with
    replacement from a pool of fixed size, so spans may overlap."""
    if attention_mask is not None:
        device = attention_mask.device
        lengths = attention_mask.sum(dim=-1).to(torch.int32)
    else:
        lengths = torch.full((batch,), seq_len, dtype=torch.int32,
                             device=device)
    # spans per row, with HF's stochastic rounding epsilon
    eps = batch_rand((batch,), rng, device)
    num_spans = (mask_prob * lengths / mask_length + eps).to(torch.int32)
    num_spans = torch.clamp(num_spans, min=min_masks)
    num_spans = torch.minimum(num_spans, lengths // mask_length)

    max_spans = max(int(mask_prob * seq_len / mask_length) + min_masks + 1, 1)
    hi = torch.clamp(lengths - mask_length + 1, min=1)   # starts in [0, hi)
    u = batch_rand((batch, max_spans), rng, device)
    starts = (u * hi[:, None]).to(torch.int32)
    span_active = (torch.arange(max_spans, device=device)[None, :]
                   < num_spans[:, None])
    pos = torch.arange(seq_len, device=device)[None, None, :]
    in_span = (pos >= starts[..., None]) & (pos < (starts + mask_length)[..., None])
    mask = (in_span & span_active[..., None]).any(dim=1)
    if attention_mask is not None:
        mask = mask & (pos[0] < lengths[:, None])
    return mask


def apply_spec_augment(rng: torch.Generator, hidden: torch.Tensor,
                       masked_embed: torch.Tensor,
                       time_mask_prob: float, time_mask_length: int,
                       feature_mask_prob: float, feature_mask_length: int,
                       attention_mask: Optional[torch.Tensor] = None,
                       time_min_masks: int = 2,
                       feature_min_masks: int = 0) -> torch.Tensor:
    """Time masking (masked frames become the learned ``masked_embed``)
    then feature masking (masked channels become 0) of hidden [B, S, H]."""
    b, s, h = hidden.shape
    out = hidden
    if time_mask_prob > 0:
        tmask = spec_augment_mask(rng, b, s, time_mask_prob, time_mask_length,
                                  attention_mask, time_min_masks,
                                  device=hidden.device)
        out = torch.where(tmask[..., None], masked_embed.to(out.dtype), out)
    if feature_mask_prob > 0:
        fmask = spec_augment_mask(rng, b, h, feature_mask_prob,
                                  feature_mask_length, None,
                                  feature_min_masks, device=hidden.device)
        out = torch.where(fmask[:, None, :],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def masked_mean_pool(x: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over real (non-pad) positions. x: [B, S, H]; mask: [B, S] 1/0."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return (x * m).sum(dim=1) / denom
