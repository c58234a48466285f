"""Audio towers: wav2vec2-base and -large, and the mean-pool classifier.

Port of ``mme_tpu/models/audio.py``: ``Wav2Vec2Spec`` (the bare spec and
``.base()`` are wav2vec2-base: group-norm extractor, no conv bias, post-LN
768x12 encoder; ``.large()`` is the layer-norm extractor with conv bias and
the stable-LN 1024x24 encoder), ``ConvFeatureExtractor``,
``FeatureProjection``, ``PositionalConvEmbedding``, ``Wav2Vec2Encoder``,
``Wav2Vec2Model`` and ``Wav2Vec2Classifier``, with their training-mode
sites (dropout after the feature projection, on the encoder input and on
the pooled vector; SpecAugment).

Public tensors keep the JAX layout: waveforms [B, T], features and hidden
states [B, F, C]. The convolutions run through ``F.conv1d`` (JAX leaves
them to XLA), channels-first inside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import (Dense, EncoderSpec,
                                         TransformerEncoder, activation,
                                         dropout, empty_param, remat_call)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.models.norm import GroupNorm
from mme_tpu_torch.ops.audio import (apply_spec_augment,
                                     feature_vector_attention_mask,
                                     masked_mean_pool)
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Spec:
    conv_dims: Sequence[int] = (512,) * 7
    conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"      # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # SpecAugment (training only)
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0
    remat_conv: bool = False  # remat the conv stack independently of encoders
    encoder: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=12, intermediate=3072,
        ln_style="post", ln_eps=1e-5, dropout=0.1))

    @staticmethod
    def base(**kw) -> "Wav2Vec2Spec":
        """'superb/wav2vec2-base-superb-er'-shaped."""
        return Wav2Vec2Spec(**kw)

    @staticmethod
    def large(**kw) -> "Wav2Vec2Spec":
        """'ehcalabres/wav2vec2-lg-xlsr-en-speech-emotion-recognition'-shaped."""
        return Wav2Vec2Spec(
            conv_bias=True, feat_extract_norm="layer",
            do_stable_layer_norm=True,
            encoder=EncoderSpec(hidden=1024, heads=16, layers=24,
                                intermediate=4096, ln_style="pre",
                                ln_eps=1e-5, final_ln=True, dropout=0.1),
            **kw)


class Conv1d(nn.Module):
    """Channels-last 1-D convolution: [B, T, C_in] → [B, T', C_out] in
    ``dtype``. ``weight`` is [out, in/groups, k] (flax's [k, in/groups,
    out] kernel permuted); ``bias`` is optional."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = empty_param((out_dim, in_dim // groups, kernel), dev)
        self.bias = empty_param(out_dim, dev) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).transpose(1, 2)
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if x.device.type == "cpu" and self.dtype != torch.float32:
            # torch's CPU conv sums bf16 products in bf16 (the grouped k=128
            # positional conv loses whole units); convolve the same bf16
            # operands in fp32, as XLA and cuDNN do, and round once
            x, w = x.float(), w.float()
            b = None if b is None else b.float()
        y = F.conv1d(x, w, b, self.stride, self.padding, 1, self.groups)
        return y.to(self.dtype).transpose(1, 2)


class ConvFeatureExtractor(nn.Module):
    """The strided conv stack over raw waveforms, each conv followed by
    exact gelu: [B, T] → [B, F, C_last]. ``feat_extract_norm="layer"``
    puts a LayerNorm over channels (``ln_{i}``) before every gelu;
    ``"group"`` puts one GroupNorm with a group per channel
    (``group_norm``, statistics over time) after ``conv_0`` only."""

    def __init__(self, spec: Wav2Vec2Spec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.n_convs = len(spec.conv_dims)
        self.remat = e.remat or spec.remat_conv
        self.norm = spec.feat_extract_norm
        in_dim = 1
        for i, (dim, k, st) in enumerate(zip(spec.conv_dims, spec.conv_kernels,
                                             spec.conv_strides)):
            self.add_module(f"conv_{i}", Conv1d(
                in_dim, dim, k, st, use_bias=spec.conv_bias, dtype=e.dtype,
                device=device))
            if self.norm == "layer":
                self.add_module(f"ln_{i}", FusedLayerNorm(
                    dim, 1e-5, e.dtype, device=device))
            in_dim = dim
        if self.norm == "group":
            self.group_norm = GroupNorm(spec.conv_dims[0],
                                        spec.conv_dims[0], 1e-5, e.dtype,
                                        device=device)
        self.gelu = activation("gelu")

    def _stack(self, waveform: torch.Tensor, rng=None) -> torch.Tensor:
        x = waveform[..., None]
        for i in range(self.n_convs):
            x = getattr(self, f"conv_{i}")(x)
            if self.norm == "layer":
                x = getattr(self, f"ln_{i}")(x)
            elif self.norm == "group" and i == 0:
                x = self.group_norm(x)
            x = self.gelu(x)
        return x

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        # remat with the encoders: the [B, T/5, 512] activations over ~1e5
        # samples are the largest of the model
        if self.remat and torch.is_grad_enabled():
            return remat_call(self._stack, None, waveform)
        return self._stack(waveform)


class FeatureProjection(nn.Module):
    def __init__(self, spec: Wav2Vec2Spec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.ln = FusedLayerNorm(spec.conv_dims[-1], e.ln_eps, e.dtype,
                                 device=device)
        self.projection = Dense(spec.conv_dims[-1], e.hidden, dtype=e.dtype,
                                device=device)
        self.dropout = e.dropout

    def forward(self, features: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        norm = self.ln(features)
        hidden = dropout(self.projection(norm), self.dropout, self.training,
                         rng)
        return hidden, norm


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (k=128, 16 groups) padded k//2 on
    each side; an even k trims the last frame. Weight-norm is folded into
    the kernel."""

    def __init__(self, spec: Wav2Vec2Spec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        k = spec.num_conv_pos_embeddings
        self.trim = k % 2 == 0
        self.conv = Conv1d(e.hidden, e.hidden, k, 1, k // 2,
                           spec.num_conv_pos_embedding_groups, dtype=e.dtype,
                           device=device)
        self.gelu = activation("gelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.trim:
            y = y[:, :-1, :]
        return self.gelu(y)


class Wav2Vec2Encoder(nn.Module):
    """Conv positional embedding, then for the post-LN (base) variant a
    LayerNorm ``ln``, then the transformer stack (the stable-LN variant's
    trailing LayerNorm is ``EncoderSpec.final_ln``)."""

    def __init__(self, spec: Wav2Vec2Spec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.pos_conv = PositionalConvEmbedding(spec, device=device)
        self.ln = (None if spec.do_stable_layer_norm else
                   FusedLayerNorm(e.hidden, e.ln_eps, e.dtype, device=device))
        self.layers = TransformerEncoder(e, device=device)
        self.dropout = e.dropout

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if attention_mask is not None:
            hidden = hidden * attention_mask[..., None].to(hidden.dtype)
        hidden = hidden + self.pos_conv(hidden)
        if self.ln is not None:
            hidden = self.ln(hidden)
        hidden = dropout(hidden, self.dropout, self.training, rng)
        bias = None if attention_mask is None else additive_mask(
            attention_mask)
        return self.layers(hidden, bias, rng)


def spec_augment(spec: Wav2Vec2Spec, rng: Optional[torch.Generator],
                 hidden: torch.Tensor, masked_embed: torch.Tensor,
                 feat_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``apply_spec_augment`` with the spec's probabilities and lengths."""
    if rng is None:
        raise ValueError("SpecAugment in training mode needs the step's "
                         "torch.Generator (rng=...)")
    return apply_spec_augment(
        rng, hidden, masked_embed, spec.mask_time_prob,
        spec.mask_time_length, spec.mask_feature_prob,
        spec.mask_feature_length, feat_mask, spec.mask_time_min_masks,
        spec.mask_feature_min_masks)


class Wav2Vec2Model(nn.Module):
    """Waveform [B, T] (+ keep-mask) → (hidden [B, F, H], normalised
    features, feature mask [B, F] or None).

    ``with_feature_extractor=False`` builds the model without its own conv
    stack, for the TAV model's shared audio frontend: the features then come
    in through ``features``. SpecAugment runs in training mode only, with
    the learned ``masked_spec_embed`` vector."""

    def __init__(self, spec: Wav2Vec2Spec, with_feature_extractor: bool = True,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.spec = spec
        self.feature_extractor = (ConvFeatureExtractor(spec, device=device)
                                  if with_feature_extractor else None)
        self.feature_projection = FeatureProjection(spec, device=device)
        self.masked_spec_embed = empty_param(spec.encoder.hidden,
                                             resolve_device(device))
        self.encoder = Wav2Vec2Encoder(spec, device=device)

    def forward(self, waveform: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                features: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        s = self.spec
        if features is None:
            features = self.feature_extractor(waveform)
        feat_mask = None
        if attention_mask is not None:
            feat_mask = feature_vector_attention_mask(
                features.shape[1], attention_mask, s.conv_kernels,
                s.conv_strides)
        hidden, norm_features = self.feature_projection(features, rng)
        if self.training and (s.mask_time_prob > 0
                              or s.mask_feature_prob > 0):
            hidden = spec_augment(s, rng, hidden, self.masked_spec_embed,
                                  feat_mask)
        hidden = self.encoder(hidden, feat_mask, rng)
        return hidden, norm_features, feat_mask


class Wav2Vec2Classifier(nn.Module):
    """Mean-pool classifier: ``wav2vec2`` → mean over the real frames
    (``masked_mean_pool``) → dropout → ``classifier``. Waveform [B, T] and
    its keep-mask → logits [B, output_dim] in the compute dtype. Dropout
    and SpecAugment draw from ``rng`` in training mode."""

    def __init__(self, spec: Wav2Vec2Spec, output_dim: int,
                 dropout: float = 0.5, device: DeviceLike = "cuda"):
        super().__init__()
        self.dropout = dropout
        self.wav2vec2 = Wav2Vec2Model(spec, device=device)
        self.classifier = Dense(spec.encoder.hidden, output_dim,
                                dtype=spec.encoder.dtype, device=device)

    def forward(self, waveform: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden, _, feat_mask = self.wav2vec2(waveform, attention_mask,
                                             rng=rng)
        pooled = dropout(masked_mean_pool(hidden, feat_mask), self.dropout,
                         self.training, rng)
        return self.classifier(pooled)
