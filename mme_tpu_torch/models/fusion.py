"""TAV triple-modal fusion: embedding fuser + four-tower classifier.

Port of ``mme_tpu/models/fusion.py``: ``TAVSpec``, ``PreFormer``,
``TAVForMAE``, ``TAVModel`` with ``share_audio_frontend``, and the other
fusion trunks over the PreFormer's sequence, ``TAVFormer``,
``TAVForMAETwoTower``, ``TAVForW2V2`` and the sparse-MoE ``TAVMoEFormer``;
``FUSION_MODELS`` maps the CLI's ``-m`` names onto them. Training-mode sites
are included (SpecAugment in the PreFormer, head dropout).

The module tree and its parameter names follow the flax tree, so
``convert.from_flax`` maps one onto the other leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.audio import (ConvFeatureExtractor,
                                        FeatureProjection,
                                        PositionalConvEmbedding,
                                        Wav2Vec2Model, Wav2Vec2Spec,
                                        spec_augment)
from mme_tpu_torch.models.layers import (Dense, Embed, EncoderSpec,
                                         TransformerEncoder, dropout,
                                         empty_param)
from mme_tpu_torch.models.moe import MoESpec, MoETransformerEncoder
from mme_tpu_torch.models.text import (TextEmbeddings, TextEncoder,
                                       TextEncoderSpec)
from mme_tpu_torch.models.video import VideoMAEModel, VideoMAESpec
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.audio import (feature_vector_attention_mask,
                                     masked_mean_pool)
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class TAVSpec:
    """Configuration of the triple-modal stack (text distilroberta 768,
    audio wav2vec2-large 1024→768, video videomae-base 768)."""

    text: TextEncoderSpec = dataclasses.field(
        default_factory=TextEncoderSpec.distilroberta)
    audio: Wav2Vec2Spec = dataclasses.field(default_factory=Wav2Vec2Spec.large)
    video: VideoMAESpec = dataclasses.field(default_factory=VideoMAESpec.base)
    fusion: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=12, intermediate=3072,
        ln_style="pre", qkv_bias="qv", ln_eps=1e-12))
    hidden: int = 768
    output_dim: int = 7
    dropout: float = 0.5      # on the concatenated heads, before the classifier
    learn_pos_embeddings: bool = True   # False freezes modality_embedding
    video_keep_k: int = 104   # fused-tower visible patches (≈1568/15)
    # one conv feature extractor shared by the PreFormer and the full audio
    # tower (tied weights, half the conv work)
    share_audio_frontend: bool = False

    def with_compute_dtype(self, dtype: torch.dtype) -> "TAVSpec":
        """Mixed precision: params stay fp32, activations and matmuls in
        ``dtype``; softmax and LayerNorm statistics stay fp32."""
        def cast(e: EncoderSpec) -> EncoderSpec:
            return dataclasses.replace(e, dtype=dtype)
        return dataclasses.replace(
            self,
            text=dataclasses.replace(self.text, encoder=cast(self.text.encoder)),
            audio=dataclasses.replace(self.audio,
                                      encoder=cast(self.audio.encoder)),
            video=dataclasses.replace(self.video,
                                      encoder=cast(self.video.encoder)),
            fusion=cast(self.fusion))

    def tiny(self) -> "TAVSpec":
        """Scaled-down tree for tests and dry runs."""
        def small(e: EncoderSpec) -> EncoderSpec:
            return dataclasses.replace(e, hidden=32, heads=4, layers=2,
                                       intermediate=64)
        return dataclasses.replace(
            self,
            text=dataclasses.replace(
                TextEncoderSpec.distilroberta(), vocab_size=101,
                max_positions=80,
                encoder=small(TextEncoderSpec.distilroberta().encoder)),
            audio=dataclasses.replace(
                Wav2Vec2Spec.large(), conv_dims=(8, 8, 8),
                conv_kernels=(10, 3, 3), conv_strides=(5, 2, 2),
                encoder=small(Wav2Vec2Spec.large().encoder)),
            video=dataclasses.replace(
                VideoMAESpec.base(), image_size=32, patch_size=8,
                num_frames=4, tubelet_size=2,
                encoder=small(VideoMAESpec.base().encoder)),
            fusion=small(self.fusion),
            hidden=32, video_keep_k=4)


class PreFormer(nn.Module):
    """Embedding-stage fuser: returns the fused sequence [B, S_t+F+keep_k,
    hidden], modality-type ids (0 text / 1 audio / 2 video) and the fused
    keep-mask (1 = attend). The audio branch runs feature projection → zero
    the padded frames → conv positional embedding → LayerNorm →
    Linear(audio hidden → fusion hidden)."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        a = s.audio.encoder
        self.spec = spec
        self.text_embeddings = TextEmbeddings(s.text, device=device)
        self.feature_extractor = (None if s.share_audio_frontend else
                                  ConvFeatureExtractor(s.audio, device=device))
        self.feature_projection = FeatureProjection(s.audio, device=device)
        self.pos_conv = PositionalConvEmbedding(s.audio, device=device)
        self.audio_ln = FusedLayerNorm(a.hidden, a.ln_eps, a.dtype,
                                       device=device)
        self.wav_to_hidden = Dense(a.hidden, s.hidden, dtype=a.dtype,
                                   device=device)
        self.video = VideoMAEModel(s.video, with_encoder=False, device=device)
        self.masked_spec_embed = empty_param(a.hidden, resolve_device(device))

    def forward(self, input_ids: Optional[torch.Tensor],
                text_mask: Optional[torch.Tensor],
                waveform: torch.Tensor, audio_mask: torch.Tensor,
                video: torch.Tensor, video_keep: torch.Tensor,
                audio_features: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        s = self.spec
        # input_ids=None fuses audio and video only
        t = (None if input_ids is None
             else self.text_embeddings(input_ids, rng=rng))
        feats = (audio_features if audio_features is not None
                 else self.feature_extractor(waveform))
        feat_mask = feature_vector_attention_mask(
            feats.shape[1], audio_mask, s.audio.conv_kernels,
            s.audio.conv_strides)
        a, _ = self.feature_projection(feats, rng)
        if self.training and s.audio.mask_time_prob > 0:
            a = spec_augment(s.audio, rng, a, self.masked_spec_embed,
                             feat_mask)
        # zero padded frames before the conv positional embedding so pad
        # length cannot bleed into real positions
        a = a * feat_mask[..., None].to(a.dtype)
        a = a + self.pos_conv(a)
        a = self.wav_to_hidden(self.audio_ln(a))
        v = self.video.embed(video, video_keep, s.video_keep_k)

        B, dev = a.shape[0], a.device
        parts = [a, v]
        type_parts = [
            torch.ones((B, a.shape[1]), dtype=torch.int32, device=dev),
            torch.full((B, v.shape[1]), 2, dtype=torch.int32, device=dev)]
        keep_parts = [
            feat_mask, torch.ones((B, v.shape[1]), dtype=torch.int32,
                                  device=dev)]
        if t is not None:          # text first, as in JAX
            parts.insert(0, t)
            type_parts.insert(0, torch.zeros((B, t.shape[1]),
                                             dtype=torch.int32, device=dev))
            keep_parts.insert(0, text_mask.to(torch.int32))
        return (torch.cat(parts, dim=1), torch.cat(type_parts, dim=1),
                torch.cat(keep_parts, dim=1))


class TAVForMAE(nn.Module):
    """Four-tower fusion classifier: (a) the fused sequence plus a learned
    3-way modality embedding through the fusion trunk, masked-mean pooled;
    (b) the text tower's pooled output; (c) the full audio tower, projected
    and masked-mean pooled; (d) the full video tower over the patches the
    trunk did not see, mean pooled. Each goes through its own LayerNorm
    (flax's default eps 1e-6), then one Linear over the concatenation."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        f = s.fusion
        self.spec = spec
        self.modality_embedding = Embed(3, s.hidden, f.dtype, device=device)
        self.text_encoder = TextEncoder(s.text, device=device)
        self.wav2vec2 = Wav2Vec2Model(
            s.audio, with_feature_extractor=not s.share_audio_frontend,
            device=device)
        self.wav_to_hidden = Dense(s.audio.encoder.hidden, s.hidden,
                                   dtype=s.audio.encoder.dtype, device=device)
        self.videomae = VideoMAEModel(s.video, device=device)
        self.fusion_encoder = TransformerEncoder(f, device=device)
        for name in ("text_norm", "fusion_norm", "audio_norm", "video_norm"):
            self.add_module(name, FusedLayerNorm(s.hidden, 1e-6, f.dtype,
                                                 device=device))
        self.classifier = Dense(4 * s.hidden, s.output_dim, dtype=f.dtype,
                                device=device)

    def forward(self, input_ids: torch.Tensor, text_mask: torch.Tensor,
                waveform: torch.Tensor, audio_mask: torch.Tensor,
                video: torch.Tensor, video_keep: torch.Tensor,
                fused: torch.Tensor, type_ids: torch.Tensor,
                fused_keep: torch.Tensor,
                audio_features: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        s = self.spec
        av = fused + self.modality_embedding(type_ids)

        aud_hidden, _, aud_feat_mask = self.wav2vec2(
            waveform, audio_mask, features=audio_features, rng=rng)
        aud = masked_mean_pool(self.wav_to_hidden(aud_hidden), aud_feat_mask)

        vid = self.videomae(video, torch.logical_not(video_keep),
                            s.video.num_patches - s.video_keep_k,
                            rng).mean(dim=1)

        _, pooled_text = self.text_encoder(input_ids, text_mask, rng=rng)

        av = self.fusion_encoder(av, additive_mask(fused_keep), rng)
        av = self.fusion_norm(masked_mean_pool(av, fused_keep))

        tav = torch.cat([av, self.text_norm(pooled_text),
                         self.audio_norm(aud), self.video_norm(vid)], dim=1)
        return self.classifier(dropout(tav, s.dropout, self.training, rng))


class TAVModel(nn.Module):
    """PreFormer + TAVForMAE: the flagship forward. ``batch`` holds
    ``input_ids``, ``text_mask``, ``waveform``, ``audio_mask``, ``video``
    (normalised, [B, T, H, W, C]) and ``video_keep``; the logits
    [B, output_dim] come out in fp32 (their values are those of the compute
    dtype, as in flax). In training mode (``.train()``) dropout and
    SpecAugment draw from ``rng``; ``.eval()`` is the deterministic
    forward."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.spec = spec
        self.preformer = PreFormer(spec, device=dev)
        self.model = TAVForMAE(spec, device=dev)
        self.audio_frontend = (ConvFeatureExtractor(spec.audio, device=dev)
                               if spec.share_audio_frontend else None)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = (self.audio_frontend(batch["waveform"])
                 if self.audio_frontend is not None else None)
        fused, type_ids, fused_keep = self.preformer(
            batch["input_ids"], batch["text_mask"], batch["waveform"],
            batch["audio_mask"], batch["video"], batch["video_keep"],
            audio_features=feats, rng=rng)
        logits = self.model(
            batch["input_ids"], batch["text_mask"], batch["waveform"],
            batch["audio_mask"], batch["video"], batch["video_keep"],
            fused, type_ids, fused_keep, audio_features=feats, rng=rng)
        return logits.float()


class _FusionTrunk(nn.Module):
    """The variants' common shape: the PreFormer's fused sequence plus a
    learned 3-way modality embedding through ``encoder``, masked-mean
    pooled and normalised (flax's default eps 1e-6) into ``norm_name``,
    then the head. The variants pass ``audio_features`` to nothing, so the
    PreFormer keeps its own conv stack whatever ``share_audio_frontend``
    says, as JAX's does."""

    def __init__(self, spec: TAVSpec, trunk: EncoderSpec, norm_name: str,
                 device: DeviceLike):
        super().__init__()
        self.spec = spec
        self.norm_name = norm_name
        self.preformer = PreFormer(
            dataclasses.replace(spec, share_audio_frontend=False),
            device=device)
        self.modality_embedding = Embed(3, spec.hidden, trunk.dtype,
                                        device=device)
        self.add_module(norm_name, FusedLayerNorm(spec.hidden, 1e-6,
                                                  trunk.dtype, device=device))

    def pooled(self, batch: Dict[str, torch.Tensor],
               rng: Optional[torch.Generator], encoder: nn.Module):
        """(pooled trunk output [B, hidden], what ``encoder`` returned
        besides its sequence, or None)."""
        fused, type_ids, keep = self.preformer(
            batch["input_ids"], batch["text_mask"], batch["waveform"],
            batch["audio_mask"], batch["video"], batch["video_keep"],
            rng=rng)
        out = encoder(fused + self.modality_embedding(type_ids),
                      additive_mask(keep), rng)
        x, extra = out if isinstance(out, tuple) else (out, None)
        return getattr(self, self.norm_name)(masked_mean_pool(x, keep)), extra


class TAVFormer(_FusionTrunk):
    """Scratch fusion trunk: the fused sequence through a post-LN encoder
    without q/k/v biases (``early_div`` folded into the 1/√d scaling),
    mean-pool → LN → Linear(hidden, C); no head dropout."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        trunk = dataclasses.replace(spec.fusion, ln_style="post",
                                    qkv_bias="none")
        super().__init__(spec, trunk, "norm", dev)
        self.encoder = TransformerEncoder(trunk, device=dev)
        self.classifier = Dense(spec.hidden, spec.output_dim,
                                dtype=trunk.dtype, device=dev)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x, _ = self.pooled(batch, rng, self.encoder)
        return self.classifier(x).float()


class TAVForMAETwoTower(_FusionTrunk):
    """The older two-tower TAVForMAE: the fused sequence through the
    fusion encoder → mean → LN, concatenated after the text tower's pooled
    output ([text, fused], 2·hidden) → dropout → Linear(·, C)."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        f = spec.fusion
        super().__init__(spec, f, "fc_norm", dev)
        self.text_encoder = TextEncoder(spec.text, device=dev)
        self.fusion_encoder = TransformerEncoder(f, device=dev)
        self.classifier = Dense(spec.text.encoder.hidden + spec.hidden,
                                spec.output_dim, dtype=f.dtype, device=dev)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        av, _ = self.pooled(batch, rng, self.fusion_encoder)
        _, t = self.text_encoder(batch["input_ids"], batch["text_mask"],
                                 rng=rng)
        x = torch.cat([t, av.to(t.dtype)], dim=1)
        x = dropout(x, self.spec.dropout, self.training, rng)
        return self.classifier(x).float()


class TAVForW2V2(_FusionTrunk):
    """wav2vec2-base-shaped fusion trunk, randomly initialised: post-LN
    encoder layers with full q/k/v biases and no conv positional
    embedding, mean → LN → dropout → Linear(hidden, C)."""

    def __init__(self, spec: TAVSpec, device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        trunk = dataclasses.replace(spec.fusion, ln_style="post",
                                    qkv_bias="full")
        super().__init__(spec, trunk, "fc_norm", dev)
        self.encoder = TransformerEncoder(trunk, device=dev)
        self.classifier = Dense(spec.hidden, spec.output_dim,
                                dtype=trunk.dtype, device=dev)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x, _ = self.pooled(batch, rng, self.encoder)
        x = dropout(x, self.spec.dropout, self.training, rng)
        return self.classifier(x).float()


class TAVMoEFormer(_FusionTrunk):
    """Sparse-MoE fusion trunk: the fused sequence through a
    ``MoETransformerEncoder`` (``moe``, default ``MoESpec()``: every second
    block's MLP a top-2 mixture of 4 experts), mean → LN → dropout →
    Linear(hidden, C). Returns ``(logits, aux)``, aux the blocks' weighted
    load-balancing terms: train with ``make_train_step(...,
    has_aux_loss=True)``."""

    def __init__(self, spec: TAVSpec, moe: Optional[MoESpec] = None,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        super().__init__(spec, spec.fusion, "norm", dev)
        self.encoder = MoETransformerEncoder(
            spec.fusion, moe if moe is not None else MoESpec(), device=dev)
        self.classifier = Dense(spec.hidden, spec.output_dim,
                                dtype=spec.fusion.dtype, device=dev)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, aux = self.pooled(batch, rng, self.encoder)
        x = dropout(x, self.spec.dropout, self.training, rng)
        return self.classifier(x).float(), aux


FUSION_MODELS = {
    "MAE_encoder": TAVModel,        # the reference's default -m
    "TAVForMAE": TAVModel,
    "TAVFormer": TAVFormer,
    "TAVForMAE2Tower": TAVForMAETwoTower,
    "TAVForW2V2": TAVForW2V2,
    "TAVMoE": TAVMoEFormer,
}
