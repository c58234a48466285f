"""Text+Audio double model: a BERT ⊕ wav2vec2 late-fusion classifier.

Port of ``mme_tpu/models/text_audio.py`` (``TextAudioSpec``,
``BertAudioClassifier``): the text tower's pooled output ⊕ the
masked-mean-pooled wav2vec2 hidden states (through ``aud_proj`` to the
text width where the widths differ) → dropout → ``classifier``. The head
has no compute dtype in JAX, so flax promotes its input to the fp32 kernel:
here it computes in fp32 whatever the towers compute in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.models.audio import Wav2Vec2Model, Wav2Vec2Spec
from mme_tpu_torch.models.layers import Dense, EncoderSpec, dropout
from mme_tpu_torch.models.text import TextEncoder, TextEncoderSpec
from mme_tpu_torch.ops.audio import masked_mean_pool


def _small(e: EncoderSpec) -> EncoderSpec:
    return dataclasses.replace(e, hidden=32, heads=4, layers=2,
                               intermediate=64)


@dataclasses.dataclass(frozen=True)
class TextAudioSpec:
    text: TextEncoderSpec = dataclasses.field(
        default_factory=TextEncoderSpec.distilroberta)
    audio: Wav2Vec2Spec = dataclasses.field(default_factory=Wav2Vec2Spec.base)
    hidden: int = 768
    output_dim: int = 7
    dropout: float = 0.5

    def tiny(self) -> "TextAudioSpec":
        return dataclasses.replace(
            self,
            text=dataclasses.replace(self.text, vocab_size=101,
                                     encoder=_small(self.text.encoder)),
            audio=dataclasses.replace(self.audio, conv_dims=(8, 8, 8),
                                      conv_kernels=(10, 3, 3),
                                      conv_strides=(5, 2, 2),
                                      encoder=_small(self.audio.encoder)),
            hidden=32)


class BertAudioClassifier(nn.Module):
    """Token ids and their mask, waveform [B, T] and its keep-mask → logits
    [B, output_dim] in fp32. Dropout and SpecAugment draw from ``rng`` in
    training mode."""

    def __init__(self, spec: TextAudioSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.dropout = s.dropout
        text_h, audio_h = s.text.encoder.hidden, s.audio.encoder.hidden
        self.bert = TextEncoder(s.text, device=device)
        self.wav2vec2 = Wav2Vec2Model(s.audio, device=device)
        self.aud_proj = (Dense(audio_h, text_h, dtype=s.audio.encoder.dtype,
                               device=device)
                         if audio_h != text_h else None)
        self.classifier = Dense(2 * text_h, s.output_dim,
                                dtype=torch.float32, device=device)

    def forward(self, input_ids: torch.Tensor, text_mask: torch.Tensor,
                waveform: torch.Tensor, audio_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        _, pooled_text = self.bert(input_ids, text_mask, rng=rng)
        aud_hidden, _, feat_mask = self.wav2vec2(waveform, audio_mask,
                                                 rng=rng)
        if self.aud_proj is not None:
            aud_hidden = self.aud_proj(aud_hidden)
        x = torch.cat([pooled_text, masked_mean_pool(aud_hidden, feat_mask)],
                      dim=1)
        return self.classifier(dropout(x, self.dropout, self.training, rng))
