"""Text+Video double models: the shared-layer multi-task model and the
late-fusion model.

Port of ``mme_tpu/models/text_video.py`` (``TextVideoSpec``,
``SharedEmbedText``, ``SharedEmbedVideo``, ``BertVideoMAEMTLShared``,
``BertVideoMAELateFusion``):

- ``BertVideoMAEMTLShared``: ONE ``shared_layer`` (Linear(hidden, hidden))
  applied after both towers' embedding stages. The model owns it at the top
  of its tree and hands it to the towers' ``forward``, so it is one set of
  weights under one name. Both towers always run; ``task_id`` (0-d, or [B])
  selects per row the text task (0: the pooled BERT output) or the video
  task (1: ``fc_norm`` of the mean-pooled VideoMAE tokens) by a select, so
  the unselected tower's gradients are exactly zero. Shared dropout, then
  ``classifier``.
- ``BertVideoMAELateFusion``: the pooled BERT output ⊕ ``fc_norm`` of the
  mean-pooled VideoMAE tokens → dropout → ``classifier``.

``fc_norm`` is flax's default ``FusedLayerNorm()``: eps 1e-6 and fp32
output, over B rows (the plain path). ``classifier`` has no compute dtype
in JAX, so it computes in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.models.layers import Dense, EncoderSpec, dropout
from mme_tpu_torch.models.text import TextEncoder, TextEncoderSpec
from mme_tpu_torch.models.video import VideoMAEModel, VideoMAESpec
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


def _small(e: EncoderSpec) -> EncoderSpec:
    return dataclasses.replace(e, hidden=32, heads=4, layers=2,
                               intermediate=64)


@dataclasses.dataclass(frozen=True)
class TextVideoSpec:
    text: TextEncoderSpec = dataclasses.field(
        default_factory=TextEncoderSpec.distilroberta)
    video: VideoMAESpec = dataclasses.field(default_factory=VideoMAESpec.base)
    hidden: int = 768
    output_dim: int = 7
    dropout: float = 0.5

    def tiny(self) -> "TextVideoSpec":
        return dataclasses.replace(
            self,
            text=dataclasses.replace(self.text, vocab_size=101,
                                     encoder=_small(self.text.encoder)),
            video=dataclasses.replace(self.video, image_size=32, patch_size=8,
                                      num_frames=4,
                                      encoder=_small(self.video.encoder)),
            hidden=32)


class SharedEmbedText(TextEncoder):
    """The text encoder with the shared layer after its embeddings (no
    token types, the mask always applied); returns the pooled output."""

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                shared: nn.Module, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = shared(self.embeddings(input_ids, None, rng))
        x = self.encoder(x, additive_mask(attention_mask), rng)
        return torch.tanh(self.pooler(x[:, 0]))


class SharedEmbedVideo(VideoMAEModel):
    """VideoMAE with the shared layer after its patch and position
    embedding; returns the encoder's tokens."""

    def forward(self, video: torch.Tensor, shared: nn.Module,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(shared(self.embed(video)), None, rng)


class BertVideoMAEMTLShared(nn.Module):
    def __init__(self, spec: TextVideoSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.dropout = s.dropout
        self.shared_layer = Dense(s.text.encoder.hidden, s.hidden,
                                  dtype=s.text.encoder.dtype, device=device)
        self.bert = SharedEmbedText(s.text, device=device)
        self.videomae = SharedEmbedVideo(s.video, device=device)
        self.fc_norm = FusedLayerNorm(s.video.encoder.hidden, device=device)
        self.classifier = Dense(s.hidden, s.output_dim, dtype=torch.float32,
                                device=device)

    def forward(self, input_ids: torch.Tensor, text_mask: torch.Tensor,
                video: torch.Tensor, task_id: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        text_pooled = self.bert(input_ids, text_mask, self.shared_layer, rng)
        vid_hidden = self.videomae(video, self.shared_layer, rng)
        vid_pooled = self.fc_norm(vid_hidden.mean(dim=1))
        is_text = task_id == 0
        if is_text.dim():
            is_text = is_text[..., None]
        out = torch.where(is_text, text_pooled, vid_pooled)
        return self.classifier(dropout(out, self.dropout, self.training, rng))


class BertVideoMAELateFusion(nn.Module):
    def __init__(self, spec: TextVideoSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.dropout = s.dropout
        self.bert = TextEncoder(s.text, device=device)
        self.videomae = VideoMAEModel(s.video, device=device)
        self.fc_norm = FusedLayerNorm(s.video.encoder.hidden, device=device)
        self.classifier = Dense(s.text.encoder.hidden
                                + s.video.encoder.hidden, s.output_dim,
                                dtype=torch.float32, device=device)

    def forward(self, input_ids: torch.Tensor, text_mask: torch.Tensor,
                video: torch.Tensor, task_id: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        _, pooled = self.bert(input_ids, text_mask, rng=rng)
        vid = self.fc_norm(self.videomae(video, rng=rng).mean(dim=1))
        x = torch.cat([pooled, vid], dim=1)
        return self.classifier(dropout(x, self.dropout, self.training, rng))
