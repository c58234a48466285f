"""Text tower: the BERT/RoBERTa-style encoder with its tanh pooler.

Port of ``mme_tpu/models/text.py`` (``TextEncoderSpec``,
``roberta_position_ids``, ``TextEmbeddings``, ``TextEncoder``) for the
RoBERTa family. BERT-style positions, the classifier heads and the
GloVe-LSTM are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.models.layers import (Dense, Embed, EncoderSpec,
                                         TransformerEncoder, dropout)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class TextEncoderSpec:
    vocab_size: int = 50265
    max_positions: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    encoder: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=6, intermediate=3072,
        ln_style="post", ln_eps=1e-5, dropout=0.1))

    @staticmethod
    def distilroberta(**kw) -> "TextEncoderSpec":
        """'j-hartmann/emotion-english-distilroberta-base' architecture
        (hidden dropout 0.1 during training, the HF default)."""
        return TextEncoderSpec(**kw)


def roberta_position_ids(input_ids: torch.Tensor,
                         pad_token_id: int) -> torch.Tensor:
    """RoBERTa's pad-aware position ids: non-pad tokens are numbered 1..n
    from the left, offset by the pad id."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


class TextEmbeddings(nn.Module):
    def __init__(self, spec: TextEncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s, e = spec, spec.encoder
        self.spec = spec
        self.word = Embed(s.vocab_size, e.hidden, e.dtype, device=device)
        self.position = Embed(s.max_positions, e.hidden, e.dtype,
                              device=device)
        self.token_type = Embed(s.type_vocab_size, e.hidden, e.dtype,
                                device=device)
        self.ln = FusedLayerNorm(e.hidden, e.ln_eps, e.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        pos_ids = roberta_position_ids(input_ids, self.spec.pad_token_id)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word(input_ids) + self.position(pos_ids)
             + self.token_type(token_type_ids))
        return dropout(self.ln(x), self.spec.encoder.dropout, self.training,
                       rng)


class TextEncoder(nn.Module):
    """BERT-family encoder returning (sequence_output, pooled_output)."""

    def __init__(self, spec: TextEncoderSpec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.embeddings = TextEmbeddings(spec, device=device)
        self.encoder = TransformerEncoder(e, device=device)
        self.pooler = Dense(e.hidden, e.hidden, dtype=e.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids, token_type_ids, rng)
        bias = None if attention_mask is None else additive_mask(
            attention_mask)
        x = self.encoder(x, bias, rng)
        return x, torch.tanh(self.pooler(x[:, 0]))
