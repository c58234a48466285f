"""Text towers: the BERT/RoBERTa-style encoder with its tanh pooler, its
pooled-output classifier and the GloVe-LSTM classifier.

Port of ``mme_tpu/models/text.py``: ``TextEncoderSpec`` (RoBERTa's
pad-offset positions or BERT's ``arange`` ones), ``roberta_position_ids``,
``TextEmbeddings``, ``TextEncoder``, ``BertClassifier`` and
``LSTMClassifier``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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
    position_style: str = "roberta"  # "roberta" (pad-offset cumsum) | "bert"
    encoder: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=6, intermediate=3072,
        ln_style="post", ln_eps=1e-5, dropout=0.1))

    @staticmethod
    def distilroberta(**kw) -> "TextEncoderSpec":
        """'j-hartmann/emotion-english-distilroberta-base' architecture
        (hidden dropout 0.1 during training, the HF default)."""
        return TextEncoderSpec(**kw)

    @staticmethod
    def bert_base_cased(**kw) -> "TextEncoderSpec":
        return TextEncoderSpec(vocab_size=28996, max_positions=512,
                               type_vocab_size=2, pad_token_id=0,
                               position_style="bert",
                               encoder=EncoderSpec(hidden=768, heads=12,
                                                   layers=12,
                                                   intermediate=3072,
                                                   ln_style="post",
                                                   ln_eps=1e-12,
                                                   dropout=0.1), **kw)


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
        if self.spec.position_style == "roberta":
            pos_ids = roberta_position_ids(input_ids, self.spec.pad_token_id)
        else:
            pos_ids = torch.arange(input_ids.shape[-1],
                                   device=input_ids.device)[None, :]
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


class BertClassifier(nn.Module):
    """Pooled-output classifier: ``bert``'s tanh-pooled first token →
    dropout → ``classifier`` in the encoder's compute dtype."""

    def __init__(self, spec: TextEncoderSpec, output_dim: int,
                 dropout: float = 0.5, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.dropout = dropout
        self.bert = TextEncoder(spec, device=device)
        self.classifier = Dense(e.hidden, output_dim, dtype=e.dtype,
                                device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        _, pooled = self.bert(input_ids, attention_mask, rng=rng)
        return self.classifier(dropout(pooled, self.dropout, self.training,
                                       rng))


_GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` parameters: per gate i, f, g, o an input
    kernel ``i<gate>`` without bias and a hidden kernel ``h<gate>`` with
    bias (``if`` is a keyword, so the gates are registered by name)."""

    def __init__(self, in_features: int, hidden: int,
                 device: DeviceLike = "cuda"):
        super().__init__()
        for gate in _GATES:
            self.add_module(f"i{gate}", Dense(in_features, hidden,
                                              use_bias=False, device=device))
            self.add_module(f"h{gate}", Dense(hidden, hidden, device=device))

    def stacked(self) -> Tuple[torch.Tensor, ...]:
        """``torch.lstm``'s (w_ih [4H, in], w_hh [4H, H], b_ih, b_hh) in its
        gate order i, f, g, o, which is flax's: the input side has no
        bias, so ``b_ih`` is zero."""
        w_ih = torch.cat([getattr(self, f"i{g}").weight for g in _GATES])
        w_hh = torch.cat([getattr(self, f"h{g}").weight for g in _GATES])
        b_hh = torch.cat([getattr(self, f"h{g}").bias for g in _GATES])
        return w_ih, w_hh, torch.zeros_like(b_hh), b_hh


class LSTMClassifier(nn.Module):
    """GloVe-LSTM text classifier: ``embedding`` → ``num_layers`` LSTMs
    (cells ``OptimizedLSTMCell_<i>``, the names flax gives them; carry from
    zeros, every position run, padding included) → ``fc`` per token → mean
    over tokens → log-sigmoid, all in ``dtype``. The recurrence is
    ``torch.lstm`` (cuDNN's on the card) on the cells' stacked weights; the
    parameters stay the flax-named per-gate kernels."""

    def __init__(self, vocab_size: int, embed_dim: int = 300,
                 hidden_dim: int = 300, num_layers: int = 1,
                 output_dim: int = 7, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = Embed(vocab_size, embed_dim, dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", OptimizedLSTMCell(
                embed_dim if i == 0 else hidden_dim, hidden_dim,
                device=device))
        self.fc = Dense(hidden_dim, output_dim, dtype=dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(input_ids)
        for i in range(self.num_layers):
            weights = [w.to(x.dtype) for w in
                       getattr(self, f"OptimizedLSTMCell_{i}").stacked()]
            h0 = x.new_zeros((1, x.shape[0], weights[1].shape[1]))
            x = torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                           self.training, False, True)[0]
        return F.logsigmoid(self.fc(x).mean(dim=1))
