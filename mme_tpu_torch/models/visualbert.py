"""VisualBERT: text+image fusion for Hateful Memes.

Port of ``mme_tpu/models/visualbert.py`` (``VisualBertSpec``,
``VisualBertEmbeddings``, ``VisualBertModel``, ``VisualBertForPreTraining``,
``VBertClassifier``):

- the embeddings add word, token-type and ``arange`` position rows for the
  text; the visual features go through ``visual_projection`` plus their own
  token-type rows (type 1 by default) and position rows (all position 0);
  one LayerNorm runs over the concatenated sequence, and the visual
  attention mask defaults to ones;
- the MLM head's decoder is tied to ``embeddings.word``: it multiplies by
  that very parameter (:attr:`VisualBertForPreTraining.decoder_weight`),
  so the table is one leaf whose gradient sums the lookup's and the
  decoder's parts; ``decoder_bias`` is the head's own parameter;
- ``VBertClassifier`` takes the mean of the [B, S+V, vocab] prediction
  logits over every position, padding included → dropout → ``linear``
  (vocab → 256) → sigmoid → dropout → ``final``.

The pooler is in the tree, as in flax, though the classifier never uses
it: its gradient is None (zero in JAX) and only weight decay moves it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import (Dense, Embed, EncoderSpec,
                                         TransformerEncoder, activation,
                                         dropout, empty_param)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class VisualBertSpec:
    vocab_size: int = 30522
    max_positions: int = 512
    type_vocab_size: int = 2
    visual_embedding_dim: int = 1024
    encoder: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=12, intermediate=3072,
        ln_style="post", ln_eps=1e-12))


class VisualBertEmbeddings(nn.Module):
    def __init__(self, spec: VisualBertSpec, device: DeviceLike = "cuda"):
        super().__init__()
        s, e = spec, spec.encoder
        self.dropout = e.dropout

        def emb(num):
            return Embed(num, e.hidden, e.dtype, device=device)

        self.word = emb(s.vocab_size)
        self.token_type = emb(s.type_vocab_size)
        self.position = emb(s.max_positions)
        self.visual_projection = Dense(s.visual_embedding_dim, e.hidden,
                                       dtype=e.dtype, device=device)
        self.visual_token_type = emb(s.type_vocab_size)
        self.visual_position = emb(s.max_positions)
        self.ln = FusedLayerNorm(e.hidden, e.ln_eps, e.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor],
                visual_embeds: Optional[torch.Tensor],
                visual_token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S = input_ids.shape
        dev = input_ids.device
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word(input_ids) + self.token_type(token_type_ids)
             + self.position(torch.arange(S, device=dev)[None, :]))
        if visual_embeds is not None:
            V = visual_embeds.shape[1]
            if visual_token_type_ids is None:
                visual_token_type_ids = torch.ones((B, V), dtype=torch.int64,
                                                   device=dev)
            v = (self.visual_projection(visual_embeds)
                 + self.visual_token_type(visual_token_type_ids)
                 + self.visual_position(torch.zeros((B, V), dtype=torch.int64,
                                                    device=dev)))
            x = torch.cat([x, v], dim=1)
        return dropout(self.ln(x), self.dropout, self.training, rng)


class VisualBertModel(nn.Module):
    """→ (sequence [B, S+V, hidden], tanh-pooled first token)."""

    def __init__(self, spec: VisualBertSpec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.embeddings = VisualBertEmbeddings(spec, device=device)
        self.encoder = TransformerEncoder(e, device=device)
        self.pooler = Dense(e.hidden, e.hidden, dtype=e.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                visual_embeds: Optional[torch.Tensor] = None,
                visual_attention_mask: Optional[torch.Tensor] = None,
                visual_token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids, token_type_ids, visual_embeds,
                            visual_token_type_ids, rng)
        bias = None
        if attention_mask is not None:
            full_mask = attention_mask
            if visual_embeds is not None:
                if visual_attention_mask is None:
                    visual_attention_mask = attention_mask.new_ones(
                        visual_embeds.shape[:2])
                full_mask = torch.cat([attention_mask, visual_attention_mask],
                                      dim=1)
            bias = additive_mask(full_mask)
        x = self.encoder(x, bias, rng)
        return x, torch.tanh(self.pooler(x[:, 0]))


class VisualBertForPreTraining(nn.Module):
    """The MLM head over ``visual_bert``: ``transform_dense`` → activation
    → ``transform_ln`` → the tied decoder plus ``decoder_bias``, giving the
    [B, S+V, vocab] ``prediction_logits``."""

    def __init__(self, spec: VisualBertSpec, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.visual_bert = VisualBertModel(spec, device=device)
        self.transform_dense = Dense(e.hidden, e.hidden, dtype=e.dtype,
                                     device=device)
        self.act = activation(e.act)
        self.transform_ln = FusedLayerNorm(e.hidden, e.ln_eps, e.dtype,
                                           device=device)
        self.decoder_bias = empty_param(spec.vocab_size,
                                        resolve_device(device))

    @property
    def decoder_weight(self) -> nn.Parameter:
        """The decoder's [vocab, hidden] weight: the word table itself."""
        return self.visual_bert.embeddings.word.weight

    def forward(self, input_ids: torch.Tensor, **kw) -> torch.Tensor:
        seq, _ = self.visual_bert(input_ids, **kw)
        h = self.transform_ln(self.act(self.transform_dense(seq)))
        return (torch.matmul(h, self.decoder_weight.to(h.dtype).t())
                + self.decoder_bias.to(h.dtype))


class VBertClassifier(nn.Module):
    def __init__(self, spec: VisualBertSpec, output_dim: int,
                 dropout: float = 0.5, device: DeviceLike = "cuda"):
        super().__init__()
        e = spec.encoder
        self.dropout = dropout
        self.vbert = VisualBertForPreTraining(spec, device=device)
        self.linear = Dense(spec.vocab_size, 256, dtype=e.dtype,
                            device=device)
        self.final = Dense(256, output_dim, dtype=e.dtype, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                visual_embeds: Optional[torch.Tensor] = None,
                visual_attention_mask: Optional[torch.Tensor] = None,
                visual_token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        logits = self.vbert(
            input_ids, attention_mask=attention_mask,
            token_type_ids=token_type_ids, visual_embeds=visual_embeds,
            visual_attention_mask=visual_attention_mask,
            visual_token_type_ids=visual_token_type_ids, rng=rng)
        x = dropout(logits.mean(dim=1), self.dropout, self.training, rng)
        x = torch.sigmoid(self.linear(x))
        return self.final(dropout(x, self.dropout, self.training, rng))
