"""``TAVModel``: the triple-modal emotion classifier, as the benchmark
measures and checks it.

- The plain float32 reference: github.com/g8a9/multi-modal-emotion's
  ``models/tav.py`` (``PreFormer`` and ``TAVForMAE``) with its published
  towers: DistilRoBERTa-base text, wav2vec2-large XLSR audio (layer-norm
  conv extractor, stable layer norm) and VideoMAE-base video, one conv
  extractor shared by the embedding stage and the audio tower. Departures
  from the published modules, each as the measured model has it: the video
  tower sees the patches the fusion trunk did not (the trunk keeps
  ``video_keep_k`` evenly strided ones); its sequence has no final
  LayerNorm; the four pooled heads each get a LayerNorm of eps 1e-6 before
  one classifier. Dropout and SpecAugment are off in the configuration, so
  the forward is deterministic.
- Its FLOPs and attention calls (``flops.py``'s arithmetic).
- The program: training through ``train/build_tav.py::build_tav`` (its
  model, state and ``train_step``) with the CLI's batch transform
  (``make_video_keep_transform``, ``--mask`` as the configuration says);
  serving through ``serve.py::Predictor`` over ``models/fusion.py::
  TAVModel`` with the weights loaded.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import flops
from harness import program
from reference.layers import (Embedding, Encoder, LayerNorm, Linear, empty,
                              key_bias, masked_mean)
from reference.towers import (ConvStack, FeatureProjection, PosConv,
                              TextEmbeddings, TextEncoder, VideoMAE,
                              Wav2Vec2, conv_lengths, normalize_video,
                              num_patches, strided_keep)


class PreFormer(nn.Module):
    """The embedding-stage fuser: [text embeddings | projected audio
    features with conv positions | kept video patches]."""

    def __init__(self, c: dict, device=None):
        super().__init__()
        a = c["audio"]
        h_a = a["encoder"]["hidden"]
        self.masked_spec_embed = empty(h_a, device=device)
        self.text_embeddings = TextEmbeddings(c["text"], device)
        self.feature_projection = FeatureProjection(a, device)
        self.pos_conv = PosConv(a, device)
        self.audio_ln = LayerNorm(h_a, a["encoder"]["ln_eps"], device)
        self.wav_to_hidden = Linear(h_a, c["hidden"], device=device)
        self.video = VideoMAE(c["video"], encoder=False, device=device)

    def forward(self, ids, text_mask, feats, feat_mask, video, keep, k):
        t = self.text_embeddings(ids)
        a = self.feature_projection(feats) * feat_mask[..., None].float()
        a = self.wav_to_hidden(self.audio_ln(a + self.pos_conv(a)))
        v = self.video.embed(video, keep, k)
        B = ids.shape[0]
        types = torch.cat([
            torch.zeros(B, t.shape[1], dtype=torch.long, device=t.device),
            torch.ones(B, a.shape[1], dtype=torch.long, device=t.device),
            torch.full((B, v.shape[1]), 2, dtype=torch.long,
                       device=t.device)], dim=1)
        fused_keep = torch.cat([text_mask.long(), feat_mask.long(),
                                torch.ones(B, v.shape[1], dtype=torch.long,
                                           device=t.device)], dim=1)
        return torch.cat([t, a, v], dim=1), types, fused_keep


class TAVForMAE(nn.Module):
    def __init__(self, c: dict, device=None):
        super().__init__()
        h = c["hidden"]
        self.modality_embedding = Embedding(3, h, device)
        self.text_encoder = TextEncoder(c["text"], device)
        self.wav2vec2 = Wav2Vec2(c["audio"], device)
        self.wav_to_hidden = Linear(c["audio"]["encoder"]["hidden"], h,
                                    device=device)
        self.videomae = VideoMAE(c["video"], device=device)
        self.fusion_encoder = Encoder(c["fusion"], device)
        for name in ("text_norm", "fusion_norm", "audio_norm", "video_norm"):
            self.add_module(name, LayerNorm(h, 1e-6, device))
        self.classifier = Linear(4 * h, c["output_dim"], device=device)



class TAV(nn.Module):
    """PreFormer + TAVForMAE over one shared conv extractor. ``forward``
    takes the benchmark's batch dict and returns fp32 logits."""

    def __init__(self, c: dict, device=None):
        super().__init__()
        if not c["share_audio_frontend"]:
            raise ValueError("the reference has the shared extractor only")
        self.c = c
        self.preformer = PreFormer(c, device)
        self.model = TAVForMAE(c, device)
        self.audio_frontend = ConvStack(c["audio"], device)

    def forward(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        c, m = self.c, self.model
        a, v = c["audio"], c["video"]
        n, k = num_patches(v), c["video_keep_k"]
        ids, text_mask = b["input_ids"].long(), b["text_mask"]
        video = normalize_video(b["video"])
        keep = strided_keep(ids.shape[0], n, k, ids.device)
        feats = self.audio_frontend(b["waveform"].float())
        lengths = conv_lengths(b["audio_mask"].long().sum(-1),
                               a["conv_kernels"], a["conv_strides"])
        feat_mask = (torch.arange(feats.shape[1], device=ids.device)[None]
                     < lengths[:, None]).long()

        fused, types, fused_keep = self.preformer(
            ids, text_mask, feats, feat_mask, video, keep, k)
        av = fused + m.modality_embedding(types)
        aud = masked_mean(m.wav_to_hidden(m.wav2vec2(feats, feat_mask)),
                          feat_mask)
        vid = m.videomae(video, ~keep, n - k).mean(dim=1)
        text = m.text_encoder(ids, text_mask)
        av = m.fusion_encoder(av, key_bias(fused_keep))
        av = m.fusion_norm(masked_mean(av, fused_keep))
        x = torch.cat([av, m.text_norm(text), m.audio_norm(aud),
                       m.video_norm(vid)], dim=1)
        return m.classifier(x)



def reference(c: dict, device=None) -> nn.Module:
    return TAV(c, device=device)


# FLOPs


def shapes(c: dict) -> Dict[str, int]:
    """The sequence lengths fed: text, audio frames, the video tower's
    tokens (those the trunk did not keep) and the fusion trunk's."""
    inp, a = c["inputs"], c["audio"]
    audio = flops.conv_lengths(inp["audio_samples"], a["conv_kernels"],
                               a["conv_strides"])[-1]
    k = c["video_keep_k"]
    return {"text": inp["text_len"], "audio": audio,
            "video": flops.num_patches(c["video"]) - k,
            "fusion": inp["text_len"] + audio + k}


def forward_flops(c: dict, batch: int) -> int:
    a, v, f = c["audio"], c["video"], c["fusion"]
    s = shapes(c)
    ha = a["encoder"]["hidden"]
    lengths = flops.conv_lengths(c["inputs"]["audio_samples"],
                                 a["conv_kernels"], a["conv_strides"])
    convs, c_in = 0, 1
    for c_out, k, n in zip(a["conv_dims"], a["conv_kernels"], lengths):
        convs += flops.conv1d(batch, n, c_in, c_out, k)
        c_in = c_out
    frames = batch * s["audio"]
    proj = flops.linear(frames, a["conv_dims"][-1], ha)
    pos = flops.conv1d(batch, s["audio"], ha, ha,
                       a["num_conv_pos_embeddings"],
                       a["num_conv_pos_embedding_groups"])
    to_hidden = flops.linear(frames, ha, c["hidden"])
    preformer = proj + pos + to_hidden + flops.patch_embed(v, batch)
    audio = (proj + pos + a["encoder"]["layers"]
             * flops.encoder_layer(batch, s["audio"], a["encoder"])
             + to_hidden)
    video = flops.video_tower(v, batch, s["video"])
    fusion = f["layers"] * flops.encoder_layer(batch, s["fusion"], f)
    head = flops.linear(batch, 4 * c["hidden"], c["output_dim"])
    return (convs + preformer + audio + video + fusion
            + flops.text_tower(c, batch, s["text"]) + head)


def attention_sites(c: dict, batch: int):
    s = shapes(c)
    return (flops.encoder_sites(c["text"]["encoder"], batch, s["text"], True)
            + flops.encoder_sites(c["video"]["encoder"], batch, s["video"],
                                  False)
            + flops.encoder_sites(c["audio"]["encoder"], batch, s["audio"],
                                  True)
            + flops.encoder_sites(c["fusion"], batch, s["fusion"], True))


# the program


def spec(c: dict):
    from mme_tpu_torch.models.audio import Wav2Vec2Spec
    from mme_tpu_torch.models.fusion import TAVSpec
    a = c["audio"]
    enc = program.encoder_spec
    audio = Wav2Vec2Spec(
        conv_dims=tuple(a["conv_dims"]),
        conv_kernels=tuple(a["conv_kernels"]),
        conv_strides=tuple(a["conv_strides"]), conv_bias=a["conv_bias"],
        feat_extract_norm=a["feat_extract_norm"],
        do_stable_layer_norm=a["do_stable_layer_norm"],
        num_conv_pos_embeddings=a["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=a["num_conv_pos_embedding_groups"],
        mask_time_prob=a["mask_time_prob"], mask_feature_prob=0.0,
        encoder=enc(a["encoder"]))
    out = TAVSpec(text=program.text_spec(c["text"]), audio=audio,
                  video=program.video_spec(c["video"]),
                  fusion=enc(c["fusion"]), hidden=c["hidden"],
                  output_dim=c["output_dim"], dropout=c["head_dropout"],
                  learn_pos_embeddings=c["learn_pos_embeddings"],
                  video_keep_k=c["video_keep_k"],
                  share_audio_frontend=c["share_audio_frontend"])
    if program.compute_dtype(c) != torch.float32:
        out = out.with_compute_dtype(program.compute_dtype(c))
    return out


def transform(c: dict):
    """The CLI's batch transform: the trunk's video keep-mask."""
    from mme_tpu_torch.train.build_tav import make_video_keep_transform
    return make_video_keep_transform(
        spec(c), random_mask=c["inputs"].get("mask", False))


def port(c: dict, device, weights=None) -> nn.Module:
    """The program's model, which takes the batch after ``transform``,
    with ``weights`` (the reference's names) loaded where given."""
    from mme_tpu_torch.models.fusion import TAVModel
    model = TAVModel(spec(c), device=device)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


def build_trainer(c: dict, weights, flat, seed: int, batch: int,
                  device) -> program.Trainer:
    program.clean_env(c)
    from mme_tpu_torch.train.build_tav import build_tav
    from harness.weights import flax_tree
    cfg = program.experiment(c, seed, batch)
    model, state, step, _ = build_tav(
        spec(c), cfg, steps_per_epoch=c["optimizer"]["steps_per_epoch"],
        params=flax_tree(c, weights, flat), remat=c["remat"],
        use_accum=False, device=device)
    names = program.checked_names(
        [n for n, _ in model.named_parameters()], weights)
    return program.Trainer(model, state, step, transform(c), names,
                           c["optimizer"]["b1"])


def build_predictor(c: dict, weights, batch: int, device):
    """(``Predictor``, the predict path's batch transform)."""
    from mme_tpu_torch.serve import Predictor
    program.clean_env(c)
    return (Predictor(port(c, device, weights), batch_size=batch,
                      device=device), transform(c))
