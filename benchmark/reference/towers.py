"""The plain float32 towers the benchmark's models are assembled from
(each model's assembly is in ``benchmark/models/<model>.py``):
DistilRoBERTa-style text (``TextEncoder``), wav2vec2 audio (``ConvStack``,
``FeatureProjection``, ``PosConv``, ``Wav2Vec2``) and VideoMAE video
(``VideoMAE``), with the input helpers they share and the naming of
parameters by kind that the weights are drawn by.

Inputs are the benchmark's own arrays: token ids and their keep-mask, the
waveform and its keep-mask, uint8 video [B, T, H, W, 3] (ImageNet
normalised here) or float video, and labels.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from reference.layers import (Conv1d, Embedding, Encoder, LayerNorm, Linear,
                              empty, gelu, key_bias)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, H, W, C] → ImageNet-normalised float32; an all-zero
    frame (padding) stays exactly 0. Float video passes through."""
    if video.dtype != torch.uint8:
        return video.float()
    valid = video.reshape(video.shape[0], video.shape[1], -1).amax(-1) > 0
    mean = torch.tensor(IMAGENET_MEAN, device=video.device)
    std = torch.tensor(IMAGENET_STD, device=video.device)
    return ((video.float() / 255.0 - mean) / std) * valid[..., None, None,
                                                          None]


def strided_keep(batch: int, n: int, k: int, device) -> torch.Tensor:
    """[batch, n] bool, ``k`` evenly strided positions kept per row:
    floor(i · n/k) for i < k, in float32."""
    idx = torch.floor(torch.arange(k, dtype=torch.float32, device=device)
                      * (n / k)).long()
    row = torch.zeros(n, dtype=torch.bool, device=device)
    row[idx] = True
    return row.expand(batch, n)


def conv_lengths(lengths: torch.Tensor, kernels, strides) -> torch.Tensor:
    for k, s in zip(kernels, strides):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


def sinusoid_table(n: int, d: int) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    dim = torch.arange(d, dtype=torch.float64)[None, :]
    angle = pos / torch.pow(10000.0, 2 * torch.div(dim, 2,
                                                   rounding_mode="floor") / d)
    table = torch.where(dim.long() % 2 == 0, torch.sin(angle),
                        torch.cos(angle))
    return table.float()


class TextEmbeddings(nn.Module):
    """word + RoBERTa position (pad-offset count of the real tokens) +
    token type 0, then LayerNorm."""

    def __init__(self, t: dict, device=None):
        super().__init__()
        e = t["encoder"]
        self.pad = t["pad_token_id"]
        self.word = Embedding(t["vocab_size"], e["hidden"], device)
        self.position = Embedding(t["max_positions"], e["hidden"], device)
        self.token_type = Embedding(t["type_vocab_size"], e["hidden"],
                                    device)
        self.ln = LayerNorm(e["hidden"], e["ln_eps"], device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        real = (ids != self.pad).long()
        pos = torch.cumsum(real, dim=-1) * real + self.pad
        x = (self.word(ids) + self.position(pos)
             + self.token_type(torch.zeros_like(ids)))
        return self.ln(x)


class TextEncoder(nn.Module):
    def __init__(self, t: dict, device=None):
        super().__init__()
        h = t["encoder"]["hidden"]
        self.embeddings = TextEmbeddings(t, device)
        self.encoder = Encoder(t["encoder"], device)
        self.pooler = Linear(h, h, device=device)

    def forward(self, ids, mask) -> torch.Tensor:
        """The tanh-pooled first token."""
        x = self.encoder(self.embeddings(ids), key_bias(mask))
        return torch.tanh(self.pooler(x[:, 0]))


class ConvStack(nn.Module):
    """wav2vec2's conv extractor, layer-norm flavour: per conv (with bias)
    a LayerNorm over channels and exact GELU. [B, T] → [B, F, C]."""

    def __init__(self, a: dict, device=None):
        super().__init__()
        if a["feat_extract_norm"] != "layer":
            raise ValueError("the reference has the layer-norm extractor only")
        self.n = len(a["conv_dims"])
        c_in = 1
        for i, (c, k, s) in enumerate(zip(a["conv_dims"], a["conv_kernels"],
                                          a["conv_strides"])):
            self.add_module(f"conv_{i}", Conv1d(c_in, c, k, s,
                                                bias=a["conv_bias"],
                                                device=device))
            self.add_module(f"ln_{i}", LayerNorm(c, 1e-5, device))
            c_in = c

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        x = wave[..., None]
        for i in range(self.n):
            x = gelu(getattr(self, f"ln_{i}")(getattr(self, f"conv_{i}")(x)))
        return x


class FeatureProjection(nn.Module):
    def __init__(self, a: dict, device=None):
        super().__init__()
        e = a["encoder"]
        self.ln = LayerNorm(a["conv_dims"][-1], e["ln_eps"], device)
        self.projection = Linear(a["conv_dims"][-1], e["hidden"],
                                 device=device)

    def forward(self, feats):
        return self.projection(self.ln(feats))


class PosConv(nn.Module):
    """Grouped conv positional embedding, padded k//2 a side, an even k
    trimming the last frame, then GELU."""

    def __init__(self, a: dict, device=None):
        super().__init__()
        h, k = a["encoder"]["hidden"], a["num_conv_pos_embeddings"]
        self.trim = k % 2 == 0
        self.conv = Conv1d(h, h, k, 1, k // 2,
                           a["num_conv_pos_embedding_groups"], device=device)

    def forward(self, x):
        y = self.conv(x)
        return gelu(y[:, :-1] if self.trim else y)


class Wav2Vec2Encoder(nn.Module):
    def __init__(self, a: dict, device=None):
        super().__init__()
        if not a["do_stable_layer_norm"]:
            raise ValueError("the reference has the stable-layer-norm "
                             "encoder only")
        self.pos_conv = PosConv(a, device)
        self.layers = Encoder(a["encoder"], device)

    def forward(self, h, feat_mask):
        h = h * feat_mask[..., None].float()
        return self.layers(h + self.pos_conv(h), key_bias(feat_mask))


class Wav2Vec2(nn.Module):
    """The audio tower over features of the shared extractor."""

    def __init__(self, a: dict, device=None):
        super().__init__()
        self.masked_spec_embed = empty(a["encoder"]["hidden"], device=device)
        self.feature_projection = FeatureProjection(a, device)
        self.encoder = Wav2Vec2Encoder(a, device)

    def forward(self, feats, feat_mask):
        return self.encoder(self.feature_projection(feats), feat_mask)


class TubeletEmbed(nn.Module):
    """Non-overlapping (t, p, p) patches, each a vector ordered (t, p_h,
    p_w, C), through one Linear; tokens in (t', h', w') order."""

    def __init__(self, v: dict, device=None):
        super().__init__()
        self.t, self.p = v["tubelet_size"], v["patch_size"]
        self.proj = Linear(self.t * self.p ** 2 * v["channels"],
                           v["encoder"]["hidden"], device=device)

    def forward(self, video):
        B, T, H, W, C = video.shape
        t, p = self.t, self.p
        x = video.reshape(B, T // t, t, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            B, (T // t) * (H // p) * (W // p), t * p * p * C)
        return self.proj(x)


def num_patches(v: dict) -> int:
    side = v["image_size"] // v["patch_size"]
    return (v["num_frames"] // v["tubelet_size"]) * side * side


def take(x: torch.Tensor, keep: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` kept tokens of each row of x [B, N, D], in order."""
    idx = torch.stack([torch.nonzero(r, as_tuple=True)[0][:k] for r in keep])
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class VideoMAE(nn.Module):
    """Tubelet embedding + fixed sinusoid positions (+ the pre-LN encoder
    unless ``encoder=False``)."""

    def __init__(self, v: dict, encoder: bool = True, device=None):
        super().__init__()
        self.patch_embed = TubeletEmbed(v, device)
        self.encoder = Encoder(v["encoder"], device) if encoder else None
        self.register_buffer("pos", sinusoid_table(
            num_patches(v), v["encoder"]["hidden"]).to(device),
            persistent=False)

    def embed(self, video, keep=None, k=None):
        x = self.patch_embed(video) + self.pos
        return x if keep is None else take(x, keep, k)

    def forward(self, video, keep=None, k=None):
        return self.encoder(self.embed(video, keep, k))


def param_kinds(model: nn.Module) -> Dict[str, str]:
    """Each parameter's name → what it is: ``linear``, ``qkv``,
    ``embedding``, ``conv`` and ``norm`` weights, ``bias`` and ``vector``
    (a bare parameter such as ``masked_spec_embed``)."""
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "weight":
                kinds[name] = getattr(mod, "KIND", "linear")
            elif pname.endswith("bias"):
                kinds[name] = "bias"
            else:
                kinds[name] = "vector"
    return kinds


def attention_heads(model: nn.Module) -> Dict[str, tuple]:
    """qkv weight name → (heads, head_dim)."""
    from reference.layers import Attention
    return {f"{n}.qkv.weight": (m.heads, m.head_dim)
            for n, m in model.named_modules() if isinstance(m, Attention)}

