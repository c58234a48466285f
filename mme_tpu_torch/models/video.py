"""Video towers: VideoMAE (tubelet embedding + fixed sinusoid positions +
pre-LN encoder), the slow-pathway 3-D ResNet-50 and the scratch Conv3D net.

Port of ``mme_tpu/models/video.py`` (``VideoMAESpec``, ``TubeletEmbed``,
``VideoMAEModel``, ``VideoMAEClassifier``, ``Conv3DClassifier``,
``Bottleneck3D``, ``SlowR50``). Video arrives channels-last,
[B, T, H, W, C]; the conv nets run channels-first inside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import (Conv, Dense, EncoderSpec,
                                         TransformerEncoder, dropout)
from mme_tpu_torch.models.norm import BatchNorm
from mme_tpu_torch.ops.video import gather_visible, sinusoid_position_table


@dataclasses.dataclass(frozen=True)
class VideoMAESpec:
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    tubelet_size: int = 2
    channels: int = 3
    encoder: EncoderSpec = dataclasses.field(default_factory=lambda: EncoderSpec(
        hidden=768, heads=12, layers=12, intermediate=3072,
        ln_style="pre", qkv_bias="qv", ln_eps=1e-12))

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return (self.num_frames // self.tubelet_size) * side * side  # 1568

    @staticmethod
    def base(**kw) -> "VideoMAESpec":
        return VideoMAESpec(**kw)


class TubeletEmbed(nn.Module):
    """Non-overlapping (t, p, p) patch embedding: HF's Conv3d with kernel ==
    stride, applied as one matmul. ``proj.weight`` is flax's
    [(t·p·p·C), hidden] kernel transposed, so the patch vector is ordered
    (t, p_h, p_w, C); tokens come out in (t′, h′, w′) order."""

    def __init__(self, spec: VideoMAESpec, device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.spec = spec
        self.proj = Dense(s.tubelet_size * s.patch_size ** 2 * s.channels,
                          s.encoder.hidden, dtype=s.encoder.dtype,
                          device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = video.shape
        t, p = self.spec.tubelet_size, self.spec.patch_size
        x = video.to(self.proj.dtype).reshape(
            B, T // t, t, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            B, (T // t) * (H // p) * (W // p), t * p * p * C)
        return self.proj(x)


class VideoMAEModel(nn.Module):
    """VideoMAE encoder. ``visible_mask`` (keep=True, exactly ``keep_k`` per
    row) selects tokens before the encoder.

    ``with_encoder=False`` builds the embedding stage alone: the PreFormer
    only ever calls :meth:`embed`, so its flax tree holds ``patch_embed``
    and no encoder."""

    def __init__(self, spec: VideoMAESpec, with_encoder: bool = True,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.patch_embed = TubeletEmbed(spec, device=dev)
        self.encoder = (TransformerEncoder(spec.encoder, device=dev)
                        if with_encoder else None)
        self.register_buffer(
            "pos", torch.from_numpy(sinusoid_position_table(
                spec.num_patches, spec.encoder.hidden)).to(dev),
            persistent=False)

    def embed(self, video: torch.Tensor,
              visible_mask: Optional[torch.Tensor] = None,
              keep_k: Optional[int] = None) -> torch.Tensor:
        """Embedding stage only (the PreFormer video path)."""
        x = self.patch_embed(video)
        x = x + self.pos.to(x.dtype)
        if visible_mask is not None:
            if keep_k is None:
                raise ValueError("a visible_mask needs its static keep_k")
            x = gather_visible(x, visible_mask, keep_k)
        return x

    def forward(self, video: torch.Tensor,
                visible_mask: Optional[torch.Tensor] = None,
                keep_k: Optional[int] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(self.embed(video, visible_mask, keep_k), None,
                            rng)


class VideoMAEClassifier(nn.Module):
    """Mean-pool classifier over VideoMAE features: ``videomae`` → mean
    over tokens → dropout → ``classifier`` in the encoder's compute
    dtype."""

    def __init__(self, spec: VideoMAESpec, output_dim: int,
                 dropout: float = 0.5, device: DeviceLike = "cuda"):
        super().__init__()
        self.dropout = dropout
        self.videomae = VideoMAEModel(spec, device=device)
        self.classifier = Dense(spec.encoder.hidden, output_dim,
                                dtype=spec.encoder.dtype, device=device)

    def forward(self, video: torch.Tensor,
                visible_mask: Optional[torch.Tensor] = None,
                keep_k: Optional[int] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.videomae(video, visible_mask, keep_k, rng)
        return self.classifier(dropout(h.mean(dim=1), self.dropout,
                                       self.training, rng))


class Conv3DClassifier(nn.Module):
    """Scratch 3-D ConvNet: per width a 3×3×3 conv with bias, stride
    (1, 2, 2) and flax's ``"SAME"`` padding (an even side pads (0, 1), not
    (1, 1)) → relu → (1, 2, 2) max-pool; then the mean over (T, H, W) →
    ``fc1`` (256) → relu → dropout 0.5 → ``fc2``."""

    def __init__(self, output_dim: int,
                 widths: Sequence[int] = (32, 64, 128),
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.n_convs = len(widths)
        in_dim = 3
        for i, w in enumerate(widths):
            self.add_module(f"conv_{i}", Conv(in_dim, w, (3, 3, 3),
                                              (1, 2, 2), "SAME", dtype=dtype,
                                              device=device))
            in_dim = w
        self.fc1 = Dense(in_dim, 256, dtype=dtype, device=device)
        self.fc2 = Dense(256, output_dim, dtype=dtype, device=device)

    def forward(self, video: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = video.movedim(-1, 1)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
        x = F.relu(self.fc1(x.mean(dim=(2, 3, 4))))
        return self.fc2(dropout(x, 0.5, self.training, rng))


class Bottleneck3D(nn.Module):
    """Slow-pathway bottleneck: (tk, 1, 1) → (1, 3, 3) with the spatial
    stride → (1, 1, 1) to ``4·features``, each conv without bias and
    followed by a BatchNorm; ``downsample`` adds the strided ``down_conv``
    / ``down_bn`` on the residual. Channels-first."""

    def __init__(self, in_dim: int, features: int, temporal_kernel: int = 1,
                 strides: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        bn = dict(dtype=dtype, device=device)
        tk, out = temporal_kernel, features * 4
        self.conv1 = Conv(in_dim, features, (tk, 1, 1),
                          padding=[(tk // 2, tk // 2), (0, 0), (0, 0)], **kw)
        self.bn1 = BatchNorm(features, **bn)
        self.conv2 = Conv(features, features, (1, 3, 3),
                          (1, strides, strides),
                          [(0, 0), (1, 1), (1, 1)], **kw)
        self.bn2 = BatchNorm(features, **bn)
        self.conv3 = Conv(features, out, (1, 1, 1), **kw)
        self.bn3 = BatchNorm(out, **bn)
        if downsample:
            self.down_conv = Conv(in_dim, out, (1, 1, 1),
                                  (1, strides, strides), **kw)
            self.down_bn = BatchNorm(out, **bn)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = (x if self.down_conv is None
                    else self.down_bn(self.down_conv(x)))
        return F.relu(y + residual)


class SlowR50(nn.Module):
    """Slow-pathway 3-D ResNet-50: a 1×7×7 / (1, 2, 2) stem with its
    BatchNorm, the -inf padded (1, 3, 3) / (1, 2, 2) max-pool, four
    bottleneck stages with temporal kernels (1, 1, 3, 3), the mean over
    (T, H, W) → ``proj`` → relu → ``classifier``. ``features_only`` returns
    the pooled [B, 2048]."""

    def __init__(self, output_dim: int, proj_dim: int = 768,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 temporal_kernels: Sequence[int] = (1, 1, 3, 3),
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.stem_conv = Conv(3, 64, (1, 7, 7), (1, 2, 2),
                              [(0, 0), (3, 3), (3, 3)], use_bias=False,
                              dtype=dtype, device=dev)
        self.stem_bn = BatchNorm(64, dtype=dtype, device=dev)
        self.blocks = []
        in_dim = 64
        for stage, (blocks, w, tk) in enumerate(zip(
                stage_sizes, (64, 128, 256, 512), temporal_kernels)):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck3D(
                    in_dim, w, tk, 2 if (stage > 0 and b == 0) else 1,
                    downsample=b == 0, dtype=dtype, device=dev))
                self.blocks.append(name)
                in_dim = w * 4
        self.proj = Dense(in_dim, proj_dim, dtype=dtype, device=dev)
        self.classifier = Dense(proj_dim, output_dim, dtype=dtype,
                                device=dev)

    def forward(self, video: torch.Tensor,
                rng: Optional[torch.Generator] = None,
                features_only: bool = False) -> torch.Tensor:
        y = F.relu(self.stem_bn(self.stem_conv(video.movedim(-1, 1))))
        y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2), padding=(0, 1, 1))
        for name in self.blocks:
            y = getattr(self, name)(y)
        pooled = y.mean(dim=(2, 3, 4))
        if features_only:
            return pooled
        return self.classifier(F.relu(self.proj(pooled)))
