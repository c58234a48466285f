"""Video tower: VideoMAE (tubelet embedding + fixed sinusoid positions +
pre-LN encoder).

Port of ``mme_tpu/models/video.py`` (``VideoMAESpec``, ``TubeletEmbed``,
``VideoMAEModel``). Video arrives channels-last, [B, T, H, W, C]. The
classifiers, SlowR50 and the Conv3D net are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import Dense, EncoderSpec, TransformerEncoder
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
