"""Image towers: ResNet-50 (v1.5) and the scratch ConvNet.

Port of ``mme_tpu/models/image.py``: ``Bottleneck``, ``ResNet50``,
``ResnetClassifier``, ``ConvNetClassifier`` and ``ResNetFeatureExtractor``.
Images arrive channels-last, [B, H, W, C], as in JAX; the modules run
channels-first inside (cuDNN's layout) and flatten or pool back in JAX's
order. The BatchNorms are ``models/norm.py``'s flax-semantics ones:
``.train()`` normalises with the batch's statistics and updates the
running ones, ``.eval()`` (flax's ``train=False``) uses the running ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import Conv, Dense
from mme_tpu_torch.models.norm import BatchNorm


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride) → 1×1 to ``4·features``, each conv without
    bias and followed by a BatchNorm; ``downsample`` adds the strided 1×1
    ``down_conv`` / ``down_bn`` on the residual. Channels-first."""

    def __init__(self, in_dim: int, features: int, strides: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        bn = dict(dtype=dtype, device=device)
        out = features * 4
        self.conv1 = Conv(in_dim, features, (1, 1), **kw)
        self.bn1 = BatchNorm(features, **bn)
        self.conv2 = Conv(features, features, (3, 3), (strides,) * 2,
                          [(1, 1), (1, 1)], **kw)
        self.bn2 = BatchNorm(features, **bn)
        self.conv3 = Conv(features, out, (1, 1), **kw)
        self.bn3 = BatchNorm(out, **bn)
        if downsample:
            self.down_conv = Conv(in_dim, out, (1, 1), (strides,) * 2, **kw)
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


class ResNet50(nn.Module):
    """torchvision-compatible resnet50 backbone: [B, H, W, 3] → (logits
    [B, num_classes], pooled features [B, 2048])."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = Conv(3, 64, (7, 7), (2, 2), [(3, 3), (3, 3)],
                          use_bias=False, dtype=dtype, device=dev)
        self.bn1 = BatchNorm(64, dtype=dtype, device=dev)
        self.blocks = []
        in_dim = 64
        for stage, (blocks, w) in enumerate(zip(stage_sizes,
                                                (64, 128, 256, 512))):
            for b in range(blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(
                    in_dim, w, 2 if (stage > 0 and b == 0) else 1,
                    downsample=b == 0, dtype=dtype, device=dev))
                self.blocks.append(name)
                in_dim = w * 4
        self.fc = Dense(in_dim, num_classes, dtype=dtype, device=dev)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(_channels_first(x))))
        # the -inf padded 3×3 / 2 max-pool
        y = F.max_pool2d(y, 3, 2, padding=1)
        for name in self.blocks:
            y = getattr(self, name)(y)
        pooled = y.mean(dim=(2, 3))
        return self.fc(pooled), pooled


class ResnetClassifier(nn.Module):
    """The resnet50 backbone's pooled features → a fresh ``fc``. The frozen
    backbone is the optimizer's trainable mask, not the module's."""

    def __init__(self, output_dim: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.backbone = ResNet50(1, dtype, device=device)
        self.fc = Dense(2048, output_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc(self.backbone(x)[1])


class ResNetFeatureExtractor(nn.Module):
    """resnet50 → ``fc`` to ``feature_dim`` → relu: [B, H, W, 3] →
    [B, 1, feature_dim] (the VisualBERT visual-feature path)."""

    def __init__(self, feature_dim: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.backbone = ResNet50(1, dtype, device=device)
        self.fc = Dense(2048, feature_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.relu(self.fc(self.backbone(x)[1]))[:, None, :]


class ConvNetClassifier(nn.Module):
    """Scratch ConvNet: VALID 3×3 convs with bias and relu → flatten in
    [H, W, C] order (JAX's channels-last) → ``fc`` → sigmoid; ``output_dim
    == 1`` gives [B]. ``in_size`` is the square image side, which fixes
    ``fc``'s input width."""

    def __init__(self, hidden_dims: Sequence[int] = (32, 32),
                 output_dim: int = 1, in_size: int = 32,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.n_convs, self.output_dim = len(hidden_dims), output_dim
        in_dim = 3
        for i, w in enumerate(hidden_dims):
            self.add_module(f"conv_{i}", Conv(in_dim, w, (3, 3), dtype=dtype,
                                              device=device))
            in_dim = w
        side = in_size - 2 * len(hidden_dims)
        self.fc = Dense(side * side * in_dim, output_dim, dtype=dtype,
                        device=device)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _channels_first(x)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        x = torch.sigmoid(self.fc(x.movedim(1, -1).reshape(x.shape[0], -1)))
        return x.reshape(-1) if self.output_dim == 1 else x
