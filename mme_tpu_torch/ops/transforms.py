"""Small tensor transforms of the utility layer.

Port of ``mme_tpu/ops/transforms.py``:

- ``pool``: mean, max or median over the leading axis;
- ``crop_video``: a fixed (top, left, height, width) box cut out of every
  frame [..., H, W, C], the IEMOCAP speaker boxes below;
- ``random_flip``: per-sample horizontal and vertical flips of a video
  batch [B, T, H, W, C]. It draws from an explicit ``torch.Generator``,
  so its draws differ from JAX's; ``masks`` passes them in instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mme_tpu_torch.parallel.mesh import batch_rand

IEMOCAP_LEFT_BOX = (120, 2, 245, 355)    # (top, left, height, width)
IEMOCAP_RIGHT_BOX = (120, 362, 245, 355)


def pool(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "mean":
        return x.mean(dim=0)
    if mode == "max":
        return x.amax(dim=0)
    if mode == "median":
        # the mean of the two middle values for an even count, as
        # jnp.median (torch.median takes the lower one)
        s = (x if x.is_floating_point() else x.float()).sort(dim=0).values
        n = s.shape[0]
        return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    raise NotImplementedError(
        "The supported modes are 'mean', 'max' and 'median'")


def crop_video(video: torch.Tensor,
               box: Tuple[int, int, int, int]) -> torch.Tensor:
    """video: [..., H, W, C]; box: (top, left, height, width)."""
    t, l, h, w = box
    return video[..., t:t + h, l:l + w, :]


def random_flip(generator: Optional[torch.Generator], video: torch.Tensor,
                p_horizontal: float = 0.5, p_vertical: float = 0.5,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Flip each sample of [B, T, H, W, C] along W with probability
    ``p_horizontal``, then along H with ``p_vertical``. ``masks``:
    (do_h, do_v) bools [B] instead of the draws."""
    B = video.shape[0]
    if masks is None:
        u = batch_rand((2, B), generator, video.device, batch_dim=1)
        masks = (u[0] < p_horizontal, u[1] < p_vertical)
    do_h, do_v = (m.to(video.device).view(B, 1, 1, 1, 1) for m in masks)
    out = torch.where(do_h, video.flip(3), video)
    return torch.where(do_v, out.flip(2), out)
