"""Attention ops: one dispatcher, two backends.

Port of ``mme_tpu/ops/attention.py``. ``dot_product_attention_shd`` is the
numerics contract: fp32 logits and softmax, probabilities cast to v's dtype,
P·V accumulated in fp32. Calls that the flash kernels take go to
``ops/flash_attention.py`` (forward and, under autograd, backward); the
rest take the plain path below, differentiated by autograd, as JAX sends
them to XLA. That plain path is the counterpart of the XLA path, not a
fallback from a failed kernel.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from mme_tpu_torch.ops.flash_attention import HEAD_DIMS, FlashAttention

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def additive_mask(bool_mask: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] 1/0 (or bool) keep-mask → [B, 1, 1, S] additive bias."""
    m = bool_mask.to(dtype)
    return ((1.0 - m) * NEG_INF)[:, None, None, :]


def _decide_flash(q: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """The kernel takes a CUDA call with head_dim 64 or 128 and a key-mask
    bias (or none), unless ``MME_FLASH=0``, from ``MME_FLASH_MIN_SEQ``
    tokens on. That threshold defaults to 0: JAX's 448 is a TPU v5e
    crossover and no crossover has been measured on the H100."""
    bias_ok = bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                               and bias.shape[2] == 1)
    try:
        min_seq = int(os.environ.get("MME_FLASH_MIN_SEQ", 0))
    except ValueError:
        min_seq = 0
    return (q.is_cuda and q.shape[-1] in HEAD_DIMS and bias_ok
            and q.shape[1] >= min_seq
            and os.environ.get("MME_FLASH", "1") != "0")


def dot_product_attention_shd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              *, use_flash: Optional[bool] = None
                              ) -> torch.Tensor:
    """Head-minor attention core: q, k, v [B, S, H, D] → [B, S, H, D].
    ``bias`` broadcasts to [B, H, Sq, Sk]; ``use_flash=None`` decides by
    :func:`_decide_flash`."""
    if use_flash is None:
        use_flash = _decide_flash(q, bias)
    if use_flash:
        bias_k = None if bias is None else bias[:, 0, 0, :].float()
        return FlashAttention.apply(q, k, v, bias_k)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)
