"""FlashAttention-2 forward: the wrapper of ``csrc/flash_fwd.cu``.

Port of ``mme_tpu/ops/flash_attention.py`` (forward only; the backward
arrives with training). The TPU kernel ``_fwd_kernel`` becomes the CUDA
kernel in ``csrc/flash_fwd.cu``; the TPU layout devices (head packing,
lane slicing, the ``MME_FLASH_BQ``/``BK`` block knobs) are not carried over.

- :func:`flash_attention_fwd` launches the kernel for a CUDA tensor (or
  raises) and runs :func:`flash_attention_fwd_plain` for a CPU tensor. It
  never drops from the kernel to the plain version.
- :func:`flash_attention_fwd_plain` computes the same function directly:
  fp32 logits, softmax and logsumexp. The CPU path, the tests and
  ``chip_smoke.py`` use it as the kernel's reference.

One deviation from the JAX kernel: it pads the ragged last key block with a
``-1e30`` bias, which beats the ``-0.7·f32max`` mask bias, so a query row
whose every key is masked comes out 0 there instead of the non-flash mean
of v. The port excludes padding by index and follows the non-flash contract.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mme_tpu_torch.ops import kernels

KERNEL = "flash_fwd"
LSE_MASKED = 1e30   # LSE of a row whose every score is -inf
HEAD_DIMS = (64, 128)
kernels.LAUNCHES.setdefault(KERNEL, 0)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias_k: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, H, D], k/v [B, Sk, H, D], bias_k [B, Sk] fp32 or None →
    (O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] fp32)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias_k is not None:
        logits = logits + bias_k.float()[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    m = m.masked_fill(torch.isneginf(m), 0.0)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom)).squeeze(-1)
    probs = e / denom
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    dead = torch.isneginf(lse)         # every score -inf: O = 0, sentinel LSE
    out = out.masked_fill(dead.permute(0, 2, 1)[..., None], 0.0)
    lse = lse.masked_fill(dead, LSE_MASKED)
    return out.to(q.dtype), lse


def _check(q, k, v, bias_k) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be [B, S, H, D]")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != (B, Sk, H, D):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D not in HEAD_DIMS or Sq == 0 or Sk == 0:
        raise ValueError(f"flash_attention_fwd: head_dim {D} not in "
                         f"{HEAD_DIMS} or an empty sequence (Sq={Sq}, Sk={Sk})")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_fwd: q, k, v must share one dtype, "
                        f"bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"flash_attention_fwd: {name} on {x.device}, "
                             f"q on {dev}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name}'s last stride is "
                             f"{x.stride(-1)}, the kernel needs 1")
        # the kernel moves 16-byte vectors along every row it reads
        vec = 16 // x.element_size()
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte "
                             "aligned in its pointer and strides")
    if bias_k is not None:
        if (bias_k.shape != (B, Sk) or bias_k.dtype != torch.float32
                or bias_k.device != dev or bias_k.stride(-1) != 1):
            raise ValueError("flash_attention_fwd: bias_k must be fp32 "
                             f"[B, Sk] = [{B}, {Sk}] with unit last stride on "
                             f"{dev}; got {tuple(bias_k.shape)} "
                             f"{bias_k.dtype} on {bias_k.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_k: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q kᵀ/√D + bias_k) v and its row logsumexp.

    q [B, Sq, H, D], k/v [B, Sk, H, D] (any strides with a unit last one),
    bias_k [B, Sk] fp32 or None → (O [B, Sq, H, D], LSE [B, H, Sq] fp32).
    A CUDA tensor launches the kernel on the current stream; a CPU tensor
    takes the plain version."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    _check(q, k, v, bias_k)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = kernels.load(KERNEL)
    fn = lib.mme_flash_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias_k is None else bias_k.data_ptr(),
                 out.data_ptr(), lse.data_ptr(),
                 B, Sq, Sk, H, D, int(q.dtype == torch.bfloat16),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 0 if bias_k is None else bias_k.stride(0),
                 *out.stride()[:3], 1.0 / D ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    kernels.LAUNCHES[KERNEL] += 1
    return out, lse
