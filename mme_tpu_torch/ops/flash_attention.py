"""FlashAttention-2, forward and backward: the wrappers of
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``.

Port of ``mme_tpu/ops/flash_attention.py``. The TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` become the CUDA kernels in ``csrc/``; the TPU layout
devices (head packing, lane slicing, the ``MME_FLASH_BQ``/``BK``/``BK_BWD``
block knobs) are not carried over.

- :func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch their
  kernel for a CUDA tensor (or raise) and run their plain version for a CPU
  tensor. They never drop from a kernel to its plain version.
- :func:`flash_attention_fwd_plain` and :func:`flash_attention_bwd_plain`
  compute the same functions directly, written from the kernels'
  arithmetic. The CPU path, the tests and ``chip_smoke.py`` use them as the
  kernels' references.
- :class:`FlashAttention` ties the two together under ``torch.autograd``
  (the counterpart of the ``custom_vjp`` around the TPU kernels).

Deviations from the JAX kernels, both about masked rows. The JAX forward
pads the ragged last key block with a ``-1e30`` bias, which beats the
``-0.7·f32max`` mask bias, so a query row whose every key is masked comes
out 0 there, with zero gradients; the non-flash path gives the mean of v.
The port excludes padding by index and follows the non-flash contract in
both directions. For such a row LSE = fl(max + log n) has lost log n to
fp32 rounding, so ``exp(s - LSE)`` would be 1 instead of 1/n; the backward
restores log n from the bias (:func:`_masked_row_correction`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mme_tpu_torch.ops import kernels

KERNEL = "flash_fwd"
KERNEL_BWD = "flash_bwd"
LSE_MASKED = 1e30   # LSE of a row whose every score is -inf
HEAD_DIMS = (64, 128)
kernels.LAUNCHES.setdefault(KERNEL, 0)
kernels.LAUNCHES.setdefault(KERNEL_BWD, 0)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p])
_ARGTYPES_BWD = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                    ctypes.c_void_p])


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


def _check(q, k, v, bias_k, fn: str = "flash_attention_fwd") -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: q, k, v must be [B, S, H, D]")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != (B, Sk, H, D):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D not in HEAD_DIMS or Sq == 0 or Sk == 0:
        raise ValueError(f"{fn}: head_dim {D} not in "
                         f"{HEAD_DIMS} or an empty sequence (Sq={Sq}, Sk={Sk})")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{fn}: q, k, v must share one dtype, "
                        f"bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{fn}: {name} on {x.device}, "
                             f"q on {dev}")
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name}'s last stride is "
                             f"{x.stride(-1)}, the kernel needs 1")
        # the kernel moves 16-byte vectors along every row it reads
        vec = 16 // x.element_size()
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:3]):
            raise ValueError(f"{fn}: {name} is not 16-byte "
                             "aligned in its pointer and strides")
    if bias_k is not None:
        if (bias_k.shape != (B, Sk) or bias_k.dtype != torch.float32
                or bias_k.device != dev or bias_k.stride(-1) != 1):
            raise ValueError(f"{fn}: bias_k must be fp32 "
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


def _masked_row_correction(bias_k: Optional[torch.Tensor],
                           lse: torch.Tensor) -> Optional[torch.Tensor]:
    """log n for the rows whose LSE lost it, else 0: [B, H, Sq] fp32.

    A row whose every key carries a mask bias of about -1e38 has logits
    equal to the bias itself (the scores vanish below its fp32 spacing), so
    its true logsumexp is that of the bias row, max + log n, while the
    stored LSE is the max alone. The backward computes
    ``P = exp((s - LSE) - correction)``. No sentinel row (LSE = +1e30) and
    no row with a real key (LSE of ordinary size) is touched."""
    if bias_k is None:
        return None
    m = bias_k.amax(dim=-1, keepdim=True)
    log_n = torch.log(torch.exp(bias_k - m).sum(dim=-1))          # [B]
    return torch.where(lse < -LSE_MASKED, log_n[:, None, None],
                       torch.zeros((), dtype=lse.dtype, device=lse.device))


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(O * dO) in fp32, [B, H, Sq], outside the kernel as in JAX."""
    return (out.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias_k: Optional[torch.Tensor],
                              out: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_fwd_plain` from its saved
    output and LSE, in the kernel's arithmetic: fp32 score recompute,
    P = exp(s - LSE) rounded to dO's dtype for dV, dS = P (dP - delta)
    rounded to q's dtype for dK and dQ, fp32 sums. No bias gradient."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias_k is not None:
        logits = logits + bias_k.float()[:, None, None, :]
    x = logits - lse[..., None]
    corr = _masked_row_correction(bias_k, lse)
    if corr is not None:
        x = x - corr[..., None]
    p = torch.exp(x)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - _delta(out, do)[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_k: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``softmax(q kᵀ/√D + bias_k) v`` for the output gradient
    ``do``, from the forward's ``out`` and ``lse`` (which may be those of a
    longer context than this k/v block).

    q, out, do [B, Sq, H, D], k/v [B, Sk, H, D] (any strides with a unit
    last one), bias_k [B, Sk] fp32 or None, lse [B, H, Sq] fp32 →
    (dq, dk, dv), contiguous, in the inputs' dtype. A CUDA tensor launches
    the kernel on the current stream; a CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias_k, out, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    _check(q, k, v, bias_k, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
            s % (16 // do.element_size()) for s in do.stride()[:3]):
        # autograd may hand over an expanded or transposed gradient (a
        # broadcast sum's, say); the kernel reads rows of D elements as
        # 16-byte vectors, so such a dO is copied once here
        do = do.contiguous()
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must match q "
                             f"({tuple(q.shape)} {q.dtype} on {q.device}); "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be fp32 [B, H, Sq] "
                         f"= [{B}, {H}, {Sq}] on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    lse = lse.contiguous()
    delta = _delta(out, do)
    corr = _masked_row_correction(bias_k, lse)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(
        s for x in (q, k, v, do, dq, dk, dv) for s in x.stride()[:3]))
    lib = kernels.load(KERNEL_BWD)
    fn = lib.mme_flash_bwd
    fn.argtypes = _ARGTYPES_BWD
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 None if bias_k is None else bias_k.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 None if corr is None else corr.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Sk, H, D, int(q.dtype == torch.bfloat16), strides,
                 0 if bias_k is None else bias_k.stride(0), 1.0 / D ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: cudaError {err}")
    kernels.LAUNCHES[KERNEL_BWD] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, bias_k)`` → O [B, Sq, H, D], with
    the backward through :func:`flash_attention_bwd`. q, k, v may be the
    strided views of a fused QKV tensor; ``bias_k`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias_k):
        out, lse = flash_attention_fwd(q, k, v, bias_k)
        ctx.save_for_backward(q, k, v, bias_k, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_k, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias_k, out, lse, do)
        return dq, dk, dv, None
