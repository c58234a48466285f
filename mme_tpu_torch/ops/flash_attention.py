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
- :data:`flash_fwd_op` is the forward as the operator
  ``mme_tpu_torch::flash_fwd`` (:func:`kernels.define_op`), so that
  ``torch.export`` records it by name.
- :class:`FlashAttention` ties the operator and the backward together under
  ``torch.autograd`` (the counterpart of the ``custom_vjp`` around the TPU
  kernels).
- :func:`flash_bwd_prepass` is the backward's first launch alone (delta and
  the masked-row correction), :func:`bounds` the least time the card could
  take for a call.

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
from typing import Callable, List, Optional, Tuple

import torch

from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES
from mme_tpu_torch.ops import kernels

KERNEL = "flash_fwd"
KERNEL_BWD = "flash_bwd"
PREPASS = "flash_bwd_prepass"
LSE_MASKED = 1e30   # LSE of a row whose every score is -inf
HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
for _name in (KERNEL, KERNEL_BWD, PREPASS):
    kernels.LAUNCHES.setdefault(_name, 0)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (library, C symbol, argument types): bound once, at first use
_SIGNATURES = {
    "mme_flash_fwd": (KERNEL, [_P] * 6 + [_I] * 6 + [_L] * 13
                      + [ctypes.c_float, _P]),
    "mme_flash_bwd": (KERNEL_BWD, [_P] * 12 + [_I] * 6
                      + [_P, _L, ctypes.c_float, _P]),
    "mme_flash_bwd_prepass": (KERNEL_BWD, [_P] * 6 + [_I] * 6
                              + [_P, _L, _P]),
    "mme_flash_bwd_main": (KERNEL_BWD, [_P] * 11 + [_I] * 6
                           + [_P, _L, ctypes.c_float, _P]),
}


def _fn(symbol: str) -> Callable:
    """The C entry point ``symbol`` (:func:`kernels.entry`)."""
    lib_name, argtypes = _SIGNATURES[symbol]
    return kernels.entry(lib_name, symbol, argtypes)


def bounds(B: int, Sq: int, Sk: int, H: int, D: int, elem: int,
           has_bias: bool) -> List[Tuple[int, int, float, str]]:
    """(forward, backward) of one call as (flops, bytes, bound ms, bound
    by). Forward: 4·B·H·Sq·Sk·D flops against q, O and k, v in
    ``elem``-byte elements, the fp32 LSE and the key bias. Backward: five
    tile products, 10·B·H·Sq·Sk·D flops, against q, O, dO, dq and k, v, dk,
    dv, LSE and delta in fp32 and the key bias. Each byte is counted once,
    whatever the kernels read again."""
    bias = B * Sk * 4 if has_bias else 0
    fwd = (4 * B * H * Sq * Sk * D,
           (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem + B * H * Sq * 4
           + bias)
    bwd = (10 * B * H * Sq * Sk * D,
           (4 * B * Sq * H * D + 4 * B * Sk * H * D) * elem
           + 2 * B * H * Sq * 4 + bias)
    out = []
    for flops, nbytes in (fwd, bwd):
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out.append((flops, nbytes, max(by_ops, by_bytes) * 1e3,
                    "operations" if by_ops >= by_bytes else "bytes"))
    return out


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
    # contiguous, as the kernel writes it
    return out.to(q.dtype).contiguous(), lse


def _check(q, k, v, bias_k, fn: str = "flash_attention_fwd") -> list:
    """Raises on what the kernels do not take; returns the (batch,
    sequence, head) strides of q, k and v, in elements."""
    qs, ks = q.shape, k.shape
    if (len(qs) != 4 or len(ks) != 4 or v.shape != ks
            or (ks[0], ks[2], ks[3]) != (qs[0], qs[2], qs[3])):
        raise ValueError(f"{fn}: shapes q {tuple(qs)}, k {tuple(ks)}, "
                         f"v {tuple(v.shape)} are not [B, S, H, D] alike")
    B, Sq, H, D = qs
    Sk = ks[1]
    if D not in HEAD_DIMS or Sq == 0 or Sk == 0:
        raise ValueError(f"{fn}: head_dim {D} not in "
                         f"{HEAD_DIMS} or an empty sequence (Sq={Sq}, Sk={Sk})")
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"{fn}: q, k, v must share one dtype, "
                        f"bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"{fn}: q on {dev}, k on {k.device}, v on {v.device}")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        st = x.stride()
        # the kernels read rows of D elements as 16-byte vectors and TMA
        # boxes
        if not _aligned(x, st):
            raise ValueError(f"{fn}: {name} (strides {st}) needs a unit last "
                             "stride and a 16-byte aligned pointer and "
                             "strides")
        strides += st[:3]
    if bias_k is not None:
        if (bias_k.shape != (B, Sk) or bias_k.dtype != torch.float32
                or bias_k.device != dev or bias_k.stride(-1) != 1):
            raise ValueError(f"{fn}: bias_k must be fp32 "
                             f"[B, Sk] = [{B}, {Sk}] with unit last stride on "
                             f"{dev}; got {tuple(bias_k.shape)} "
                             f"{bias_k.dtype} on {bias_k.device}")
    return strides


def _aligned(x: torch.Tensor, st: Optional[Tuple[int, ...]] = None) -> bool:
    """Unit last stride, a 16-byte aligned pointer and strides: what the
    kernels' 16-byte loads and TMA boxes need."""
    st = x.stride() if st is None else st
    vec = 16 // x.element_size()
    return (st[-1] == 1 and x.data_ptr() % 16 == 0
            and st[0] % vec == 0 and st[1] % vec == 0 and st[2] % vec == 0)


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
    strides = _check(q, k, v, bias_k)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    guard, stream = kernels.launch_context(q.device)
    with guard:
        err = _fn("mme_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias_k is None else bias_k.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, H, D, int(q.dtype == torch.bfloat16), *strides,
            0 if bias_k is None else bias_k.stride(0),
            *out.stride()[:3], 1.0 / D ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    kernels.LAUNCHES[KERNEL] += 1
    return out, lse


def _flash_fwd_fake(q, k, v, bias_k):
    B, Sq, H, D = q.shape
    return (q.new_empty((B, Sq, H, D)),
            q.new_empty((B, H, Sq), dtype=torch.float32))


flash_fwd_op = kernels.define_op(
    "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias_k) "
    "-> (Tensor, Tensor)", flash_attention_fwd, _flash_fwd_fake)


def _masked_row_correction(bias_k: Optional[torch.Tensor],
                           lse: torch.Tensor) -> Optional[torch.Tensor]:
    """log n for the rows whose LSE lost it, else 0: [B, H, Sq] fp32.

    A row whose every key carries a mask bias (about -1e38, or the -1e30 of
    a key mask or of a ring's padded keys) has logits equal to the bias
    itself (the scores vanish below its fp32 spacing), so its true
    logsumexp is that of the bias row, max + log n, while the stored LSE is
    the max alone: LSE <= -1e30 in fp32. The backward computes
    ``P = exp((s - LSE) - correction)``. No sentinel row (LSE = +1e30) and
    no row with a real key (LSE of ordinary size) is touched. ``bias_k``
    may be longer than the k/v block the backward sees: the ring passes
    the whole context's row, so that n is the context's key count."""
    if bias_k is None:
        return None
    m = bias_k.amax(dim=-1, keepdim=True)
    log_n = torch.log(torch.exp(bias_k - m).sum(dim=-1))          # [B]
    return torch.where(lse <= -LSE_MASKED, log_n[:, None, None],
                       torch.zeros((), dtype=lse.dtype, device=lse.device))


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(O * dO) in fp32, [B, H, Sq], as the JAX wrapper computes it
    beside its kernel."""
    return (out.float() * do.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_bwd_prepass_plain(out: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor,
                            bias_k: Optional[torch.Tensor]
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(delta, corr) of the backward: rowsum(O * dO) and the masked-row
    correction, both [B, H, Sq] fp32; corr is None without a bias."""
    return _delta(out, do), _masked_row_correction(bias_k, lse)


def _check_bwd_rows(fn: str, q, out, do, lse) -> None:
    B, Sq, H, _ = q.shape
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{fn}: {name} must match q "
                             f"({tuple(q.shape)} {q.dtype} on {q.device}); "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"{fn}: lse must be fp32 [B, H, Sq] "
                         f"= [{B}, {H}, {Sq}] on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def flash_bwd_prepass(out: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      bias_k: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward's first launch on its own: (delta, corr) as
    :func:`flash_bwd_prepass_plain`. A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    if out.device.type == "cpu":
        return flash_bwd_prepass_plain(out, do, lse, bias_k)
    if out.device.type != "cuda":
        raise ValueError(f"flash_bwd_prepass: no kernel for {out.device}")
    _check_bwd_rows("flash_bwd_prepass", out, out, do, lse)
    B, Sq, H, D = out.shape
    if D not in HEAD_DIMS or out.dtype not in _DTYPES:
        raise ValueError(f"flash_bwd_prepass: head_dim {D} or dtype "
                         f"{out.dtype} not taken")
    if bias_k is not None and (bias_k.shape[0] != B
                               or bias_k.dtype != torch.float32
                               or bias_k.stride(-1) != 1):
        raise ValueError("flash_bwd_prepass: bias_k must be fp32 [B, Sk] "
                         "with a unit last stride")
    out = out if _aligned(out) else out.contiguous()
    do = do if _aligned(do) else do.contiguous()
    lse = lse.contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=out.device)
    corr = None if bias_k is None else torch.empty_like(delta)
    strides = (ctypes.c_longlong * 6)(*out.stride()[:3], *do.stride()[:3])
    guard, stream = kernels.launch_context(out.device)
    with guard:
        err = _fn("mme_flash_bwd_prepass")(
            out.data_ptr(), do.data_ptr(),
            None if bias_k is None else bias_k.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if corr is None else corr.data_ptr(),
            B, Sq, 0 if bias_k is None else bias_k.shape[1], H, D,
            int(out.dtype == torch.bfloat16), strides,
            0 if bias_k is None else bias_k.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_prepass launch failed: cudaError {err}")
    kernels.LAUNCHES[PREPASS] += 1
    return delta, corr


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias_k: Optional[torch.Tensor],
                              out: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor,
                              rows: Optional[Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]]
                              = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_fwd_plain` from its saved
    output and LSE, in the kernel's arithmetic: fp32 score recompute,
    P = exp(s - LSE) rounded to dO's dtype for dV, dS = P (dP - delta)
    rounded to q's dtype for dK and dQ, fp32 sums. No bias gradient.
    ``rows``: the pre-pass's (delta, corr), computed by the caller, in
    place of this call's own."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias_k is not None:
        logits = logits + bias_k.float()[:, None, None, :]
    x = logits - lse[..., None]
    delta, corr = (flash_bwd_prepass_plain(out, do, lse, bias_k)
                   if rows is None else rows)
    if corr is not None:
        x = x - corr[..., None]
    p = torch.exp(x)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_k: Optional[torch.Tensor], out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        rows: Optional[Tuple[torch.Tensor,
                                             Optional[torch.Tensor]]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``softmax(q kᵀ/√D + bias_k) v`` for the output gradient
    ``do``, from the forward's ``out`` and ``lse`` (which may be those of a
    longer context than this k/v block).

    q, out, do [B, Sq, H, D], k/v [B, Sk, H, D] (any strides with a unit
    last one), bias_k [B, Sk] fp32 or None, lse [B, H, Sq] fp32 →
    (dq, dk, dv), contiguous, in the inputs' dtype. A CUDA tensor launches
    the kernels on the current stream (the pre-pass, dK/dV, dQ); a CPU
    tensor takes the plain version.

    ``rows=(delta, corr)`` ([B, H, Sq] fp32, corr may be None) skips the
    pre-pass: the dK/dV and dQ kernels read the caller's. The ring of
    ``ops/ring_attention.py`` computes them once from the global O, LSE and
    key bias (:func:`flash_bwd_prepass`), because the masked-row correction
    of one k/v block would restore that block's key count, not the
    context's."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias_k, out, lse, do, rows)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    strides = _check(q, k, v, bias_k, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_bwd_rows("flash_attention_bwd", q, out, do, lse)
    # autograd may hand over an expanded or transposed gradient (a
    # broadcast sum's, say), and a caller another O; the kernels read rows
    # of D elements as 16-byte vectors and TMA boxes, so such a tensor is
    # copied once here
    do = do if _aligned(do) else do.contiguous()
    out = out if _aligned(out) else out.contiguous()
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, H, D), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 24)(*strides, *(
        s for x in (out, do, dq, dk, dv) for s in x.stride()[:3]))
    bias_ptr = None if bias_k is None else bias_k.data_ptr()
    bias_sb = 0 if bias_k is None else bias_k.stride(0)
    is_bf16 = int(q.dtype == torch.bfloat16)
    guard, stream = kernels.launch_context(q.device)
    if rows is None:
        # delta, and the masked-row correction when there is a bias:
        # written by the first launch
        buf = torch.empty((1 if bias_k is None else 2, B, H, Sq),
                          dtype=torch.float32, device=q.device)
        with guard:
            err = _fn("mme_flash_bwd")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), bias_ptr, lse.data_ptr(), buf[0].data_ptr(),
                None if bias_k is None else buf[1].data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, H, D, is_bf16, strides, bias_sb, 1.0 / D ** 0.5,
                stream)
    else:
        delta, corr = rows
        for name, x in (("delta", delta), ("corr", corr)):
            if x is not None and (x.shape != (B, H, Sq)
                                  or x.dtype != torch.float32
                                  or x.device != q.device
                                  or not x.is_contiguous()):
                raise ValueError(f"flash_attention_bwd: {name} must be "
                                 f"contiguous fp32 [B, H, Sq] = "
                                 f"[{B}, {H}, {Sq}] on {q.device}")
        with guard:
            err = _fn("mme_flash_bwd_main")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                bias_ptr, lse.data_ptr(), delta.data_ptr(),
                None if corr is None else corr.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, H, D, is_bf16, strides, bias_sb, 1.0 / D ** 0.5,
                stream)
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
        out, lse = flash_fwd_op(q, k, v, bias_k)
        ctx.save_for_backward(q, k, v, bias_k, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_k, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias_k, out, lse, do)
        return dq, dk, dv, None
