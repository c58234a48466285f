"""Ring attention: exact attention with the sequence split over a mesh axis.

Port of ``mme_tpu/ops/ring_attention.py``. Each rank of the ``sp`` axis
holds one block of the sequence (q, k, v [B, L, H, D], head-minor as every
attention op of the port, and the key bias [B, L]). K/V blocks and their
key bias travel around the ring by P2P (``parallel/mesh.py::AxisGroup.
shift_start``, the next transfer in flight while this hop computes), so
after ``n`` hops every query block has seen every key block.

Two paths, as in JAX:

- **Flash** (``:114-197`` there): per hop, K1 (``ops/flash_attention.py::
  flash_attention_fwd``) on the local query block against the visiting k/v
  block, merged across hops by the log-sum-exp recurrence of
  :func:`merge_block`. The backward runs K2's dK/dV and dQ kernels once
  per hop with the **global** O and LSE, and the pre-pass (delta and the
  masked-row correction) runs once, before the hops, on the global O, LSE
  and the whole key-bias row the forward saw go by. The per-block
  pre-pass that ``flash_attention_bwd`` runs by default would restore a
  fully masked row's ``log n`` of one block instead of the context's, and
  give that row's dV ``n`` times too large. The dK/dV accumulators travel
  around the ring with their blocks and come home complete.
- **Dense** (``:35-72``): the online-softmax einsum body, differentiated by
  autograd through the hops (the ring step is an autograd function whose
  backward sends the gradients the other way). For ``use_flash=False``
  and head dims the kernels do not take.

``use_flash=None`` decides: ``MME_RING_FLASH=0/1`` forces; otherwise a CUDA
tensor with a head dim of 64 or 128 takes the kernels from
``MME_FLASH_MIN_SEQ`` local tokens on (0 by default, as the port's
single-device attention) unless ``MME_FLASH=0``. A CPU tensor takes the
dense path unless asked for flash, which then runs the kernels' plain
versions. Nothing falls back from a kernel to the plain path.

A fully masked local block returns K1's sentinel LSE (+1e30), which the
merge maps to -inf, so it adds nothing. A query row whose every key is
masked follows the port's single-device contract on the flash path (the
uniform mean of v); padded keys with a -1e30 bias beat the -0.7·f32max
mask, as in JAX. The key bias gets no gradient on the flash path.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from mme_tpu_torch.ops.flash_attention import (HEAD_DIMS, LSE_MASKED,
                                               flash_attention_bwd,
                                               flash_attention_fwd,
                                               flash_bwd_prepass)
from mme_tpu_torch.parallel.mesh import AxisGroup, Mesh

NEG_INF = -1e30
_LSE_MASKED_THRESHOLD = 1e29


def merge_block(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                o_i: torch.Tensor, lse_i: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the cross-hop log-sum-exp merge (JAX's
    ``_merge_block``). m, l, lse_i [B, H, L] fp32; acc [B, L, H, D] fp32;
    o_i [B, L, H, D], this block's normalised output."""
    lse_eff = torch.where(lse_i >= _LSE_MASKED_THRESHOLD,
                          torch.full_like(lse_i, float("-inf")), lse_i)
    m_new = torch.maximum(m, lse_eff)
    finite = m_new > float("-inf")
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    alpha = torch.where(finite, torch.exp(m - m_new), zero)
    beta = torch.where(finite, torch.exp(lse_eff - m_new), zero)
    l_new = l * alpha + beta
    acc = (acc * alpha.permute(0, 2, 1)[..., None]
           + o_i.float() * beta.permute(0, 2, 1)[..., None])
    return m_new, l_new, acc


def finish_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O in ``dtype``, global LSE) of the merged hops; a row that saw no
    finite score keeps K1's sentinel LSE, so the backward gives it P = 0."""
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    out = (acc / l_safe.permute(0, 2, 1)[..., None]).to(dtype)
    lse = torch.where(live, m + torch.log(l_safe),
                      torch.full_like(l, LSE_MASKED))
    return out, lse


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, axis: AxisGroup):
        B, L, H, _ = q.shape
        n = axis.size
        m = torch.full((B, H, L), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, L), dtype=torch.float32, device=q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        blocks = [k, v, bias]
        bias_parts: List[Optional[torch.Tensor]] = [None] * n
        for hop in range(n):
            bias_parts[(axis.index - hop) % n] = blocks[2]
            pending = axis.shift_start(blocks) if hop < n - 1 else None
            o_i, lse_i = flash_attention_fwd(q, blocks[0], blocks[1],
                                             blocks[2])
            m, l, acc = merge_block(m, l, acc, o_i, lse_i)
            if pending is not None:
                blocks = pending.wait()
        out, lse = finish_merge(m, l, acc, q.dtype)
        # the context's key-bias row, in sequence order: the pre-pass's
        # key count comes from it
        ctx.save_for_backward(q, k, v, bias, out, lse,
                              torch.cat(bias_parts, dim=1))
        ctx.axis = axis
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse, context_bias = ctx.saved_tensors
        axis = ctx.axis
        n = axis.size
        # once, from the global O, LSE and key count
        rows = flash_bwd_prepass(out, do, lse, context_bias)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        blocks = [k, v, bias]
        for hop in range(n):
            pending = axis.shift_start(blocks) if hop < n - 1 else None
            dq_i, dk_i, dv_i = flash_attention_bwd(
                q, blocks[0], blocks[1], blocks[2], out, lse, do, rows)
            dq += dq_i.float()
            # the accumulators travel with their blocks: after n hops each
            # is home with its block's whole gradient
            dk, dv = axis.shift_start([dk + dk_i.float(),
                                       dv + dv_i.float()]).wait()
            if pending is not None:
                blocks = pending.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None)


class _RingShift(torch.autograd.Function):
    """Receive the previous coordinate's tensors; the backward sends the
    gradients back the other way."""

    @staticmethod
    def forward(ctx, axis: AxisGroup, *tensors):
        ctx.axis = axis
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(axis.shift_start(tensors).wait())

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None
                 else g for g, (shape, dt, dev) in zip(grads, ctx.like)]
        return (None, *ctx.axis.shift_start(grads, backward=True).wait())


def _ring_dense(q, k, v, bias, axis: AxisGroup) -> torch.Tensor:
    """JAX's einsum body: fp32 scores and softmax, probabilities in v's
    dtype for P·V, fp32 sums; the running max starts at -1e30."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    B, L, H, D = q.shape
    m = torch.full((B, H, L, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=torch.float32, device=q.device)
    kc, vc, bc = k, v, bias
    qf = q.float()
    for hop in range(axis.size):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
        s = s + bc.float()[:, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
        if hop < axis.size - 1:
            kc, vc, bc = _RingShift.apply(axis, kc, vc, bc)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decide_ring_flash(q: torch.Tensor) -> bool:
    """The auto choice of the flash path for a local query block."""
    forced = os.environ.get("MME_RING_FLASH")
    dim_ok = q.shape[-1] in HEAD_DIMS
    if forced == "0":
        return False
    if forced == "1":
        return dim_ok
    try:
        min_seq = int(os.environ.get("MME_FLASH_MIN_SEQ", 0))
    except ValueError:
        min_seq = 0
    return (q.is_cuda and dim_ok and q.shape[1] >= min_seq
            and os.environ.get("MME_FLASH", "1") != "0")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = "sp",
                   key_mask: Optional[torch.Tensor] = None,
                   key_bias: Optional[torch.Tensor] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact attention over the sequence split along ``mesh[axis]``.

    q, k, v: this rank's block [B, L, H, D] (the rank at coordinate ``i``
    holds positions ``i·L .. (i+1)·L``). ``key_mask`` [B, L] (1 = attend,
    masked keys get -1e30) or ``key_bias`` [B, L] additive fp32, not both.
    Each rank's tensors hold only its rows of the batch, so a dp axis
    beside ``axis`` needs nothing here. Returns this rank's block of the output
    [B, L, H, D]."""
    if key_mask is not None and key_bias is not None:
        raise ValueError("pass key_mask or key_bias, not both")
    B, L = q.shape[0], q.shape[1]
    if key_bias is None:
        if key_mask is None:
            key_bias = torch.zeros((B, L), dtype=torch.float32,
                                   device=q.device)
        else:
            key_bias = torch.where(
                key_mask.bool(), torch.zeros((), device=q.device),
                torch.full((), NEG_INF, device=q.device)).float()
    key_bias = key_bias.float().contiguous()
    ax = mesh.axis(axis)
    if use_flash is None:
        use_flash = decide_ring_flash(q)
    if use_flash:
        if q.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"ring_attention: the flash path takes head "
                             f"dims {HEAD_DIMS}, not {q.shape[-1]}")
        return _RingFlash.apply(q, k, v, key_bias, ax)
    return _ring_dense(q, k, v, key_bias, ax)
