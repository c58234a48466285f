"""LayerNorm with flax numerics, plain and fused.

Port of ``mme_tpu/ops/layer_norm.py``. Both paths compute

    y = (x − mean)·rsqrt(max(0, E[x²] − mean²) + eps)·scale + bias

with fp32 statistics and arithmetic whatever the input type, the fast
variance of flax, and one final cast. ``torch.nn.functional.layer_norm``
computes the variance another way, so the port writes its own.

- :func:`layer_norm` is the plain path (the JAX module's fallback at
  ``:212-219``): torch ops under autograd. Every site uses it unless
  ``MME_FUSED_LN`` opts in.
- :func:`fused_layer_norm` is the port of the two TPU kernels
  ``_fwd_kernel`` (``:63``) and ``_bwd_kernel`` (``:73``): a
  ``torch.autograd.Function`` that saves only ``(x, weight)`` and recomputes
  mean and rstd in the backward, ``dx = rstd·(gγ − mean(gγ) − x̂·mean(gγ·x̂))``.
  For a CUDA tensor it launches the two Triton kernels below (or raises);
  for a CPU tensor it runs :func:`fused_layer_norm_fwd_plain` and
  :func:`fused_layer_norm_bwd_plain`, the same arithmetic in torch ops (the
  backward is the kernel's explicit formula, not autograd of the forward).

Both kernels are bound by bytes alone (forward: x in, y out; backward: g and
x in, dx out, plus the partial sums), so the design is a single pass with
16-byte loads: a program takes a block of rows by the whole feature axis
(padded to a power of two and masked, since 768 is none), reduces along the
row in registers and writes once. The TPU kernel's 256-row tiles and (8, H)
partial blocks are Mosaic constraints and are not carried over. The
backward's dscale and dbias need a sum over all rows, which no single
program sees: each program adds up Σ g·x̂ and Σ g over its own rows (rows
past N are masked out) and writes one fp32 row of a ``[programs, H]`` buffer
that the wrapper reduces with ``torch.sum``, as the JAX wrapper reduces its
partials outside the kernel. No atomics: two runs give the same bits.
Offsets are 64-bit (the first conv LayerNorm of the audio frontend has
78.6 M elements). Against the plain version the kernels differ by an fp32
ulp or so (``rsqrt`` and fused multiply-adds), before the final cast.

One deviation from the TPU kernel: its forward returns ``x``'s type, while
the non-fused path returns the module's ``dtype``; they differ when an fp32
tensor enters a bf16 module. The port follows the non-fused contract on both
paths (``dtype=`` of :func:`fused_layer_norm`).

:func:`use_fused_ln` is the dispatch rule, default off.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.ops import kernels

KERNEL_FWD = "layer_norm_fwd"
KERNEL_BWD = "layer_norm_bwd"
kernels.LAUNCHES.setdefault(KERNEL_FWD, 0)
kernels.LAUNCHES.setdefault(KERNEL_BWD, 0)

MIN_FUSED_ROWS = 1024
MAX_FUSED_FEATURES = 8192     # a row block is held in registers
_FWD_ROWS = 4                 # rows per forward program
_BWD_ROWS = 4                 # rows per backward tile
# bound by _kernels() at the first launch: Triton resolves the names a
# kernel uses in its module's globals
tl = None
_ln_fwd_kernel = None
_ln_bwd_kernel = None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis of ``x``; the result is in ``dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((x32 - mean) * mul + bias.float()).to(dtype)


def fused_layer_norm_fwd_plain(x2d: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, eps: float,
                               dtype: torch.dtype) -> torch.Tensor:
    """The forward kernel's function in torch ops: x2d [N, H] → [N, H] in
    ``dtype``."""
    return layer_norm(x2d, weight, bias, eps, dtype)


def fused_layer_norm_bwd_plain(g: torch.Tensor, x2d: torch.Tensor,
                               weight: torch.Tensor, eps: float
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The backward kernel's function in torch ops, from the output gradient
    ``g`` [N, H] and the saved ``(x2d, weight)`` → (dx in x's type, dscale
    and dbias in fp32). Mean and rstd are recomputed from x."""
    h = x2d.shape[1]
    x = x2d.float()
    g = g.float()
    mean = x.mean(dim=1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=1, keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x - mean) * rstd
    gg = g * weight.float()
    m1 = gg.sum(dim=1, keepdim=True) * (1.0 / h)
    m2 = (gg * xhat).sum(dim=1, keepdim=True) * (1.0 / h)
    dx = (rstd * (gg - m1 - xhat * m2)).to(x2d.dtype)
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


def _kernels():
    """The Triton kernels, defined on first use: this module must import
    where ``triton`` is not installed."""
    global tl, _ln_fwd_kernel, _ln_bwd_kernel
    if _ln_fwd_kernel is not None:
        return _ln_fwd_kernel, _ln_bwd_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_rows, H, eps,
                       ROWS: tl.constexpr, BLOCK_H: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * H + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / H
        var = tl.maximum(tl.sum(x * x, axis=1) / H - mean * mean, 0.0)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        mul = tl.rsqrt(var + eps)[:, None] * w[None, :]
        y = (x - mean[:, None]) * mul + b[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _ln_bwd_kernel(g_ptr, x_ptr, w_ptr, dx_ptr, ds_ptr, db_ptr, n_rows,
                       H, eps, ROWS: tl.constexpr, TILES: tl.constexpr,
                       BLOCK_H: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_H)
        cmask = cols < H
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        inv_h = 1.0 / H
        ds = tl.zeros([BLOCK_H], dtype=tl.float32)
        db = tl.zeros([BLOCK_H], dtype=tl.float32)
        for i in range(TILES):
            rows = (pid * TILES + i) * ROWS + tl.arange(0, ROWS)
            # rows past n_rows load zeros, so they add nothing to ds, db
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * H + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=1) / H
            var = tl.maximum(tl.sum(x * x, axis=1) / H - mean * mean, 0.0)
            rstd = tl.rsqrt(var + eps)
            # the padding columns hold x = 0, not x̂ = 0
            xhat = tl.where(mask, (x - mean[:, None]) * rstd[:, None], 0.0)
            gg = g * w[None, :]
            m1 = tl.sum(gg, axis=1) * inv_h
            m2 = tl.sum(gg * xhat, axis=1) * inv_h
            dx = rstd[:, None] * (gg - m1[:, None] - xhat * m2[:, None])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
                     mask=mask)
            ds += tl.sum(g * xhat, axis=0)
            db += tl.sum(g, axis=0)
        tl.store(ds_ptr + pid.to(tl.int64) * H + cols, ds, mask=cmask)
        tl.store(db_ptr + pid.to(tl.int64) * H + cols, db, mask=cmask)

    return _ln_fwd_kernel, _ln_bwd_kernel


def _check(fn: str, x2d: torch.Tensor, weight: torch.Tensor,
           others: Tuple[Tuple[str, torch.Tensor], ...]) -> None:
    n, h = x2d.shape
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: x must be fp32 or bf16, got {x2d.dtype}")
    if n == 0 or h > MAX_FUSED_FEATURES:
        raise ValueError(f"{fn}: [{n}, {h}] is outside the kernel's range "
                         f"(N > 0, H <= {MAX_FUSED_FEATURES})")
    if not x2d.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    for name, t in (("weight", weight),) + others:
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on "
                             f"{x2d.device}")
    if weight.shape != (h,):
        raise ValueError(f"{fn}: weight must be [{h}], got "
                         f"{tuple(weight.shape)}")


def _block_h(h: int) -> Tuple[int, int]:
    """(padded feature block, warps)."""
    block = 1 << max(h - 1, 1).bit_length()
    return block, (8 if block >= 1024 else 4)


def fused_layer_norm_fwd(x2d: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """x2d [N, H] → LayerNorm(x2d) in ``dtype``. A CUDA tensor launches the
    kernel on the current stream; a CPU tensor takes the plain version."""
    if x2d.device.type == "cpu":
        return fused_layer_norm_fwd_plain(x2d, weight, bias, eps, dtype)
    if x2d.device.type != "cuda":
        raise ValueError(f"fused_layer_norm_fwd: no kernel for {x2d.device}")
    _check("fused_layer_norm_fwd", x2d, weight, (("bias", bias),))
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_layer_norm_fwd: output dtype {dtype}")
    n, h = x2d.shape
    y = torch.empty((n, h), dtype=dtype, device=x2d.device)
    block, warps = _block_h(h)
    fwd, _ = _kernels()
    with torch.cuda.device(x2d.device):
        fwd[(-(-n // _FWD_ROWS),)](x2d, weight, bias, y, n, h, float(eps),
                                   ROWS=_FWD_ROWS, BLOCK_H=block,
                                   num_warps=warps)
    kernels.LAUNCHES[KERNEL_FWD] += 1
    return y


def _bwd_tiles(n: int) -> int:
    """Row tiles per backward program: more tiles mean fewer partial rows
    to write and reduce (one per 32 rows of a long input), fewer mean more
    programs to fill the card. Decided by the row count alone."""
    if n >= 4096:
        return 8
    return 4 if n >= MIN_FUSED_ROWS else 1


def bwd_programs(n: int) -> int:
    """Programs of the backward kernel for ``n`` rows: the rows of its
    partial-sum buffers."""
    return -(-n // (_BWD_ROWS * _bwd_tiles(n)))


def fused_layer_norm_bwd(g: torch.Tensor, x2d: torch.Tensor,
                         weight: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's type, dscale, dbias in fp32) from the output gradient and
    the saved ``(x2d, weight)``. A CUDA tensor launches the kernel on the
    current stream; a CPU tensor takes the plain version."""
    if x2d.device.type == "cpu":
        return fused_layer_norm_bwd_plain(g, x2d, weight, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"fused_layer_norm_bwd: no kernel for {x2d.device}")
    g = g.contiguous()          # autograd may hand over an expanded gradient
    _check("fused_layer_norm_bwd", x2d, weight, (("g", g),))
    if g.shape != x2d.shape or g.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"fused_layer_norm_bwd: g must be fp32 or bf16 "
                         f"{tuple(x2d.shape)}; got {g.dtype} "
                         f"{tuple(g.shape)}")
    n, h = x2d.shape
    programs = bwd_programs(n)
    dx = torch.empty_like(x2d)
    ds = torch.empty((programs, h), dtype=torch.float32, device=x2d.device)
    db = torch.empty((programs, h), dtype=torch.float32, device=x2d.device)
    block, warps = _block_h(h)
    _, bwd = _kernels()
    with torch.cuda.device(x2d.device):
        bwd[(programs,)](g, x2d, weight, dx, ds, db, n, h, float(eps),
                         ROWS=_BWD_ROWS, TILES=_bwd_tiles(n), BLOCK_H=block,
                         num_warps=warps)
    kernels.LAUNCHES[KERNEL_BWD] += 1
    return dx, ds.sum(dim=0), db.sum(dim=0)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, dtype):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return fused_layer_norm_fwd(x2d, weight, bias, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        dx, ds, db = fused_layer_norm_bwd(g, x2d, weight, ctx.eps)
        return dx, ds.to(weight.dtype), db.to(ctx.bias_dtype), None, None


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape) through the
    fused forward and backward; weight, bias: [H]. The result is in
    ``dtype`` (default: x's)."""
    h = x.shape[-1]
    x2d = x.reshape(-1, h).contiguous()
    y = _FusedLayerNorm.apply(x2d, weight.contiguous(), bias.contiguous(),
                              float(eps), dtype or x.dtype)
    return y.reshape(x.shape)


def use_fused_ln(h: int, dtype: torch.dtype, rows: int = 1 << 30,
                 device_type: str = "cuda") -> bool:
    """Whether a LayerNorm site goes through :func:`fused_layer_norm`.

    Default off (``MME_FUSED_LN`` unset or ``0``). ``MME_FUSED_LN=1`` opts in
    for CUDA tensors, fp32 or bf16, with at least 1024 rows: pooled [B, H]
    norms and short sequences stay on the plain path, as in JAX. The TPU
    rule ``h % 128 == 0`` is a lane rule; the kernels here mask the feature
    axis and need only ``h % 8 == 0``, which keeps every row 16-byte aligned
    for vector loads, and ``h <= 8192``, since a row block lives in
    registers. ``MME_FUSED_LN=interpret`` lifts every gate, as in JAX: on
    the CPU the function then runs its plain versions."""
    mode = os.environ.get("MME_FUSED_LN", "0")
    if mode in ("0", ""):
        return False
    if mode == "interpret":
        return True
    return (device_type == "cuda" and h % 8 == 0
            and h <= MAX_FUSED_FEATURES and rows >= MIN_FUSED_ROWS
            and dtype in (torch.float32, torch.bfloat16))


class FusedLayerNorm(nn.Module):
    """Last-axis LayerNorm with ``weight`` (flax ``scale``) and ``bias``;
    :func:`use_fused_ln` picks the path at call time."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[-1]
        if (x.dtype in (torch.float32, torch.bfloat16)
                and use_fused_ln(h, self.dtype, x.numel() // h,
                                 x.device.type)):
            return fused_layer_norm(x, self.weight, self.bias, self.eps,
                                    self.dtype)
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)
