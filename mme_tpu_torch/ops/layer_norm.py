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
  For a CUDA tensor it launches the CUDA kernels of ``csrc/layer_norm.cu``
  (or raises); for a CPU tensor it runs :func:`fused_layer_norm_fwd_plain`
  and :func:`fused_layer_norm_bwd_plain`, the same arithmetic in torch ops
  (the backward is the kernel's explicit formula, not autograd of the
  forward). Its forward goes through :data:`layer_norm_fwd_op`, the
  operator ``mme_tpu_torch::layer_norm_fwd`` that ``torch.export`` records
  by name (:func:`kernels.define_op`).

Both kernels are bound by bytes (forward: x in, y out; backward: g and x
in, dx out; :func:`bounds`), so the design moves each element once and
keeps rows in flight (the source's header has the detail): a team of warps
takes a row (one warp up to H = 1024), each thread owning fixed 8-column
chunks read as 16-byte vectors, nothing padded to a power of two; a
persistent grid of one or two blocks per SM (:func:`launch_geometry`)
strides over the rows, and each team stages its next row in a ring of
shared-memory slots filled by 1-D bulk copies (:func:`smem_bytes`). The TPU kernel's
256-row tiles and (8, H) partial blocks are Mosaic constraints and are not
carried over. The backward's dscale and dbias need a sum over all rows: each
thread adds Σ g·x̂ and Σ g over its team's rows in registers, each block
writes one fp32 partial row, and a second launch of the same call adds the
rows in a fixed order. No atomics: two runs give the same bits. Against the
plain version the kernels differ by an fp32 ulp or so (``rsqrt`` and fused
multiply-adds), before the final cast.

The wrappers launch through one ctypes call each (argument types set once,
:func:`kernels.entry`; the launch plan one cached int array,
:func:`launch_plan`), with a device guard only off the current device, and
allocate with ``torch.empty`` alone (the backward's partial rows in one
buffer kept per device and stream). They check the kernels' range and
raise on what they do not take, including a pointer that is not 16-byte
aligned; they never fall back. On the H100 the backward is 3× faster than
the Triton draft it replaced and the forward's wall time 2.4× shorter, but
the forward's kernel alone is slower than that draft's (``PERF.md``).

One deviation from the TPU kernel: its forward returns ``x``'s type, while
the non-fused path returns the module's ``dtype``; they differ when an fp32
tensor enters a bf16 module. The port follows the non-fused contract on both
paths (``dtype=`` of :func:`fused_layer_norm`).

:func:`use_fused_ln` is the dispatch rule, default off.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from mme_tpu_torch.device import (PEAK_BYTES, PEAK_FP32_FLOPS, DeviceLike,
                                  resolve_device)
from mme_tpu_torch.ops import kernels

KERNEL_FWD = "layer_norm_fwd"
KERNEL_BWD = "layer_norm_bwd"
kernels.LAUNCHES.setdefault(KERNEL_FWD, 0)
kernels.LAUNCHES.setdefault(KERNEL_BWD, 0)

SOURCE = "layer_norm"
MIN_FUSED_ROWS = 1024
MAX_FUSED_FEATURES = 8192     # 4 chunks of 8 per thread, 8 warps per row
_DTYPES = (torch.float32, torch.bfloat16)

# launch geometry (csrc/layer_norm.cu)
WARPS_PER_BLOCK = 8
BLOCKS_PER_SM = 2
MIN_ROWS_PER_TEAM = 2         # one block per SM below: fewer partial rows
# a team computes one row while the next is on its way (3 or 4 slots
# measured no faster on the H100)
RING_SLOTS = 2
SMEM_MAX = 232448             # 227 KB, a block's most

_P, _F = ctypes.c_void_p, ctypes.c_float
_CFG = ctypes.c_int * 12      # the launch plan, one array per shape
_ARGTYPES_FWD = [_P] * 4 + [ctypes.POINTER(ctypes.c_int), _F, _P]
_ARGTYPES_BWD = [_P] * 6 + [ctypes.POINTER(ctypes.c_int), _F, _P]


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


class Geometry(NamedTuple):
    """How the kernels cover an [N, H] input. A team is the warps that take
    one row at a time: one warp up to H = 1024, ``warps_per_row`` beyond."""
    grid: int                 # blocks: one partial row each in the backward
    teams: int                # teams per block
    warps_per_row: int
    chunks_per_thread: int    # 8-column chunks a thread owns in each row
    rows_per_team: int        # the most rows one team takes


def launch_geometry(n: int, h: int, sms: int) -> Geometry:
    """The grid and rows per team (warp, up to H = 1024) of both kernels
    for ``n`` rows of ``h`` features on a card of ``sms`` SMs. Team ``i`` of
    block ``b`` takes rows ``b·teams + i``, then every ``grid·teams``-th
    after it. Two blocks per SM, or one where the teams would get fewer
    than ``MIN_ROWS_PER_TEAM`` rows each (every SM gets the same number of
    blocks), and no more blocks than the rows need. It depends on (N, H, SM
    count) alone, so the backward's sums are added in the same order in
    every run."""
    chunks = h // 8
    wpr = -(-chunks // 128)
    teams = max(1, WARPS_PER_BLOCK // wpr)
    per_sm = min(BLOCKS_PER_SM,
                 max(1, n // (sms * teams * MIN_ROWS_PER_TEAM)))
    grid = min(sms * per_sm, -(-n // teams))
    return Geometry(grid, teams, wpr, -(-chunks // (32 * wpr)),
                    -(-n // (grid * teams)))


def smem_bytes(geom: Geometry, h: int, elem: int, g_elem: int = 0) -> int:
    """Dynamic shared memory of one block for rows of ``h`` elements of
    ``elem`` bytes, plus ``g_elem`` for the backward's g. The block holds,
    in this order, every team's ``RING_SLOTS`` row slots, the scale (and the
    forward's bias) in fp32, 4 floats of reduction scratch per warp and an
    mbarrier per slot."""
    slot = h * (elem + g_elem)
    tables = (1 if g_elem else 2) * h * 4 + geom.teams * geom.warps_per_row * 16
    return tables + RING_SLOTS * geom.teams * (slot + 8)


def scratch_shapes(geom: Geometry, h: int) -> dict:
    """Shapes of the backward's fp32 buffers: one partial row (dscale,
    dbias) per block, and the two sums."""
    return {"partial_rows": (geom.grid, 2, h), "sums": (2, h)}


def bounds(n: int, h: int, elem: int) -> List[Tuple[int, int, float, str]]:
    """(forward, backward) of one call as (flops, bytes, bound ms, bound
    by), whatever implements them. Forward: x in and y out in ``elem``-byte
    elements, scale and bias in fp32, 6 fp32 operations per element.
    Backward: g and x in and dx out, scale in, dscale and dbias out in
    fp32, 16 operations per element."""
    fwd = (6 * n * h, 2 * n * h * elem + 2 * h * 4)
    bwd = (16 * n * h, 3 * n * h * elem + h * 4 + 2 * h * 4)
    out = []
    for flops, nbytes in (fwd, bwd):
        by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        out.append((flops, nbytes, max(by_ops, by_bytes) * 1e3,
                    "operations" if by_ops >= by_bytes else "bytes"))
    return out


def _check(fn: str, x2d: torch.Tensor, weight: torch.Tensor,
           others: Tuple[Tuple[str, torch.Tensor], ...]) -> None:
    """Raises on what the kernels do not take. ``others`` holds the bias
    [H] or g [N, H]; x and g are read by bulk copies, so they must be
    16-byte aligned."""
    n, h = x2d.shape
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"{fn}: x must be fp32 or bf16, got {x2d.dtype}")
    if n == 0 or h % 8 or h > MAX_FUSED_FEATURES:
        raise ValueError(f"{fn}: [{n}, {h}] is outside the kernel's range "
                         f"(N > 0, H a multiple of 8 up to "
                         f"{MAX_FUSED_FEATURES})")
    if not x2d.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    if x2d.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be 16-byte aligned (its rows are "
                         "read by bulk copies)")
    for name, t in (("weight", weight),) + others:
        if t.device != x2d.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on "
                             f"{x2d.device}")
        if name in ("weight", "bias"):
            if t.shape != (h,):
                raise ValueError(f"{fn}: {name} must be [{h}], got "
                                 f"{tuple(t.shape)}")
            if t.dtype not in _DTYPES:
                raise TypeError(f"{fn}: {name} must be fp32 or bf16, got "
                                f"{t.dtype}")
        elif t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned (its "
                             "rows are read by bulk copies)")


def launch_plan(n: int, h: int, sms: int, dtypes: Tuple[torch.dtype, ...],
                backward: bool) -> Tuple[Geometry, List[int]]:
    """The geometry and the kernel's ``cfg`` array: n, h, whether x, y (g
    in the backward), the scale and the bias are bf16, then the grid, teams,
    warps per row, chunks per thread, ring slots and shared memory.
    ``dtypes``: x, y or g, scale and (forward) bias."""
    geom = launch_geometry(n, h, sms)
    bf16 = [int(d == torch.bfloat16) for d in dtypes]
    bf16 += [0] * (4 - len(bf16))
    elem, other = (4 - 2 * b for b in bf16[:2])
    smem = smem_bytes(geom, h, elem, other if backward else 0)
    return geom, [n, h, *bf16, geom.grid, geom.teams, geom.warps_per_row,
                  geom.chunks_per_thread, RING_SLOTS, smem]


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, dev_index: int, dtypes: Tuple[torch.dtype, ...],
          backward: bool) -> Tuple[Geometry, ctypes.Array]:
    """:func:`launch_plan` on this card, the ``cfg`` as a ctypes array made
    once per shape."""
    sms = torch.cuda.get_device_properties(dev_index).multi_processor_count
    geom, cfg = launch_plan(n, h, sms, dtypes, backward)
    return geom, _CFG(*cfg)


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
    if dtype not in _DTYPES:
        raise TypeError(f"fused_layer_norm_fwd: output dtype {dtype}")
    n, h = x2d.shape
    _, cfg = _plan(n, h, x2d.device.index,
                   (x2d.dtype, dtype, weight.dtype, bias.dtype), False)
    y = torch.empty_like(x2d, dtype=dtype)
    guard, stream = kernels.launch_context(x2d.device)
    with guard:
        err = kernels.entry(SOURCE, "mme_layer_norm_fwd", _ARGTYPES_FWD)(
            x2d.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            cfg, eps, stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd kernel launch failed: "
                           f"cudaError {err}")
    kernels.LAUNCHES[KERNEL_FWD] += 1
    return y


layer_norm_fwd_op = kernels.define_op(
    "layer_norm_fwd(Tensor x, Tensor weight, Tensor bias, float eps, "
    "ScalarType dtype) -> Tensor", fused_layer_norm_fwd,
    lambda x2d, weight, bias, eps, dtype: torch.empty_like(x2d, dtype=dtype))


_WORKSPACE: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int, shape: Tuple[int, ...]
               ) -> torch.Tensor:
    """The backward's partial rows, in one fp32 buffer kept per device and
    stream and grown as needed: the calls on one stream run in order, so
    each may reuse it, and the buffer costs no allocation per call."""
    numel = shape[0] * shape[1] * shape[2]
    buf = _WORKSPACE.get((dev.index, stream))
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=dev)
        _WORKSPACE[(dev.index, stream)] = buf
    return buf


def fused_layer_norm_bwd(g: torch.Tensor, x2d: torch.Tensor,
                         weight: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's type, dscale, dbias in fp32) from the output gradient and
    the saved ``(x2d, weight)``. A CUDA tensor launches the kernels on the
    current stream (the backward and the fixed-order sum of its partial
    rows); a CPU tensor takes the plain version."""
    if x2d.device.type == "cpu":
        return fused_layer_norm_bwd_plain(g, x2d, weight, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"fused_layer_norm_bwd: no kernel for {x2d.device}")
    g = g.contiguous()          # autograd may hand over an expanded gradient
    _check("fused_layer_norm_bwd", x2d, weight, (("g", g),))
    if g.shape != x2d.shape or g.dtype not in _DTYPES:
        raise ValueError(f"fused_layer_norm_bwd: g must be fp32 or bf16 "
                         f"{tuple(x2d.shape)}; got {g.dtype} "
                         f"{tuple(g.shape)}")
    n, h = x2d.shape
    geom, cfg = _plan(n, h, x2d.device.index,
                      (x2d.dtype, g.dtype, weight.dtype), True)
    dx = torch.empty_like(x2d)
    guard, stream = kernels.launch_context(x2d.device)
    shapes = scratch_shapes(geom, h)
    part = _workspace(x2d.device, stream, shapes["partial_rows"])
    # the sums get their own small buffer, which the gradients keep alive
    sums = torch.empty(shapes["sums"], dtype=torch.float32,
                       device=x2d.device)
    with guard:
        err = kernels.entry(SOURCE, "mme_layer_norm_bwd", _ARGTYPES_BWD)(
            g.data_ptr(), x2d.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), cfg, eps, stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: "
                           f"cudaError {err}")
    kernels.LAUNCHES[KERNEL_BWD] += 1
    return dx, sums[0], sums[1]


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, dtype):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return layer_norm_fwd_op(x2d, weight, bias, eps, dtype)

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
    rule ``h % 128 == 0`` is a lane rule; the kernels here need only
    ``h % 8 == 0``, which keeps every row 16-byte aligned for bulk copies and
    vector loads, and ``h <= 8192``, since 8 warps hold a row's chunks and
    a block's ring must hold two rows of each team. ``MME_FUSED_LN=interpret`` lifts every gate, as in JAX: on
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
