"""Fused transformer MLP: fc1 → activation → fc2 without the [N, F]
intermediate in device memory, and a backward that recomputes it from x.

Port of ``mme_tpu/ops/fused_mlp.py``. The TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` become the CUDA kernels of ``csrc/fused_mlp.cu`` (its header
describes their design). With the port's weight layout (``Dense.weight`` is
[out, in]: w1 [F, H], w2 [H, F]):

    forward   h = x w1ᵀ + b1,  a = act(h),  out = a w2ᵀ + b2
    backward  da = dO w2,  dh = da · act′(h),  dx = dh w1,
              dw1 = dhᵀ x,  dw2 = dOᵀ a,  db1 = Σ dh,  db2 = Σ dO

Every product takes operands in x's type (bf16 or fp32) and sums in fp32;
``a`` and ``dh`` are rounded to x's type before the products that consume
them; the activation, its derivative and the bias sums are fp32. The
residual is ``(x, w1, b1, w2)`` only: no [N, F] tensor outlives a call.

- :func:`fused_mlp` is a ``torch.autograd.Function`` behind a plain
  function. For CUDA tensors it launches the kernels or raises; for CPU
  tensors it runs the plain versions below. Each wrapper call counts one
  launch, whatever number of kernels it starts. In bf16 the products run on
  Hopper's ``wgmma`` with TMA-fed operands (``csrc/sm90_gemm.cuh``): the
  forward is two launches through a transient ``a`` [N, F], the backward two
  through transient ``a`` and ``dh`` [N, F] and one fp32 row of db1 partial
  sums per 128 rows (:func:`scratch_shapes`), all allocated here with
  ``torch.empty`` and freed when the call returns; db1 and db2 are then
  summed by ``torch.sum`` in a fixed order. fp32 keeps the FMA kernels (no
  TF32), which write every output themselves.
- :func:`gemm_bf16` is the bf16 product core alone, ``a @ b`` for
  either storage order of each operand, for the card-side tests.
- :func:`fused_mlp_fwd_plain` and :func:`fused_mlp_bwd_plain` compute the
  same functions with torch ops and the kernels' casts.
- The exact gelu uses ``erf`` itself. The TPU kernel's polynomial
  (Abramowitz–Stegun 7.1.26, absolute error 1.5e-7) exists only because its
  compiler cannot lower ``erf``; that error is the difference to expect
  against the JAX function.
- :func:`kernel_supports` is the shape rule of the kernels: H a multiple of
  256 up to 1024 and F a multiple of 64, fp32 or bf16. The TPU rule
  (``_bwd_fits_vmem``: two [H, F] fp32 accumulators within 16 MB of VMEM,
  which sends every full-width tower to the unfused path) is a limit of
  that design, not of the function, and has no counterpart here: all four
  full-width shapes of the TAV model run through the kernels.
  :func:`use_fused_mlp` is the dispatch of ``models/layers.py::Mlp``: it
  decides by the environment, the device and the shape, before any launch.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Callable, Tuple

import torch

from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES
from mme_tpu_torch.ops import kernels

SOURCE = "fused_mlp"
KERNEL_FWD = "fused_mlp_fwd"
KERNEL_BWD = "fused_mlp_bwd"
kernels.LAUNCHES.setdefault(KERNEL_FWD, 0)
kernels.LAUNCHES.setdefault(KERNEL_BWD, 0)

ACTS = ("gelu", "gelu_new", "relu", "tanh")     # the kernels' `act` codes
H_TILE, H_MAX, F_TILE = 256, 1024, 64

KERNEL_GEMM = "gemm_bf16"
kernels.LAUNCHES.setdefault(KERNEL_GEMM, 0)
ROW_TILE = 128       # rows of a bf16 output tile: one db1 partial row each

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES_FWD = [_P] * 7 + [_I] * 5 + [_L] * 2 + [_P]
_ARGTYPES_BWD = [_P] * 12 + [_I] * 5 + [_L] * 3 + [_P]
_ARGTYPES_GEMM = [_P] * 3 + [_I] * 5 + [_L] * 3 + [_P]


def act_pair(name: str) -> Tuple[Callable, Callable]:
    """(f, f′) of the activation, evaluated in fp32."""
    if name == "gelu":
        def f(x):
            return 0.5 * x * (1.0 + torch.erf(x * 2.0 ** -0.5))

        def df(x):
            cdf = 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5))
            pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
            return cdf + x * pdf
        return f, df
    if name == "gelu_new":
        c = math.sqrt(2.0 / math.pi)

        def f(x):
            return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))

        def df(x):
            t = torch.tanh(c * (x + 0.044715 * x ** 3))
            du = c * (1.0 + 3 * 0.044715 * x * x)
            return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du
        return f, df
    if name == "relu":
        return (lambda x: torch.clamp(x, min=0.0),
                lambda x: (x > 0).to(torch.float32))
    if name == "tanh":
        return torch.tanh, lambda x: 1.0 - torch.tanh(x) ** 2
    raise ValueError(f"unsupported fused-mlp activation {name}")


def fused_mlp_fwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor,
                        act: str = "gelu") -> torch.Tensor:
    """x [N, H], w1 [F, H], b1 [F], w2 [H, F], b2 [H] → out [N, H] in x's
    type, with the kernel's casts."""
    f, _ = act_pair(act)
    h = x.float() @ w1.float().t() + b1.float()
    a = f(h).to(x.dtype)
    return (a.float() @ w2.float().t() + b2.float()).to(x.dtype)


def fused_mlp_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, do: torch.Tensor, act: str = "gelu"
                        ) -> Tuple[torch.Tensor, ...]:
    """(dx, dw1, db1, dw2, db2) from the residual and the output gradient,
    with the kernel's casts: dx, dw1, dw2 in x's type, db1, db2 in fp32."""
    f, df = act_pair(act)
    xf, dof = x.float(), do.float()
    h = xf @ w1.float().t() + b1.float()
    a = f(h).to(x.dtype).float()
    dh32 = (dof @ w2.float()) * df(h)
    dh = dh32.to(x.dtype).float()
    dx = dh @ w1.float()
    dw1 = dh.t() @ xf
    dw2 = dof.t() @ a
    return (dx.to(x.dtype), dw1.to(x.dtype), dh32.sum(dim=0),
            dw2.to(x.dtype), dof.sum(dim=0))


def bounds(n: int, h: int, f: int, elem: int) -> list:
    """(forward, backward) of one call as (flops, bytes, bound ms, bound
    by): 4·N·H·F and 10·N·H·F flops against x, the weights, the outputs
    (and dO, dx and the weight gradients) in ``elem``-byte elements and the
    fp32 biases, each read or written once."""
    w = 2 * h * f * elem
    fwd = (4 * n * h * f, 2 * n * h * elem + w + (f + h) * 4)
    bwd = (10 * n * h * f, 3 * n * h * elem + 2 * w + f * 4 + (f + h) * 4)
    out = []
    for flops, nbytes in (fwd, bwd):
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out.append((flops, nbytes, max(by_ops, by_bytes) * 1e3,
                    "operations" if by_ops >= by_bytes else "bytes"))
    return out


def kernel_supports(h: int, f: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernels take an MLP of this width and type."""
    return (dtype in (torch.float32, torch.bfloat16) and h % H_TILE == 0
            and 0 < h <= H_MAX and f > 0 and f % F_TILE == 0)


def use_fused_mlp(x: torch.Tensor, h: int, f: int,
                  dtype: torch.dtype) -> bool:
    """Whether ``Mlp`` goes through :func:`fused_mlp`. Default off
    (``MME_FUSED_MLP`` unset or ``0``). ``1`` opts in for CUDA tensors whose
    width the kernels support; every other shape, and a CPU tensor, takes
    the unfused fc1 → act → fc2. ``interpret`` engages the function
    wherever the tensor lies: on the CPU that is its plain version."""
    mode = os.environ.get("MME_FUSED_MLP", "0")
    if mode in ("0", ""):
        return False
    if mode == "interpret":
        return True
    return x.is_cuda and kernel_supports(h, f, dtype)


def _check(fn: str, x, w1, b1, w2, act) -> Tuple[int, int, int]:
    if act not in ACTS:
        raise ValueError(f"unsupported fused-mlp activation {act}")
    if x.dim() != 2:
        raise ValueError(f"{fn}: x must be [N, H], got {tuple(x.shape)}")
    n, h = x.shape
    f = w1.shape[0]
    if not kernel_supports(h, f, x.dtype) or n == 0:
        raise ValueError(
            f"{fn}: no kernel for N={n} H={h} F={f} {x.dtype} (H a multiple "
            f"of {H_TILE} up to {H_MAX}, F a multiple of {F_TILE}, fp32 or "
            "bf16)")
    if w1.shape != (f, h) or w2.shape != (h, f) or b1.shape != (f,):
        raise ValueError(f"{fn}: w1 must be [F, H], w2 [H, F], b1 [F]; got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b1.shape)}")
    for name, t in (("w1", w1), ("w2", w2)):
        if t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous {x.dtype} on "
                             f"{x.device}")
    if (b1.dtype != torch.float32 or b1.device != x.device
            or not b1.is_contiguous()):
        raise ValueError(f"{fn}: b1 must be contiguous fp32 on {x.device}")
    _check_rows(fn, "x", x)
    return n, h, f


def _check_rows(fn: str, name: str, t: torch.Tensor) -> None:
    """Rows are read as 16-byte vectors (TMA boxes in bf16) through the row
    stride."""
    vec = 16 // t.element_size()
    if t.stride(1) != 1 or t.stride(0) % vec or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} needs a unit last stride and "
                         "16-byte aligned rows; got strides "
                         f"{tuple(t.stride())}")


def scratch_shapes(n: int, f: int) -> dict:
    """Shapes of the bf16 kernels' transients for N rows and F columns of
    the intermediate: ``a`` and ``dh`` in bf16 and one fp32 row of db1
    partial sums per ``ROW_TILE`` rows (the forward needs ``a`` alone)."""
    return {"a": (n, f), "dh": (n, f),
            "db1_rows": ((n + ROW_TILE - 1) // ROW_TILE, f)}


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")


def fused_mlp_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  act: str = "gelu") -> torch.Tensor:
    """The forward alone. A CUDA tensor launches the kernels on the current
    stream; a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, b1, w2, b2, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_fwd: no kernel for {x.device}")
    n, h, f = _check("fused_mlp_fwd", x, w1, b1, w2, act)
    if (b2.shape != (h,) or b2.dtype != torch.float32
            or b2.device != x.device or not b2.is_contiguous()):
        raise ValueError(f"fused_mlp_fwd: b2 must be contiguous fp32 [{h}] "
                         f"on {x.device}")
    bf = x.dtype == torch.bfloat16
    out = torch.empty((n, h), dtype=x.dtype, device=x.device)
    a = (torch.empty(scratch_shapes(n, f)["a"], dtype=x.dtype,
                     device=x.device) if bf else None)
    fn = kernels.load(SOURCE).mme_mlp_fwd
    fn.argtypes = _ARGTYPES_FWD
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), a.data_ptr() if bf else None, out.data_ptr(),
                 n, h, f, ACTS.index(act), int(bf), x.stride(0),
                 out.stride(0), _stream(x))
    _raise_on(err, "fused_mlp_fwd")
    kernels.LAUNCHES[KERNEL_FWD] += 1
    return out


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, do: torch.Tensor, act: str = "gelu"
                  ) -> Tuple[torch.Tensor, ...]:
    """(dx, dw1, db1, dw2, db2): dx, dw1, dw2 in x's type, db1, db2 in fp32.
    A CUDA tensor launches the backward kernels on the current stream; a
    CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, b1, w2, do, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: no kernel for {x.device}")
    n, h, f = _check("fused_mlp_bwd", x, w1, b1, w2, act)
    if do.shape != x.shape or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(f"fused_mlp_bwd: do must match x ({tuple(x.shape)} "
                         f"{x.dtype} on {x.device}); got {tuple(do.shape)} "
                         f"{do.dtype} on {do.device}")
    vec = 16 // do.element_size()
    if do.stride(1) != 1 or do.stride(0) % vec or do.data_ptr() % 16:
        # autograd may hand over an expanded or transposed gradient
        do = do.contiguous()
    bf = x.dtype == torch.bfloat16

    def empty(shape, dtype=x.dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)
    dx, dw1, dw2 = empty((n, h)), empty((f, h)), empty((h, f))
    if bf:
        shapes = scratch_shapes(n, f)
        a, dh = empty(shapes["a"]), empty(shapes["dh"])
        db1 = empty(shapes["db1_rows"], torch.float32)
        db2 = None
    else:
        a = dh = None
        db1, db2 = empty((f,), torch.float32), empty((h,), torch.float32)
    fn = kernels.load(SOURCE).mme_mlp_bwd
    fn.argtypes = _ARGTYPES_BWD
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 do.data_ptr(), ptr(a), ptr(dh), dx.data_ptr(),
                 dw1.data_ptr(), dw2.data_ptr(), db1.data_ptr(), ptr(db2),
                 n, h, f, ACTS.index(act), int(bf), x.stride(0), do.stride(0),
                 dx.stride(0), _stream(x))
        _raise_on(err, "fused_mlp_bwd")
        if bf:
            db1 = torch.sum(db1, dim=0)
            db2 = torch.sum(do, dim=0, dtype=torch.float32)
    kernels.LAUNCHES[KERNEL_BWD] += 1
    return dx, dw1, db1, dw2, db2


def gemm_operand_major(t: torch.Tensor, contracted: int) -> int:
    """How a 2-D operand is stored for the bf16 product: 0 when its
    contracted dimension (``contracted``: 1 for A [M, K], 0 for B [K, Nc])
    is the contiguous one (K-major), 1 when the other one is (MN-major).
    The other stride must hold 16-byte aligned rows."""
    if t.dim() != 2:
        raise ValueError(f"gemm_bf16: operands are 2-D, got {tuple(t.shape)}")
    other = 1 - contracted
    for mn, inner, outer in ((0, contracted, other), (1, other, contracted)):
        if t.stride(inner) == 1 and t.stride(outer) % 8 == 0:
            return mn
    raise ValueError("gemm_bf16: an operand needs one unit stride and a "
                     "16-byte aligned other stride; got strides "
                     f"{tuple(t.stride())}")


def gemm_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in fp32 and rounded to bf16."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for bf16 a [M, K] and b [K, Nc], each stored either way
    (a transposed view is read as it lies), through the wgmma core of the
    bf16 MLP kernels. A CPU tensor takes the plain version."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, b)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or b.device != a.device or a.device.type != "cuda":
        raise ValueError("gemm_bf16: bf16 operands on one CUDA device")
    m, k = a.shape
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"gemm_bf16: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    n = b.shape[1]
    a_mn, b_mn = gemm_operand_major(a, 1), gemm_operand_major(b, 0)
    for t in (a, b):
        if t.data_ptr() % 16:
            raise ValueError("gemm_bf16: operands need 16-byte aligned bases")
    lda = a.stride(1) if a_mn else a.stride(0)
    ldb = b.stride(0) if b_mn else b.stride(1)
    ldc = (n + 7) // 8 * 8
    c = torch.empty((m, ldc), dtype=torch.bfloat16, device=a.device)[:, :n]
    fn = kernels.load(SOURCE).mme_gemm_bf16
    fn.argtypes = _ARGTYPES_GEMM
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a_mn,
                 b_mn, lda, ldb, ldc, _stream(a))
    _raise_on(err, "gemm_bf16")
    kernels.LAUNCHES[KERNEL_GEMM] += 1
    return c


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.act = act
        ctx.b2_dtype = b2.dtype
        return fused_mlp_fwd(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, do):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(x, w1, b1, w2, do, ctx.act)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    """``act(x w1ᵀ + b1) w2ᵀ + b2`` for x [N, H], w1 [F, H], w2 [H, F] (the
    port's ``Dense.weight`` layout), differentiable in all five tensors;
    gradients come back in each tensor's own dtype."""
    return _FusedMlp.apply(x, w1, b1, w2, b2, act)
