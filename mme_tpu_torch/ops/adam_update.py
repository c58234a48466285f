"""Fused Adam update with bf16 moments: moving averages, bias correction and
stochastic rounding in one pass, the dither drawn inside the kernel.

Port of ``mme_tpu/ops/adam_update.py``. The TPU kernel ``_kernel`` becomes
the Triton kernel below. Per element, all arithmetic in fp32:

    m32 = b1·mu + (1−b1)·g
    n32 = b2·nu + (1−b2)·g²
    out = (m32/bc1) / (√(n32/bc2) + eps)
    mu' = sr_bf16(m32, lo16(word)),  nu' = sr_bf16(n32, hi16(word))

``sr_bf16`` adds 16 bits of dither below the bf16 mantissa cut and
truncates, so each write is unbiased; one 32-bit random word serves both
moments. The words come from Philox inside the kernel
(``tl.randint4x``: four words per counter), keyed by ``seed`` — which the
caller makes distinct per step and per leaf — and counted per element, so
the dither never exists in device memory. Triton's Philox is not the TPU's
generator: the two are compared by distribution, and exactly in
``zero_noise`` mode (dither 0: truncation).

Bound by bytes alone: one read each of g, mu, nu and one write each of out,
mu', nu' (16 bytes per element with fp32 gradients), no reuse, no
reduction. The kernel is one coalesced stream over the flattened leaf; a
program handles four consecutive blocks so that one Philox call feeds four
elements. Multiplies and adds are kept unfused (``enable_fp_fusion=False``)
and division and square root round to nearest, so ``out`` and the moments
match :func:`adam_update_leaf_plain` bit for bit when the dither is zero.

- :func:`adam_update_leaf` launches the kernel for a CUDA tensor (or
  raises) and runs the plain version for a CPU tensor.
- :func:`adam_update_leaf_plain` computes the same function with torch ops;
  it takes the dither words as an optional tensor, so a test can feed it
  and the JAX function the same words.
- :func:`fusable` says which leaves the optimizer sends here:
  ``MME_FUSED_ADAM=1`` (default off: the unfused path is the measured
  default of the JAX package and the H100 comparison is recorded in
  PERF.md) and a contiguous leaf of at least 2¹⁶ elements. The TPU rule
  "minor dim a multiple of 128" is a lane constraint with no meaning for a
  flat stream; the size floor only keeps launch overhead off the many tiny
  bias and LayerNorm leaves.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from mme_tpu_torch.ops import kernels

KERNEL = "adam_update"
kernels.LAUNCHES.setdefault(KERNEL, 0)

MIN_FUSED_ELEMENTS = 1 << 16
_BLOCK = 1024          # elements per Philox call; a program covers 4 blocks
# bound by _kernel() at the first launch: Triton resolves the names a kernel
# uses in its module's globals
tl = None
_update = None
_adam_update_kernel = None


def sr_bf16(x: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """fp32 → bf16 with unbiased stochastic rounding given uniform 16-bit
    dither (integers in [0, 65536)): add the dither to the fp32 bits, keep
    the high 16. Bit-identical to ``mme_tpu/train/optim.py::_sr_bf16``."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + noise16.to(torch.int32)) & -65536       # 0xFFFF0000
    return bits.view(torch.float32).to(torch.bfloat16)


def fusable(p: torch.Tensor) -> bool:
    """Whether the optimizer sends this leaf through the kernel."""
    if os.environ.get("MME_FUSED_ADAM", "0") in ("0", ""):
        return False
    return (p.is_cuda and p.is_contiguous()
            and p.numel() >= MIN_FUSED_ELEMENTS)


def adam_update_leaf_plain(g: torch.Tensor, mu: torch.Tensor,
                           nu: torch.Tensor, bc1: float, bc2: float, *,
                           b1: float, b2: float, eps: float,
                           noise: Optional[torch.Tensor] = None,
                           zero_noise: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One leaf's update with torch ops → (out in g's dtype, mu', nu' bf16).

    ``noise``: 32-bit dither words as an integer tensor of g's shape (low
    half for mu, high half for nu); without it the words are drawn from
    ``generator``, or are zero in ``zero_noise`` mode."""
    g32 = g.float()
    m32 = b1 * mu.float() + (1.0 - b1) * g32
    n32 = b2 * nu.float() + (1.0 - b2) * g32 * g32
    # 0-dim tensors: a tensor divided by a Python number is multiplied by
    # its reciprocal on the card, which is not the division above
    c1 = torch.tensor(bc1, dtype=torch.float32, device=g.device)
    c2 = torch.tensor(bc2, dtype=torch.float32, device=g.device)
    out = ((m32 / c1) / (torch.sqrt(n32 / c2) + eps)).to(g.dtype)
    if zero_noise:
        lo = hi = torch.zeros((), dtype=torch.int32, device=g.device)
    else:
        if noise is None:
            noise = torch.randint(0, 1 << 32, g.shape, dtype=torch.int64,
                                  generator=generator, device=g.device)
        words = noise.to(torch.int64) & 0xFFFFFFFF
        lo, hi = words & 0xFFFF, words >> 16
    return out, sr_bf16(m32, lo), sr_bf16(n32, hi)


def _kernel():
    """The Triton kernel, defined on first use: this module must import
    where ``triton`` is not installed."""
    global tl, _update, _adam_update_kernel
    if _adam_update_kernel is not None:
        return _adam_update_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _update(offs, word, n, g_ptr, mu_ptr, nu_ptr, out_ptr, mu_out_ptr,
                nu_out_ptr, bc1, bc2, b1: tl.constexpr, b2: tl.constexpr,
                eps: tl.constexpr, ZERO_NOISE: tl.constexpr):
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mu = tl.load(mu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        nu = tl.load(nu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        m32 = b1 * mu + (1.0 - b1) * g
        n32 = b2 * nu + (1.0 - b2) * g * g
        out = tl.div_rn(tl.div_rn(m32, bc1),
                        tl.sqrt_rn(tl.div_rn(n32, bc2)) + eps)
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)
        m_bits = m32.to(tl.uint32, bitcast=True)
        n_bits = n32.to(tl.uint32, bitcast=True)
        if not ZERO_NOISE:
            w = word.to(tl.uint32, bitcast=True)
            m_bits = m_bits + (w & 0xFFFF)
            n_bits = n_bits + (w >> 16)
        m_bits = m_bits & 0xFFFF0000
        n_bits = n_bits & 0xFFFF0000
        tl.store(mu_out_ptr + offs,
                 m_bits.to(tl.float32, bitcast=True).to(tl.bfloat16),
                 mask=mask)
        tl.store(nu_out_ptr + offs,
                 n_bits.to(tl.float32, bitcast=True).to(tl.bfloat16),
                 mask=mask)

    @triton.jit
    def _adam_update_kernel(g_ptr, mu_ptr, nu_ptr, out_ptr, mu_out_ptr,
                            nu_out_ptr, n, bc1, bc2, seed,
                            b1: tl.constexpr, b2: tl.constexpr,
                            eps: tl.constexpr, ZERO_NOISE: tl.constexpr,
                            BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        lane = tl.arange(0, BLOCK)
        base = pid * (4 * BLOCK)
        # one Philox counter per lane of the program, four words each
        w0, w1, w2, w3 = tl.randint4x(seed, pid * BLOCK + lane)
        _update(base + lane, w0, n, g_ptr, mu_ptr, nu_ptr, out_ptr,
                mu_out_ptr, nu_out_ptr, bc1, bc2, b1, b2, eps, ZERO_NOISE)
        _update(base + BLOCK + lane, w1, n, g_ptr, mu_ptr, nu_ptr, out_ptr,
                mu_out_ptr, nu_out_ptr, bc1, bc2, b1, b2, eps, ZERO_NOISE)
        _update(base + 2 * BLOCK + lane, w2, n, g_ptr, mu_ptr, nu_ptr,
                out_ptr, mu_out_ptr, nu_out_ptr, bc1, bc2, b1, b2, eps,
                ZERO_NOISE)
        _update(base + 3 * BLOCK + lane, w3, n, g_ptr, mu_ptr, nu_ptr,
                out_ptr, mu_out_ptr, nu_out_ptr, bc1, bc2, b1, b2, eps,
                ZERO_NOISE)

    return _adam_update_kernel


def adam_update_leaf(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1: float, bc2: float, seed: int, *, b1: float,
                     b2: float, eps: float, zero_noise: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's fused update. g: fp32 or bf16; mu, nu: bf16, g's shape;
    bc1, bc2: the step's bias corrections; ``seed``: the Philox key, which
    the caller makes distinct for every (step, leaf) → (out in g's dtype,
    mu', nu' bf16, new tensors). A CUDA tensor launches the kernel on the
    current stream; a CPU tensor takes the plain version, drawing its
    dither from ``generator``."""
    if g.device.type == "cpu":
        return adam_update_leaf_plain(g, mu, nu, bc1, bc2, b1=b1, b2=b2,
                                      eps=eps, zero_noise=zero_noise,
                                      generator=generator)
    if g.device.type != "cuda":
        raise ValueError(f"adam_update_leaf: no kernel for {g.device}")
    n = g.numel()
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adam_update_leaf: g must be fp32 or bf16, got "
                        f"{g.dtype}")
    for name, x in (("mu", mu), ("nu", nu)):
        if (x.dtype != torch.bfloat16 or x.shape != g.shape
                or x.device != g.device):
            raise ValueError(f"adam_update_leaf: {name} must be bf16 "
                             f"{tuple(g.shape)} on {g.device}; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not (g.is_contiguous() and mu.is_contiguous() and nu.is_contiguous()):
        raise ValueError("adam_update_leaf: g, mu and nu must be contiguous")
    if n == 0 or n >= 1 << 31:
        raise ValueError(f"adam_update_leaf: {n} elements; the kernel "
                         "indexes with 32 bits")
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"adam_update_leaf: seed {seed} outside [0, 2^63)")
    out = torch.empty_like(g)
    mu_out = torch.empty_like(mu)
    nu_out = torch.empty_like(nu)
    grid = (-(-n // (4 * _BLOCK)),)
    with torch.cuda.device(g.device):
        _kernel()[grid](g, mu, nu, out, mu_out, nu_out, n, float(bc1),
                        float(bc2), int(seed), b1=b1, b2=b2, eps=eps,
                        ZERO_NOISE=zero_noise, BLOCK=_BLOCK, num_warps=8,
                        enable_fp_fusion=False)
    kernels.LAUNCHES[KERNEL] += 1
    return out, mu_out, nu_out
