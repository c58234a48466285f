"""Fused Adam update with bf16 moments: moving averages, bias correction and
stochastic rounding in one pass, the dither drawn inside the kernel.

Port of ``mme_tpu/ops/adam_update.py``. The TPU kernel ``_kernel`` (one
launch per leaf) becomes one CUDA launch per optimizer step over a table of
leaves (``csrc/adam_update.cu``). Per element, all arithmetic in fp32:

    m32 = b1·mu + (1−b1)·g
    n32 = b2·nu + (1−b2)·g²
    out = (m32/bc1) / (√(n32/bc2) + eps)
    mu' = sr_bf16(m32, lo16(word)),  nu' = sr_bf16(n32, hi16(word))

``sr_bf16`` adds 16 bits of dither below the bf16 mantissa cut and
truncates, so each write is unbiased; one 32-bit random word serves both
moments. The words are a documented function of the leaf's 64-bit ``seed``
(which the caller makes distinct per step and per leaf) and of the element
index ``e``, whatever the launch geometry: word ``e % 4`` of Philox4x32-10
with counter ``(e // 4, 0, 0, 0)`` and key ``(seed & 0xFFFFFFFF, seed >>
32)`` (:func:`dither_words_plain`). The kernel draws them in registers, so
the dither never exists in device memory, and the plain version draws the
same words, so the two agree bit for bit on the moments. Philox is not the
TPU's generator: the port and the JAX package are compared by
distribution, and exactly in ``zero_noise`` mode (dither 0: truncation).

Bound by bytes alone: one read each of g, mu, nu and one write each of out,
mu', nu' (16 bytes per element with fp32 gradients, 12 with bf16;
:func:`bounds`), no reuse, no reduction.

- :func:`adam_update_leaves` updates a list of leaves in one launch for
  CUDA tensors (or raises) and runs :func:`adam_update_leaves_plain` for
  CPU tensors. Outputs may be the inputs themselves (``outs=gs``,
  ``mu_outs=mus``, ``nu_outs=nus``): the optimizer updates its moments in
  place that way.
- :func:`adam_update_leaf` is the one-leaf form with new output tensors.
- :func:`adam_update_leaf_plain` computes one leaf with torch ops; it
  takes the dither words as an optional tensor, so a test can feed it and
  the JAX function the same words.
- :func:`fusable` says which leaves the optimizer sends here:
  ``MME_FUSED_ADAM=1`` (default off: the unfused path is the measured
  default of the JAX package) and a contiguous fp32 or bf16 CUDA leaf,
  whatever its size;
  ``MME_FUSED_ADAM=interpret`` admits a contiguous leaf on any device, so
  the CPU tests reach the grouped optimizer path through the plain
  version. The TPU rule "minor dim a multiple of 128" is a lane constraint
  with no meaning for a flat stream.
"""

from __future__ import annotations

import ctypes
import operator
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mme_tpu_torch.device import PEAK_BYTES, PEAK_FP32_FLOPS
from mme_tpu_torch.ops import kernels

KERNEL = "adam_update"
kernels.LAUNCHES.setdefault(KERNEL, 0)
# leaves updated by the kernel since import (a launch covers many)
LEAVES_FUSED = 0

SOURCE = "adam_update"
CHUNK = 4096                  # elements per block: kChunk in the source
RECORD_WORDS = 8              # int64 words per leaf record: Leaf there
MAX_ELEMENTS = (1 << 31) - 1  # the kernel indexes a leaf with 32 bits

_P, _F = ctypes.c_void_p, ctypes.c_float
_ARGTYPES = ([_P, ctypes.c_int, ctypes.c_longlong] + [_F] * 7
             + [ctypes.c_int, _P])

# Philox4x32-10 (Salmon et al., SC 2011; Random123's constants)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def sr_bf16(x: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """fp32 → bf16 with unbiased stochastic rounding given uniform 16-bit
    dither (integers in [0, 65536)): add the dither to the fp32 bits, keep
    the high 16. Bit-identical to ``mme_tpu/train/optim.py::_sr_bf16``."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + noise16.to(torch.int32)) & -65536       # 0xFFFF0000
    return bits.view(torch.float32).to(torch.bfloat16)


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of a·m for int64 ``a`` in [0, 2^32): m is
    split into 16-bit halves so that no product leaves int64."""
    p_lo, p_hi = a * (m & 0xFFFF), a * (m >> 16)       # each < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10_plain(counter: torch.Tensor, key: torch.Tensor
                        ) -> torch.Tensor:
    """Philox4x32-10 in torch integer ops: ``counter`` [..., 4] and ``key``
    [..., 2] (broadcast against each other), int64 holding 32-bit words →
    the four output words [..., 4], int64 in [0, 2^32)."""
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    k0, k1 = key.to(torch.int64).unbind(-1)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def dither_words_plain(seed: int, n: int, device="cpu") -> torch.Tensor:
    """The dither of a leaf of ``n`` elements keyed by ``seed``: word
    ``e % 4`` of Philox4x32-10 at counter ``(e // 4, 0, 0, 0)``, key
    ``(seed & 0xFFFFFFFF, seed >> 32)`` → int64 [n] in [0, 2^32)."""
    ctr = torch.zeros((n + 3) // 4, 4, dtype=torch.int64, device=device)
    ctr[:, 0] = torch.arange((n + 3) // 4, device=device)
    key = torch.tensor([seed & _MASK32, (seed >> 32) & _MASK32],
                       dtype=torch.int64, device=device)
    return philox4x32_10_plain(ctr, key).reshape(-1)[:n]


def fusable(p: torch.Tensor) -> bool:
    """Whether the optimizer sends this leaf through the kernel."""
    mode = os.environ.get("MME_FUSED_ADAM", "0")
    if mode in ("0", ""):
        return False
    return ((p.is_cuda or mode == "interpret")
            and p.dtype in (torch.float32, torch.bfloat16)
            and p.is_contiguous() and 0 < p.numel() <= MAX_ELEMENTS)


def bounds(sizes: Sequence[int], g_bytes: int = 4
           ) -> Tuple[int, int, float, str]:
    """(flops, bytes, bound ms, bound by) of one update over leaves of these
    element counts, whatever implements it: g, mu, nu read and out, mu',
    nu' written once each (g and out ``g_bytes`` per element, the moments
    bf16), 12 fp32 operations per element."""
    n = sum(sizes)
    flops, nbytes = 12 * n, n * (2 * g_bytes + 8)
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (flops, nbytes, max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def adam_update_leaf_plain(g: torch.Tensor, mu: torch.Tensor,
                           nu: torch.Tensor, bc1: float, bc2: float, *,
                           b1: float, b2: float, eps: float,
                           noise: Optional[torch.Tensor] = None,
                           zero_noise: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One leaf's update with torch ops → (out in g's dtype, mu', nu' bf16).

    ``noise``: 32-bit dither words as an integer tensor of g's shape (low
    half for mu, high half for nu), e.g. :func:`dither_words_plain`; in
    ``zero_noise`` mode the words are zero and ``noise`` is not needed."""
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
    elif noise is None:
        raise ValueError("adam_update_leaf_plain: give noise words or "
                         "zero_noise=True")
    else:
        words = noise.to(torch.int64) & 0xFFFFFFFF
        lo, hi = words & 0xFFFF, words >> 16
    return out, sr_bf16(m32, lo), sr_bf16(n32, hi)


Leaves = List[torch.Tensor]


def adam_update_leaves_plain(gs: Sequence[torch.Tensor],
                             mus: Sequence[torch.Tensor],
                             nus: Sequence[torch.Tensor], bc1: float,
                             bc2: float, seeds: Sequence[int], *, b1: float,
                             b2: float, eps: float,
                             outs: Optional[Sequence[torch.Tensor]] = None,
                             mu_outs: Optional[Sequence[torch.Tensor]] = None,
                             nu_outs: Optional[Sequence[torch.Tensor]] = None,
                             zero_noise: bool = False
                             ) -> Tuple[Leaves, Leaves, Leaves]:
    """The kernel's function in torch ops: :func:`adam_update_leaf_plain`
    per leaf, its dither :func:`dither_words_plain` of its seed → (outs,
    mu's, nu's). Each output goes into the given tensor where one is given
    (which may be the input itself), else into a new one."""
    result: Tuple[Leaves, Leaves, Leaves] = ([], [], [])
    dests = (outs, mu_outs, nu_outs)
    for k, (g, mu, nu, seed) in enumerate(zip(gs, mus, nus, seeds)):
        noise = None if zero_noise else dither_words_plain(
            seed, g.numel(), g.device).view(g.shape)
        new = adam_update_leaf_plain(g, mu, nu, bc1, bc2, b1=b1, b2=b2,
                                     eps=eps, noise=noise,
                                     zero_noise=zero_noise)
        for res, dest, x in zip(result, dests, new):
            res.append(x if dest is None else dest[k].copy_(x))
    return result


_T = torch.Tensor
_DTYPE, _SHAPE = operator.attrgetter("dtype"), operator.attrgetter("shape")


def _check(name: str, xs: Sequence[torch.Tensor], dtypes: Optional[list],
           shapes: list, dev_index: int) -> None:
    """Raises unless each tensor of ``xs`` is contiguous, on the device, of
    its dtype and of its shape (``dtypes=None``: those two already known).
    Checked list by list with ``map``, no Python frame per tensor: the
    wrapper's host time is these reads, about a dozen per leaf."""
    if (all(map(_T.is_contiguous, xs))
            and set(map(_T.get_device, xs)) == {dev_index}
            and (dtypes is None or (list(map(_DTYPE, xs)) == dtypes
                                    and list(map(_SHAPE, xs)) == shapes))):
        return
    for x, dt, shape in zip(xs, dtypes or map(_DTYPE, xs), shapes):
        if not (x.is_contiguous() and x.get_device() == dev_index
                and x.shape == shape and x.dtype == dt):
            raise ValueError(
                f"adam_update_leaves: {name} must be contiguous {dt} "
                f"{tuple(shape)} on cuda:{dev_index}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")


def _table(gs, mus, nus, outs, mu_outs, nu_outs, seeds, dev_index
           ) -> Tuple[np.ndarray, int]:
    """The leaf table as int64 words: a record of 8 per leaf (six pointers,
    the seed, n | (g is bf16) << 32), then every leaf's first chunk; and
    the number of chunks. Raises on what the kernel does not take. Outputs
    that are their inputs (the same list) are not checked again."""
    bf16, fp32 = torch.bfloat16, torch.float32
    gdt = list(map(_DTYPE, gs))
    if not set(gdt) <= {fp32, bf16}:
        raise TypeError(f"adam_update_leaves: g must be fp32 or bf16, got "
                        f"{sorted(set(map(str, gdt)))}")
    shapes = list(map(_SHAPE, gs))
    moment = [bf16] * len(gs)
    n_leaves = len(gs)
    words = np.empty((RECORD_WORDS + 1) * n_leaves, dtype=np.int64)
    records = words[:RECORD_WORDS * n_leaves].reshape(n_leaves, RECORD_WORDS)
    for k, (name, xs, src, dtypes) in enumerate((
            ("g", gs, None, None), ("mu", mus, None, moment),
            ("nu", nus, None, moment), ("out", outs, gs, gdt),
            ("mu_out", mu_outs, mus, moment),
            ("nu_out", nu_outs, nus, moment))):
        if xs is not src:
            _check(name, xs, dtypes, shapes, dev_index)
        records[:, k] = list(map(_T.data_ptr, xs))
    sizes = np.array(list(map(_T.numel, gs)), dtype=np.int64)
    if sizes.min() < 1 or sizes.max() > MAX_ELEMENTS:
        raise ValueError(f"adam_update_leaves: leaves of {sizes.min()} to "
                         f"{sizes.max()} elements; the kernel takes 1 to "
                         "2^31 - 1")
    if min(seeds) < 0 or max(seeds) >= 1 << 63:
        raise ValueError(f"adam_update_leaves: a seed outside [0, 2^63): "
                         f"{min(seeds)} to {max(seeds)}")
    records[:, 6] = seeds
    records[:, 7] = sizes | (np.array([t is bf16 for t in gdt],
                                      dtype=np.int64) << 32)
    chunks = -(-sizes // CHUNK)
    words[RECORD_WORDS * n_leaves] = 0
    np.cumsum(chunks[:-1], out=words[RECORD_WORDS * n_leaves + 1:])
    return words, int(chunks.sum())


def adam_update_leaves(gs: Sequence[torch.Tensor],
                       mus: Sequence[torch.Tensor],
                       nus: Sequence[torch.Tensor], bc1: float, bc2: float,
                       seeds: Sequence[int], *, b1: float, b2: float,
                       eps: float,
                       outs: Optional[Sequence[torch.Tensor]] = None,
                       mu_outs: Optional[Sequence[torch.Tensor]] = None,
                       nu_outs: Optional[Sequence[torch.Tensor]] = None,
                       zero_noise: bool = False
                       ) -> Tuple[Leaves, Leaves, Leaves]:
    """The fused update of a list of leaves. g: fp32 or bf16; mu, nu: bf16,
    g's shape; bc1, bc2: the step's bias corrections; ``seeds``: one Philox
    key per leaf, which the caller makes distinct for every (step, leaf) →
    (outs in g's dtype, mu's, nu's bf16). Outputs go into ``outs``,
    ``mu_outs``, ``nu_outs`` where given (each the input itself or a tensor
    of its own), else into new tensors. CUDA tensors: one launch on the
    current stream for all leaves; CPU tensors: the plain version."""
    if not gs:
        raise ValueError("adam_update_leaves: no leaves")
    if any(x is not None and len(x) != len(gs)
           for x in (mus, nus, seeds, outs, mu_outs, nu_outs)):
        raise ValueError("adam_update_leaves: the lists differ in length")
    dev = gs[0].device
    if dev.type == "cpu":
        return adam_update_leaves_plain(
            gs, mus, nus, bc1, bc2, seeds, b1=b1, b2=b2, eps=eps, outs=outs,
            mu_outs=mu_outs, nu_outs=nu_outs, zero_noise=zero_noise)
    if dev.type != "cuda":
        raise ValueError(f"adam_update_leaves: no kernel for {dev}")
    # the lists as given: an output list that is its input list is not
    # checked twice (_table)
    outs = [torch.empty_like(g) for g in gs] if outs is None else outs
    mu_outs = ([torch.empty_like(m) for m in mus] if mu_outs is None
               else mu_outs)
    nu_outs = ([torch.empty_like(v) for v in nus] if nu_outs is None
               else nu_outs)
    words, chunks = _table(gs, mus, nus, outs, mu_outs, nu_outs, seeds,
                           dev.index)
    guard, stream = kernels.launch_context(dev)
    with guard:
        # too large for kernel parameters: one copy on the launch stream.
        # The caching allocators keep the pinned block until its copy has
        # finished and the device block until the stream has passed the
        # launch.
        table = torch.from_numpy(words).pin_memory().to(dev, non_blocking=True)
        err = kernels.entry(SOURCE, "mme_adam_update", _ARGTYPES)(
            table.data_ptr(), len(gs), chunks, b1, 1.0 - b1, b2, 1.0 - b2,
            bc1, bc2, eps, int(zero_noise), stream)
    if err != 0:
        raise RuntimeError(f"adam_update kernel launch failed: "
                           f"cudaError {err}")
    global LEAVES_FUSED
    kernels.LAUNCHES[KERNEL] += 1
    LEAVES_FUSED += len(gs)
    return outs, mu_outs, nu_outs


def adam_update_leaf(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1: float, bc2: float, seed: int, *, b1: float,
                     b2: float, eps: float, zero_noise: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's fused update → (out in g's dtype, mu', nu' bf16, new
    tensors): :func:`adam_update_leaves` over a list of one leaf, so one
    launch on the card and the plain version on the CPU, with the same
    words of ``seed`` on both."""
    outs, mu_outs, nu_outs = adam_update_leaves(
        [g], [mu], [nu], bc1, bc2, [seed], b1=b1, b2=b2, eps=eps,
        zero_noise=zero_noise)
    return outs[0], mu_outs[0], nu_outs[0]
