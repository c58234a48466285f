"""AdamW over lists of tensors: fp32 moments, or bf16 moments with stochastic
rounding, behind a global-norm clip with fp32 accumulation.

Port of ``mme_tpu/train/optim.py`` and of the optax chain that
``mme_tpu/train/steps.py::make_optimizer`` builds. The order of operations
is optax's: clip → Adam scaling (moving averages, bias correction, eps
outside the square root) → ``+ weight_decay·p`` → ``· −lr`` → add to the
parameter. Written as plain functions over aligned lists with an explicit
state object, so that order is in the open. JAX returns new trees; the port
updates parameters and moments in place (or rebinds them), and says so
where it does.

bf16 moments: all arithmetic stays fp32, only storage is bf16, written with
stochastic rounding (``E[sr(x)] = x``) so a long moving average does not
stall once an update falls below half a bf16 step. A leaf that
``ops/adam_update.py::fusable`` accepts goes through the fused kernel with
its dither drawn in the kernel; every other leaf takes the unfused update
below, its dither drawn from the step's generator.

``adamw_factored`` (the factored second moment) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from mme_tpu_torch.ops import adam_update
from mme_tpu_torch.ops.adam_update import sr_bf16


def _noise_words(shape, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Uniform 32-bit words as int64 in [0, 2^32)."""
    return torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                         generator=generator, device=device)


def stochastic_round_bf16(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """fp32 → bf16 with unbiased stochastic rounding: a value a fraction q
    of the way between two bf16 neighbours rounds away from zero with
    probability q."""
    return sr_bf16(x, _noise_words(x.shape, generator, x.device) & 0xFFFF)


def stochastic_round_bf16_pair(a: torch.Tensor, b: torch.Tensor,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round two tensors of one shape from one draw of 32-bit words: ``a``
    dithers with the low 16 bits, ``b`` with the high 16."""
    words = _noise_words(a.shape, generator, a.device)
    return sr_bf16(a, words & 0xFFFF), sr_bf16(b, words >> 16)


def global_norm_f32(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation whatever the leaves' dtype (a
    bf16 sum over hundreds of millions of elements is useless)."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_f32(grads: Sequence[torch.Tensor], max_norm: float
                            ) -> List[torch.Tensor]:
    """Gradients scaled by ``min(1, max_norm / max(norm, 1e-16))``, each in
    its own dtype (new tensors)."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm_f32(grads),
                                               min=1e-16), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]


@dataclasses.dataclass
class AdamWState:
    """Moments aligned with the parameter list (``None`` for a frozen
    leaf), the update count, and for bf16 moments the base seed of the
    fused kernel's dither streams."""

    count: int
    mu: List[Optional[torch.Tensor]]
    nu: List[Optional[torch.Tensor]]
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip-by-global-norm → AdamW with torch's defaults (b1 .9, b2 .999,
    eps 1e-8). ``trainable[i] = False`` freezes leaf i: it gets no moments,
    no update, and its gradient stays out of the clip norm."""

    lr_schedule: Callable[[int], float]
    weight_decay: float
    clip: float
    state_dtype: str                          # "fp32" | "bf16"
    trainable: Optional[Sequence[bool]] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def _live(self, n: int) -> List[int]:
        t = self.trainable
        return [i for i in range(n) if t is None or t[i]]

    def init(self, params: Sequence[torch.Tensor],
             generator: Optional[torch.Generator] = None) -> AdamWState:
        dtype = torch.bfloat16 if self.state_dtype == "bf16" else torch.float32
        live = set(self._live(len(params)))
        zeros = lambda: [torch.zeros_like(p, dtype=dtype) if i in live
                         else None for i, p in enumerate(params)]
        seed = 0
        if self.state_dtype == "bf16":
            dev = generator.device if generator is not None else "cpu"
            seed = int(torch.randint(0, 1 << 40, (), generator=generator,
                                     device=dev))
        return AdamWState(count=0, mu=zeros(), nu=zeros(), seed=seed)

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: AdamWState,
               generator: Optional[torch.Generator] = None) -> AdamWState:
        """One optimizer step. Parameters change in place; the returned
        state is ``state`` itself with its moments replaced and its count
        advanced. ``generator`` feeds the stochastic rounding of unfused
        bf16 leaves."""
        live = self._live(len(params))
        clipped = clip_by_global_norm_f32([grads[i] for i in live], self.clip)
        lr = self.lr_schedule(state.count)       # optax: the count before
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        with torch.no_grad():
            for g, i in zip(clipped, live):
                p = params[i]
                if self.state_dtype == "bf16":
                    u, state.mu[i], state.nu[i] = self._lowmem_leaf(
                        g, state.mu[i], state.nu[i], bc1, bc2,
                        # one dither stream per (step, leaf)
                        state.seed + (count << 20) + i, generator)
                else:
                    u = self._fp32_leaf(g, state.mu[i], state.nu[i], bc1, bc2)
                u = u.float().add_(p, alpha=self.weight_decay)
                p.add_(u, alpha=-lr)
        state.count = count
        return state

    def _fp32_leaf(self, g, mu, nu, bc1, bc2) -> torch.Tensor:
        g = g.float()
        mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        return (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)

    def _lowmem_leaf(self, g, mu, nu, bc1, bc2, seed, generator):
        if adam_update.fusable(g):
            return adam_update.adam_update_leaf(
                g, mu, nu, bc1, bc2, seed, b1=self.b1, b2=self.b2,
                eps=self.eps)
        # unfused (the counterpart of JAX's XLA path): small leaves, and
        # every leaf unless MME_FUSED_ADAM=1
        g32 = g.float()
        m32 = self.b1 * mu.float() + (1.0 - self.b1) * g32
        n32 = self.b2 * nu.float() + (1.0 - self.b2) * g32 * g32
        out = ((m32 / bc1) / (torch.sqrt(n32 / bc2) + self.eps)).to(g.dtype)
        mu2, nu2 = stochastic_round_bf16_pair(m32, n32, generator)
        return out, mu2, nu2


def adamw(lr_schedule: Callable[[int], float], weight_decay: float,
          clip: float, trainable: Optional[Sequence[bool]] = None
          ) -> Optimizer:
    """fp32-moment AdamW behind the clip."""
    return Optimizer(lr_schedule, weight_decay, clip, "fp32", trainable)


def adamw_lowmem(lr_schedule: Callable[[int], float], weight_decay: float,
                 clip: float, trainable: Optional[Sequence[bool]] = None
                 ) -> Optimizer:
    """The same AdamW with bf16 moment storage and stochastic rounding."""
    return Optimizer(lr_schedule, weight_decay, clip, "bf16", trainable)
