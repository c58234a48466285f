"""AdamW over lists of tensors: fp32 moments, bf16 moments with stochastic
rounding, or a bf16 first moment with a factored second moment, behind a
global-norm clip with fp32 accumulation.

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
stall once an update falls below half a bf16 step. Every leaf that
``ops/adam_update.py::fusable`` accepts goes through one launch of the fused
kernel per step, its dither drawn in the kernel from a seed per (step,
leaf); on that path the moments are updated in place (the tensors in
``AdamWState.mu`` / ``nu`` keep their storage) and the update is written
into the clipped gradient, which the step owns. Every other leaf takes the
unfused update below, its dither drawn from the step's generator, and gets
new moment tensors.

Factored second moment (``adamw_factored``, Adafactor's factorisation under
Adam semantics): a matrix-shaped leaf of at least 16 384 elements keeps row
and column moving averages of its squared gradient instead of a full ``nu``,
and rebuilds ``V ≈ R·Cᵀ / ΣR``; the first moment is bf16 with stochastic
rounding as above. Rows and columns are those of the leaf's 2-D view in the
flax layout (leading dims flattened, last dim kept), which the port's
layouts transpose: ``Optimizer.views`` carries, per leaf, the pair of
functions between the port's layout and that view
(``convert.factored_views``); without it a leaf is viewed as it is stored.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from mme_tpu_torch.ops import adam_update
from mme_tpu_torch.ops.adam_update import sr_bf16
from mme_tpu_torch.parallel.sharding_rules import shard_of, shard_sum


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


def global_norm_f32(tensors: Sequence[torch.Tensor],
                    shards=None) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation whatever the leaves' dtype (a
    bf16 sum over hundreds of millions of elements is useless).
    ``shards``: one ``parallel/sharding_rules.py::Shard`` or None per
    tensor; a cut tensor's squares are summed over its axis and a
    replicated one counts once, so every rank gets the whole model's
    norm."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tensors]
    if shards is not None and any(s is not None for s in shards):
        whole = [n for n, s in zip(norms, shards) if s is None]
        cut = [n.square() for n, s in zip(norms, shards) if s is not None]
        norms = whole + [shard_sum(cut, [s for s in shards if s is not None]
                                   ).sqrt()]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_f32(grads: Sequence[torch.Tensor], max_norm: float,
                            shards=None) -> List[torch.Tensor]:
    """Gradients scaled by ``min(1, max_norm / max(norm, 1e-16))``, each in
    its own dtype (new tensors); ``shards`` as :func:`global_norm_f32`."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm_f32(grads, shards),
                                               min=1e-16), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]


FACTOR_MIN_SIZE = 16384    # below it the full fp32 nu is cheaper

# (to_rc, from_rc): a leaf in the port's layout → its [rows, cols] view, and
# a [rows, cols] tensor → the port's layout
View = Tuple[Callable[[torch.Tensor], torch.Tensor],
             Callable[[torch.Tensor], torch.Tensor]]


def default_view(p: torch.Tensor) -> Optional[View]:
    """The factorisation view of a leaf taken as it is stored: leading dims
    flattened, last dim kept; None for a leaf that keeps its full nu."""
    if p.dim() < 2 or p.numel() < FACTOR_MIN_SIZE:
        return None
    shape = p.shape
    return (lambda t: t.reshape(-1, shape[-1]), lambda v: v.reshape(shape))


@dataclasses.dataclass
class AdamWState:
    """Moments aligned with the parameter list (``None`` for a frozen
    leaf), the update count, and for bf16 moments the base seed of the
    fused kernel's dither streams. Factored state: ``nu_row`` / ``nu_col``
    hold the fp32 row and column averages of a factored leaf (whose ``nu``
    is None); every other leaf keeps its full fp32 ``nu``."""

    count: int
    mu: List[Optional[torch.Tensor]]
    nu: List[Optional[torch.Tensor]]
    seed: int = 0
    nu_row: Optional[List[Optional[torch.Tensor]]] = None
    nu_col: Optional[List[Optional[torch.Tensor]]] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip-by-global-norm → AdamW with torch's defaults (b1 .9, b2 .999,
    eps 1e-8). ``trainable[i] = False`` freezes leaf i: it gets no moments,
    no update, and its gradient stays out of the clip norm."""

    lr_schedule: Callable[[int], float]
    weight_decay: float
    clip: float
    state_dtype: str                          # "fp32" | "bf16" | "factored"
    trainable: Optional[Sequence[bool]] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # factored state only: one View or None per leaf; None for all: each
    # leaf is viewed as it is stored (default_view)
    views: Optional[Sequence[Optional[View]]] = None

    def _view(self, i: int, p: torch.Tensor) -> Optional[View]:
        return default_view(p) if self.views is None else self.views[i]

    def _live(self, n: int) -> List[int]:
        t = self.trainable
        return [i for i in range(n) if t is None or t[i]]

    def init(self, params: Sequence[torch.Tensor],
             generator: Optional[torch.Generator] = None) -> AdamWState:
        live = set(self._live(len(params)))
        if self.state_dtype == "factored":
            return self._init_factored(params, live)
        dtype = torch.bfloat16 if self.state_dtype == "bf16" else torch.float32
        zeros = lambda: [torch.zeros_like(p, dtype=dtype) if i in live
                         else None for i, p in enumerate(params)]
        seed = 0
        if self.state_dtype == "bf16":
            dev = generator.device if generator is not None else "cpu"
            seed = int(torch.randint(0, 1 << 40, (), generator=generator,
                                     device=dev))
        return AdamWState(count=0, mu=zeros(), nu=zeros(), seed=seed)

    def _init_factored(self, params, live) -> AdamWState:
        if any(shard_of(p) is not None for p in params):
            # a cut leaf's row and column sums would need its axis' sums
            raise NotImplementedError(
                "MME_OPT_STATE=factored with tensor or expert parallelism")
        mu, nu, rows, cols = [], [], [], []
        for i, p in enumerate(params):
            view = self._view(i, p) if i in live else None
            mu.append(torch.zeros_like(p, dtype=torch.bfloat16)
                      if i in live else None)
            if view is None:
                nu.append(torch.zeros_like(p, dtype=torch.float32)
                          if i in live else None)
                rows.append(None)
                cols.append(None)
            else:
                r, c = view[0](p.detach()).shape
                nu.append(None)
                rows.append(torch.zeros(r, dtype=torch.float32,
                                        device=p.device))
                cols.append(torch.zeros(c, dtype=torch.float32,
                                        device=p.device))
        return AdamWState(count=0, mu=mu, nu=nu, nu_row=rows, nu_col=cols)

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: AdamWState,
               generator: Optional[torch.Generator] = None) -> AdamWState:
        """One optimizer step. Parameters change in place; the returned
        state is ``state`` itself with its moments replaced and its count
        advanced. ``generator`` feeds the stochastic rounding of unfused
        bf16 leaves."""
        live = self._live(len(params))
        clipped = clip_by_global_norm_f32(
            [grads[i] for i in live], self.clip,
            [shard_of(params[i]) for i in live])
        lr = self.lr_schedule(state.count)       # optax: the count before
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        with torch.no_grad():
            fused = (self._fused_leaves(clipped, live, state, count, bc1,
                                        bc2)
                     if self.state_dtype == "bf16" else set())
            for g, i in zip(clipped, live):
                p = params[i]
                if i in fused:
                    u = g               # the kernel wrote the update here
                elif self.state_dtype == "bf16":
                    u, state.mu[i], state.nu[i] = self._lowmem_leaf(
                        g, state.mu[i], state.nu[i], bc1, bc2, generator)
                elif self.state_dtype == "factored":
                    u = self._factored_leaf(g, i, state, bc1, bc2, generator)
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

    def _factored_leaf(self, g, i, state, bc1, bc2, generator):
        """Update of one leaf with the factored second moment; replaces the
        leaf's moments in ``state``."""
        g32 = g.float()
        m32 = self.b1 * state.mu[i].float() + (1.0 - self.b1) * g32
        view = self._view(i, g)
        if view is None:
            n_new = self.b2 * state.nu[i] + (1.0 - self.b2) * g32 * g32
            state.nu[i] = n_new
            vcorr = n_new / bc2
        else:
            to_rc, from_rc = view
            g2 = to_rc(g32).square()
            r_new = self.b2 * state.nu_row[i] + (1.0 - self.b2) * g2.sum(dim=1)
            c_new = self.b2 * state.nu_col[i] + (1.0 - self.b2) * g2.sum(dim=0)
            state.nu_row[i], state.nu_col[i] = r_new, c_new
            # V ≈ outer(R, C) / ΣR; the moving-average biases of R and C
            # cancel one ΣR bias, leaving a single 1/bc2 correction
            vhat = from_rc(r_new[:, None] * c_new[None, :]
                           / torch.clamp(r_new.sum(), min=1e-30))
            vcorr = vhat / bc2
        out = ((m32 / bc1) / (torch.sqrt(vcorr) + self.eps)).to(g.dtype)
        state.mu[i] = stochastic_round_bf16(m32, generator)
        return out

    def _fused_leaves(self, clipped, live, state, count, bc1, bc2):
        """One launch of the fused kernel over every bf16-moment leaf that
        it takes: the update goes into the clipped gradient and the moments
        are written in place. Returns the indices of those leaves."""
        take = [(g, i) for g, i in zip(clipped, live)
                if adam_update.fusable(g) and state.mu[i].is_contiguous()
                and state.nu[i].is_contiguous()]
        if not take:
            return set()
        gs = [g for g, _ in take]
        mus = [state.mu[i] for _, i in take]
        nus = [state.nu[i] for _, i in take]
        adam_update.adam_update_leaves(
            gs, mus, nus, bc1, bc2,
            # one dither stream per (step, leaf)
            [state.seed + (count << 20) + i for _, i in take], b1=self.b1,
            b2=self.b2, eps=self.eps, outs=gs, mu_outs=mus, nu_outs=nus)
        return {i for _, i in take}

    def _lowmem_leaf(self, g, mu, nu, bc1, bc2, generator):
        # unfused (the counterpart of JAX's XLA path): every leaf unless
        # MME_FUSED_ADAM is set, and the leaves the kernel does not take
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


def adamw_factored(lr_schedule: Callable[[int], float], weight_decay: float,
                   clip: float, trainable: Optional[Sequence[bool]] = None,
                   views: Optional[Sequence[Optional[View]]] = None
                   ) -> Optimizer:
    """AdamW with a stochastically rounded bf16 first moment and a factored
    second moment (``MME_OPT_STATE=factored``). ``views``: per leaf, the
    functions to and from the [rows, cols] view that is factorised
    (``convert.factored_views`` gives the JAX package's), or None for a leaf
    that keeps its full nu; without ``views`` every leaf is viewed as it is
    stored."""
    return Optimizer(lr_schedule, weight_decay, clip, "factored", trainable,
                     views=views)
