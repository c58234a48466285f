"""Mixture-of-Experts FFN: a routed drop-in for ``models.layers.Mlp``.

Port of ``mme_tpu/models/moe.py``: ``MoESpec``, ``_capacity``,
``router_gates``, ``dispatch_combine``, ``MoEMlp``, ``MoEEncoderBlock`` and
``MoETransformerEncoder``. All shapes are static:

- router: an fp32 dense [H → E] over ``x.float()``, top-k by iterative
  argmax (the first index wins a tie, as ``jnp.argmax``); the combine
  weight is the raw softmax probability for top-1 and the selected
  probabilities renormalised for top-k > 1;
- capacity: each expert takes at most C = ceil(factor · S · k / E) tokens
  of each batch row, in sequence order; a token past it is dropped from the
  expert path and the block's residual carries it;
- dispatch and combine are one-hot [B, S, E, C] einsums in the compute
  dtype around the stacked experts ``w1`` [E, H, I], ``b1`` [E, I], ``w2``
  [E, I, H], ``b2`` [E, H]. The JAX package leaves these products to XLA,
  so they are PyTorch einsums here, with no kernel of their own;
- the load-balancing loss E · Σ_e frac_e · mean_prob_e, times
  ``aux_loss_weight``, is what each ``MoEMlp`` returns beside its output.
  JAX sows it into ``intermediates``; here ``MoETransformerEncoder``
  returns ``(x, aux_sum)`` and nothing is kept in module state, so one
  forward never adds to another's aux.

Expert parallelism (``MoESpec.ep_axis``) comes with the parallel axes
(ROADMAP Queue 1 item 7): any value but None raises. Blocks are not
rematerialised, as in JAX's ``MoETransformerEncoder``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.layers import (Dense, EncoderBlock, EncoderSpec,
                                         MultiHeadAttention, activation,
                                         dropout, empty_param)
from mme_tpu_torch.ops.layer_norm import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """MoE knobs layered on an EncoderSpec."""

    num_experts: int = 4
    top_k: int = 2
    capacity_factor: float = 1.5
    moe_every: int = 2           # every n-th block uses the MoE MLP
    aux_loss_weight: float = 1e-2
    ep_axis: Optional[str] = None  # expert parallelism: not ported yet


def _capacity(seq: int, top_k: int, num_experts: int,
              factor: float) -> int:
    cap = int(-(-seq * top_k * factor // num_experts))  # ceil
    return max(cap, 1)


def router_gates(logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, E] logits → (combine weights [B, S, E] with at most k
    nonzeros per token, aux load-balancing loss scalar), in fp32."""
    probs = torch.softmax(logits.float(), dim=-1)
    E = probs.shape[-1]
    gates = torch.zeros_like(probs)
    remaining = probs
    for _ in range(top_k):
        onehot = F.one_hot(remaining.argmax(dim=-1), E).to(probs.dtype)
        gates = gates + onehot * probs
        remaining = remaining * (1.0 - onehot)
    if top_k > 1:
        # GShard renormalisation; not for top-1, whose single weight would
        # become 1.0 and cut the router's task-loss gradient (Switch)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    frac = (gates > 0).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    return gates, (frac * mean_prob).sum() * E


def dispatch_combine(gates: torch.Tensor, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's slot in its experts' buffers, per batch row.

    gates: [B, S, E] (0 where not routed). Returns (dispatch [B, S, E, C]
    one-hot, combine [B, S, E, C] the same weighted by the gate), in
    ``gates``' dtype."""
    routed = (gates > 0).long()
    pos = torch.cumsum(routed, dim=1) * routed - 1   # -1: not routed
    fits = (pos >= 0) & (pos < capacity)
    onehot = F.one_hot(pos.clamp(0, capacity - 1), capacity).to(gates.dtype)
    dispatch = onehot * fits[..., None].to(gates.dtype)
    return dispatch, dispatch * gates[..., None]


class MoEMlp(nn.Module):
    """router → dispatch einsum → per-expert FFN → combine einsum.
    ``forward(x, rng) -> (y, aux · aux_loss_weight)``."""

    def __init__(self, spec: EncoderSpec, moe: MoESpec,
                 device: DeviceLike = "cuda"):
        super().__init__()
        if moe.ep_axis is not None:
            raise NotImplementedError(
                f"MoESpec.ep_axis={moe.ep_axis!r}: expert parallelism needs "
                "the parallel axes (ROADMAP Queue 1 item 7)")
        dev = resolve_device(device)
        s = spec
        E, H, inter = moe.num_experts, s.hidden, s.intermediate
        self.moe = moe
        self.dtype = s.dtype
        self.act = activation(s.act)
        self.dropout = s.dropout
        self.router = Dense(H, E, use_bias=False, dtype=torch.float32,
                            device=dev)
        self.w1 = empty_param((E, H, inter), dev)
        self.b1 = empty_param((E, inter), dev)
        self.w2 = empty_param((E, inter, H), dev)
        self.b2 = empty_param((E, H), dev)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        m, dt = self.moe, self.dtype
        C = _capacity(x.shape[1], m.top_k, m.num_experts, m.capacity_factor)
        gates, aux = router_gates(self.router(x.float()), m.top_k)
        dispatch, combine = dispatch_combine(gates.to(dt), C)
        xe = torch.einsum("bsec,bsh->ebch", dispatch, x.to(dt))
        h = torch.einsum("ebch,ehi->ebci", xe, self.w1.to(dt))
        h = self.act(h + self.b1[:, None, None, :].to(dt))
        ye = torch.einsum("ebci,eih->ebch", h, self.w2.to(dt))
        ye = ye + self.b2[:, None, None, :].to(dt)
        y = torch.einsum("ebch,bsec->bsh", ye, combine)
        return (dropout(y, self.dropout, self.training, rng),
                aux * m.aux_loss_weight)


class MoEEncoderBlock(nn.Module):
    """``EncoderBlock`` with the MLP replaced by ``MoEMlp`` (pre- or
    post-LN). ``forward(x, bias, rng) -> (x, aux)``."""

    def __init__(self, spec: EncoderSpec, moe: MoESpec,
                 device: DeviceLike = "cuda"):
        super().__init__()
        s = spec
        self.pre_ln = s.ln_style == "pre"
        self.dropout = s.dropout
        self.attention = MultiHeadAttention(s, device=device)
        self.moe_mlp = MoEMlp(s, moe, device=device)
        self.ln1 = FusedLayerNorm(s.hidden, s.ln_eps, s.dtype, device=device)
        self.ln2 = FusedLayerNorm(s.hidden, s.ln_eps, s.dtype, device=device)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        def attn(y):
            return dropout(self.attention(y, bias, rng), self.dropout,
                           self.training, rng)
        if self.pre_ln:
            x = x + attn(self.ln1(x))
            y, aux = self.moe_mlp(self.ln2(x), rng)
            return x + y, aux
        x = self.ln1(x + attn(x))
        y, aux = self.moe_mlp(x, rng)
        return self.ln2(x + y), aux


class MoETransformerEncoder(nn.Module):
    """``TransformerEncoder`` whose every ``moe.moe_every``-th block
    (``layer_1``, ``layer_3``, … with the default 2) carries an MoE MLP;
    the rest stay dense. ``forward(x, bias, rng) -> (x, aux_sum)``, the
    weighted aux terms of this call's MoE blocks summed in fp32."""

    def __init__(self, spec: EncoderSpec, moe: MoESpec,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.n_layers = spec.layers
        for i in range(spec.layers):
            block = (MoEEncoderBlock(spec, moe, device=device)
                     if (i + 1) % moe.moe_every == 0
                     else EncoderBlock(spec, device=device))
            self.add_module(f"layer_{i}", block)
        self.final_ln = (FusedLayerNorm(spec.hidden, spec.ln_eps, spec.dtype,
                                        device=device)
                         if spec.final_ln else None)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.n_layers):
            block = getattr(self, f"layer_{i}")
            if isinstance(block, MoEEncoderBlock):
                x, aux = block(x, bias, rng)
                aux_sum = aux_sum + aux
            else:
                x = block(x, bias, rng)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x, aux_sum
