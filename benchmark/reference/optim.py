"""The reference's training steps: cross entropy, clip by global norm,
AdamW (decoupled weight decay) under cosine warm restarts, all in
float32."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def learning_rate(o: dict, count: int) -> float:
    """SGDR: lr/2 · (1 + cos(π · T_cur / T_max)), T_cur the fractional
    epoch modulo ``T_max``."""
    t = math.fmod(count / o["steps_per_epoch"], o["T_max"])
    return o["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * t
                                                      / o["T_max"]))


ROUND_OFF = 1e-3


def train_steps(model: nn.Module, batches: Sequence[Tuple[dict,
                                                          torch.Tensor]],
                o: dict, moving: Optional[List[torch.Tensor]] = None
                ) -> Dict[str, object]:
    """One training step per batch from the model's current weights.
    Returns each step's loss, each parameter's gradient norm as the
    optimizer gets it at the first step (clipped), and the norm of each
    parameter's change over all the steps, over its ``moving`` elements:
    those whose first gradient is at least ``ROUND_OFF`` times the median
    parameter's root-mean-square gradient. The others (a key's bias under
    softmax, whose gradient is nought) move under Adam by round-off alone;
    ``moving`` holds each parameter's mask of them (given, those masks are
    used instead: a control takes the reference's)."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = o["b1"], o["b2"], o["eps"]
    losses: List[float] = []
    first: Dict[str, float] = {}
    for count, (batch, labels) in enumerate(batches):
        model.train()
        loss = F.cross_entropy(model(batch).float(), labels.long())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for g, p in zip(grads, params)]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.clamp(o["clip"] / torch.clamp(norm, min=1e-16),
                            max=1.0)
        grads = [g * scale for g in grads]
        if count == 0:
            norms = torch.stack([g.norm() for g in grads])
            first = dict(zip(names, norms.tolist()))
            rms = norms / torch.tensor([math.sqrt(g.numel()) for g in grads],
                                       device=norms.device)
            floor = ROUND_OFF * float(rms.median())
            if moving is None:
                moving = [g.abs() >= floor for g in grads]
        lr = learning_rate(o, count)
        bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                p.sub_(lr * (u + o["weight_decay"] * p))
        losses.append(float(loss.detach()))
        del grads
    change = dict(zip(names, torch.stack(
        [(p.detach() - s)[m].norm() for p, s, m in zip(params, start,
                                                        moving)]).tolist()))
    return {"losses": losses, "first_grad": first, "change": change,
            "moving": dict(zip(names, moving))}


@torch.no_grad()
def log_probs(model: nn.Module, batch: dict) -> torch.Tensor:
    """float32 log-probabilities of the deterministic forward."""
    model.eval()
    return torch.log_softmax(model(batch).float(), dim=-1)
