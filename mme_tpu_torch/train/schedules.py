"""Learning-rate schedules as step → lr functions.

Port of ``mme_tpu/train/schedules.py``: torch's
``CosineAnnealingWarmRestarts(T_0=T_max)`` stepped with fractional epochs,
and the epoch-granular ``CosineAnnealingLR``. The step is a Python number:
the port's optimizer runs eagerly and keeps its count on the host.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warm_restarts(base_lr: float, t_0: int, steps_per_epoch: int,
                         t_mult: int = 1, eta_min: float = 0.0
                         ) -> Callable[[int], float]:
    """SGDR: lr = eta_min + (base − eta_min)/2 · (1 + cos(π·T_cur/T_0)),
    ``t_0`` in epochs, T_cur the fractional epoch modulo ``t_0``."""
    if t_mult != 1:
        raise ValueError("only t_mult=1 is supported")

    def schedule(step: int) -> float:
        t_cur = math.fmod(step / steps_per_epoch, t_0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t_cur / t_0))
        return eta_min + (base_lr - eta_min) * cos

    return schedule


def cosine_annealing(base_lr: float, t_max: int, steps_per_epoch: int,
                     eta_min: float = 0.0) -> Callable[[int], float]:
    """Non-restarting cosine (torch ``CosineAnnealingLR``), epoch-granular."""

    def schedule(step: int) -> float:
        t_cur = min(math.floor(step / steps_per_epoch), t_max)
        cos = 0.5 * (1.0 + math.cos(math.pi * t_cur / t_max))
        return eta_min + (base_lr - eta_min) * cos

    return schedule
