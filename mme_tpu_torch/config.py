"""The experiment settings the train step reads.

The port's own copy of the fields of ``mme_tpu/core/config.py::
ExperimentConfig`` that ``train/build_tav.py`` uses, with the same names and
defaults; the CLI parser, mesh and precision trees are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    learning_rate: float = 0.000001
    batch_size: int = 1
    weight_decay: float = 0.0001
    clip: float = 1.0
    epoch_switch: int = 2
    T_max: int = 2                  # cosine warm-restart period, in epochs
    seed: int = 32
    text_max_len: int = 70          # tokenizer pad length
    audio_max_samples: int = 160000  # static audio bucket cap (10 s @ 16 kHz)

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
