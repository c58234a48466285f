"""What every model's file uses to build the system under test through the
program's own entry points (``benchmark/models/<model>.py``: its
``build_trainer`` and ``build_predictor``): the environment a cell runs
in, the program's specs made from the configuration file key by key, the
experiment settings, and the training entry as the loop drives it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import torch


def clean_env(config: dict) -> None:
    """Drop whatever the environment says to the program (``MME_*``), so
    each cell runs its defaults, and set what the configuration settles:
    the optimizer state's dtype."""
    for k in [k for k in os.environ if k.startswith("MME_")]:
        del os.environ[k]
    os.environ["MME_OPT_STATE"] = config.get("opt_state", "fp32")


def encoder_spec(e: dict):
    from mme_tpu_torch.models.layers import EncoderSpec
    return EncoderSpec(hidden=e["hidden"], heads=e["heads"],
                       layers=e["layers"], intermediate=e["intermediate"],
                       ln_style=e["ln_style"], qkv_bias=e["qkv_bias"],
                       ln_eps=e["ln_eps"], final_ln=e.get("final_ln", False),
                       dropout=e["dropout"],
                       attention_dropout=e.get("attention_dropout", 0.0))


def text_spec(t: dict):
    from mme_tpu_torch.models.text import TextEncoderSpec
    return TextEncoderSpec(vocab_size=t["vocab_size"],
                           max_positions=t["max_positions"],
                           type_vocab_size=t["type_vocab_size"],
                           pad_token_id=t["pad_token_id"],
                           position_style="roberta",
                           encoder=encoder_spec(t["encoder"]))


def video_spec(v: dict):
    from mme_tpu_torch.models.video import VideoMAESpec
    return VideoMAESpec(image_size=v["image_size"],
                        patch_size=v["patch_size"],
                        num_frames=v["num_frames"],
                        tubelet_size=v["tubelet_size"],
                        channels=v["channels"], encoder=encoder_spec(v["encoder"]))


def compute_dtype(config: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[config["compute_dtype"]]


def experiment(c: dict, seed: int, batch: int):
    from mme_tpu_torch.config import ExperimentConfig
    o = c["optimizer"]
    return ExperimentConfig(
        batch_size=batch, learning_rate=o["learning_rate"],
        weight_decay=o["weight_decay"], clip=o["clip"], T_max=o["T_max"],
        mask=c["inputs"].get("mask", False), dropout=c["head_dropout"],
        output_dim=c["output_dim"], seed=seed,
        text_max_len=c["inputs"]["text_len"],
        audio_max_samples=c["inputs"].get("audio_samples", 160000))


@dataclasses.dataclass
class Trainer:
    """The training entry as the loop drives it."""

    model: torch.nn.Module
    state: Any
    step: Callable
    transform: Optional[Callable]   # (generator, batch) → batch
    names: List[str]                # the configuration's parameter names
    b1: float

    def first_grad_norms(self) -> torch.Tensor:
        """Per parameter, the norm of the first gradient as the optimizer
        got it, from its first moment after one step: mu / (1 - b1)."""
        mu = self.state.opt_state.mu
        return torch.stack([m.float().norm() for m in mu]) / (1.0 - self.b1)

    def changes(self, start: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Each parameter's change since ``start``, fp32, on the host."""
        total = sum(p.numel() for p in self.state.params)
        flat = torch.empty(total, dtype=torch.float32)
        out, off = {}, 0
        with torch.no_grad():
            for n, p in zip(self.names, self.state.params):
                k = p.numel()
                flat[off:off + k].copy_((p.detach().float()
                                         - start[n]).reshape(-1))
                out[n] = flat[off:off + k].view(p.shape)
                off += k
        return out


def checked_names(names: List[str], weights) -> List[str]:
    """``names`` (the program's parameters under the configuration's
    names), refused unless they are exactly the drawn weights'."""
    if sorted(names) != sorted(weights):
        raise ValueError("the program's parameters are not the "
                         "configuration's")
    return names
