"""Typed experiment configuration and the reference CLI flag contract.

Port of ``mme_tpu/core/config.py``: ``ExperimentConfig`` with every flag of
the reference's ``arg_parse`` (names, short options, defaults and types),
the loop policy fields ``log_val`` and ``checkpoint_dir``, and the
``MeshConfig`` / ``PrecisionConfig`` trees kept as data; ``arg_parse``,
``config_from_args`` and ``apply_sweep_overrides``.

``config_from_args`` joins the multi-process runtime when
``MME_COORDINATOR`` / ``MME_NUM_PROCESSES`` ask for it
(``parallel/distributed.py``), as JAX's does. ``MME_PRNG`` picks a JAX
random-number implementation and is ignored: the port draws from
``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.parallel.distributed import maybe_initialize


def hidden_layer_count(string: str) -> List[int]:
    """Comma-separated hidden-layer dims: one dim or an even count."""
    x = string.split(",")
    if len(x) == 1 or len(x) % 2 == 0:
        return list(map(int, x))
    raise ValueError(
        "Missing a dimension in hidden layers. Need an even number of "
        f"dimensions (or exactly one): {string}")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout, kept as data until the port has parallel axes."""

    data: int = -1  # -1 → all available devices on the `dp` axis
    model: int = 1  # tensor-parallel axis size
    axis_names: Sequence[str] = ("dp", "mp")


@dataclass(frozen=True)
class PrecisionConfig:
    """Mixed-precision policy: params fp32, compute bf16."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"


@dataclass(frozen=True)
class ExperimentConfig:
    # --- reference flag contract (names/defaults from arg_parse) ---
    learning_rate: float = 0.000001
    epoch: int = 3
    batch_size: int = 1
    weight_decay: float = 0.0001
    clip: float = 1.0
    epoch_switch: int = 2
    patience: float = 10.0
    T_max: int = 2                  # cosine warm-restart period, in epochs
    mask: bool = False
    loss: str = "NewCrossEntropy"
    beta: float = 1.0
    seed: int = 32
    dataset: str = "../data/text_audio_video_emotion_data"
    model: str = "MAE_encoder"
    label_task: str = "emotion"
    input_dim: int = 2
    output_dim: int = 7
    lstm_layers: int = 1
    hidden_layers: str = "32,32"
    early_div: bool = False
    dropout: float = 0.5
    num_layers: int = 12
    learn_PosEmbeddings: bool = True

    # --- loop policy ---
    log_val: int = 2400             # mid-epoch validation cadence, in steps
    checkpoint_dir: str = "checkpoints"

    # --- additions of the JAX package ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    text_max_len: int = 70          # tokenizer pad length
    audio_max_samples: int = 160000  # static audio bucket cap (10 s @ 16 kHz)
    video_frames: int = 16
    video_size: int = 224

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def hidden_layer_dims(self) -> List[int]:
        return hidden_layer_count(self.hidden_layers)


def _str2bool(v: Any) -> bool:
    """Boolean flag parser: the words, not Python's truthiness (under the
    reference's ``type=bool``, ``--mask False`` parsed as True)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def arg_parse(description: str, argv: Optional[Sequence[str]] = None):
    """Reference-compatible CLI parser (flags, shorts, defaults preserved)."""
    parser = ArgumentParser(description=f" Run experiments on {description} ")
    parser.add_argument("--learning_rate", "-l", default=0.000001, type=float,
                        help="Set the learning rate")
    parser.add_argument("--epoch", "-e", default=3, type=int,
                        help="Set the number of epochs")
    parser.add_argument("--batch_size", "-b", default=1, type=int,
                        help="Set the batch_size")
    parser.add_argument("--weight_decay", "-w", default=0.0001, type=float,
                        help="Set the weight_decay")
    parser.add_argument("--clip", "-c", default=1.0, type=float,
                        help="Set the gradient clip")
    parser.add_argument("--epoch_switch", "-es", default=2, type=int,
                        help="Epoch parity for sampler/loss/accum switching")
    parser.add_argument("--patience", "-p", default=10.0, type=float,
                        help="Set the patience")
    parser.add_argument("--T_max", "-t", default=2, type=int,
                        help="Cosine warm-restart period")
    parser.add_argument("--mask", "-ma", default=False, type=_str2bool,
                        help="True/False on if we want to use masking in model")
    parser.add_argument("--loss", "-ls", default="NewCrossEntropy", type=str,
                        help="Which loss function to use")
    parser.add_argument("--beta", "-beta", default=1, type=float,
                        help="For FBeta loss, what beta to pick")
    parser.add_argument("--seed", "-s", default=32, type=int,
                        help="Set the random seed")
    parser.add_argument("--dataset", "-d",
                        default="../data/text_audio_video_emotion_data",
                        help="Dataset name or folder")
    parser.add_argument("--model", "-m", default="MAE_encoder",
                        help="The model we are using currently")
    parser.add_argument("--label_task", "-lt", default="emotion",
                        help="Classification label: emotion or sentiment")
    parser.add_argument("--input_dim", "-z", default=2, type=int,
                        help="Set the input dimension")
    parser.add_argument("--output_dim", "-y", default=7, type=int,
                        help="Set the output dimension")
    parser.add_argument("--lstm_layers", "-ll", default=1, type=int,
                        help="Number of LSTM layers")
    parser.add_argument("--hidden_layers", "-o", default="32,32", type=str,
                        help="Dims of each hidden layer")
    parser.add_argument("--early_div", "-ed", default=False, type=_str2bool,
                        help="Divide by sqrt(d) before (True) or after QK^T")
    parser.add_argument("--dropout", "-dr", default=0.5, type=float,
                        help="Dropout rate")
    parser.add_argument("--num_layers", "-nl", default=12, type=int,
                        help="Number of fusion transformer layers")
    parser.add_argument("--learn_PosEmbeddings", "-lpe", default=True,
                        type=_str2bool,
                        help="Learn the modality/positional embeddings")
    return parser.parse_args(argv)


def config_from_args(args: Any, device: DeviceLike = "cuda",
                     **overrides: Any) -> ExperimentConfig:
    """A typed config from an argparse namespace (or any attribute bag).
    ``MME_MP=<n>`` / ``MME_DP=<n>`` fill ``cfg.mesh`` as in JAX
    (``cli/common.py::auto_mesh`` builds the ``("dp", "mp")`` mesh from
    it). A multi-process run
    (``MME_COORDINATOR`` / ``MME_NUM_PROCESSES`` / ``MME_PROCESS_ID``)
    joins its process group here (``parallel/distributed.py::
    maybe_initialize``), before any work, as JAX's does; its backend
    follows ``MME_DIST_BACKEND``, else the caller's ``device``.
    ``MME_CHECKPOINT_DIR`` sets ``checkpoint_dir`` (a port addition: the
    sweep gives each parallel worker its own)."""
    maybe_initialize(device=device)
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    ckpt_dir = os.environ.get("MME_CHECKPOINT_DIR")
    if ckpt_dir:
        kw["checkpoint_dir"] = ckpt_dir
    kw.update(overrides)
    cfg = ExperimentConfig(**kw)
    mp = int(os.environ.get("MME_MP", "0") or 0)
    dp = int(os.environ.get("MME_DP", "0") or 0)
    if mp > 1 or dp > 0:
        cfg = cfg.replace(mesh=dataclasses.replace(
            cfg.mesh, model=max(mp, 1), data=dp if dp > 0 else -1))
    return cfg


def apply_sweep_overrides(cfg: ExperimentConfig,
                          sweep: Dict[str, Any]) -> ExperimentConfig:
    """Overlay a sweep-parameter dict on a typed config; keys that are not
    fields are ignored."""
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return cfg.replace(**{k: v for k, v in sweep.items() if k in fields})
