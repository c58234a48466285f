"""Device selection shared by the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
request for ``cuda`` on a host without a card raises instead of carrying on
on the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): the rates a kernel's bound is taken against
PEAK_BF16_FLOPS = 989e12     # bf16 tensor-core FLOP/s
PEAK_FP32_FLOPS = 67e12      # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3 bytes/s


def resolve_device(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device;"
            " pass device='cpu' to run on the CPU")
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
