"""The benchmark's CPU tests: the harness and the reference import from
``benchmark/``, the program from the repository's root."""

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH))
                if p not in sys.path]


def _small(e: dict) -> dict:
    return dict(e, hidden=32, heads=4, layers=2, intermediate=64)


def tiny(config: dict) -> dict:
    """A configuration at a size the CPU runs in seconds: every encoder 2
    layers of 32 wide, 3 convs of 8 channels, 32x32 clips of 4 frames,
    computing in float32 (the CPU rounds bfloat16 otherwise than the card,
    so the card's limits hold only the card's bfloat16)."""
    from harness.common import load
    c = copy.deepcopy(load("configs", config))
    c["compute_dtype"] = "float32"
    c["text"].update(vocab_size=101, max_positions=80,
                     encoder=_small(c["text"]["encoder"]))
    c["video"].update(image_size=32, patch_size=8, num_frames=4,
                      encoder=_small(c["video"]["encoder"]))
    c["hidden"] = 32
    c["inputs"]["text_len"] = 16
    if "audio" in c:
        c["audio"].update(conv_dims=[8, 8, 8], conv_kernels=[10, 3, 3],
                          conv_strides=[5, 2, 2],
                          encoder=_small(c["audio"]["encoder"]))
        c["fusion"] = _small(c["fusion"])
        c["video_keep_k"] = 4
        c["inputs"].update(audio_samples=2000, sample_rate=400)
    return c


def tiny_cell(name: str) -> dict:
    """A cell at the small size."""
    from harness.common import cell
    c = cell(name)
    c["config"] = tiny(c["config"]["name"])
    c["traffic"] = dict(c["traffic"], pool=min(c["traffic"]["pool"], 32),
                        trace_units=2, warmup_chunks=1)
    return c
