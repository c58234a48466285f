"""Model FLOPs and the flash kernels' bounds, from a configuration's shapes.

Counted: every matrix product (2·m·n·k), attention's two products
(4·B·H·S²·D at the sequence lengths fed), and convolutions
(2·B·L_out·C_out·C_in/groups·k); norms, softmax and activations are left
out. A training step counts three forwards. Peaks are one H100 SXM's
published dense rates at 700 W.

``flash_bounds`` is a frozen copy of the port's bound arithmetic for its
flash-attention kernels (K1 forward, K2 backward), taken at the peak of
the dtype they compute in, so a roofline reads the same work whatever
implements it.

What is counted where is a model's own (``benchmark/models/<model>.py``:
``forward_flops``, ``attention_sites``); this file holds the arithmetic
they share.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def linear(tokens: int, n_in: int, n_out: int) -> int:
    return 2 * tokens * n_in * n_out


def attention(batch: int, heads: int, sq: int, sk: int, head_dim: int) -> int:
    return 4 * batch * heads * sq * sk * head_dim


def encoder_layer(batch: int, seq: int, e: dict) -> int:
    """One transformer block's forward: qkv, out, fc1, fc2, attention."""
    t, h, i = batch * seq, e["hidden"], e["intermediate"]
    return (linear(t, h, 3 * h) + linear(t, h, h) + linear(t, h, i)
            + linear(t, i, h)
            + attention(batch, e["heads"], seq, seq, h // e["heads"]))


def conv1d(batch: int, l_out: int, c_in: int, c_out: int, k: int,
           groups: int = 1) -> int:
    return 2 * batch * l_out * c_out * (c_in // groups) * k


def conv_lengths(samples: int, kernels, strides) -> List[int]:
    out, n = [], samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
        out.append(n)
    return out


def num_patches(v: dict) -> int:
    side = v["image_size"] // v["patch_size"]
    return (v["num_frames"] // v["tubelet_size"]) * side * side


def text_tower(c: dict, batch: int, length: int) -> int:
    """The text encoder and its pooler."""
    e = c["text"]["encoder"]
    return (e["layers"] * encoder_layer(batch, length, e)
            + linear(batch, e["hidden"], e["hidden"]))


def patch_embed(v: dict, batch: int) -> int:
    return linear(batch * num_patches(v),
                  v["tubelet_size"] * v["patch_size"] ** 2 * v["channels"],
                  v["encoder"]["hidden"])


def video_tower(v: dict, batch: int, tokens: int) -> int:
    """The patch embedding of every patch and the encoder over ``tokens``
    of them."""
    return (patch_embed(v, batch)
            + v["encoder"]["layers"] * encoder_layer(batch, tokens,
                                                     v["encoder"]))


def forward_flops(c: dict, batch: int) -> int:
    """One forward of the configuration's model
    (``models/<model>.py::forward_flops``)."""
    from harness.common import model
    return model(c).forward_flops(c, batch)


def train_flops(c: dict, batch: int) -> int:
    return 3 * forward_flops(c, batch)


def flash_bounds(B: int, Sq: int, Sk: int, H: int, D: int, dtype: str,
                 has_bias: bool) -> Tuple[float, float]:
    """(K1, K2) least seconds of one call: the larger of its FLOPs over the
    dtype's peak and its bytes (each input read once, each output written
    once) over HBM's rate. K1: 4·B·H·Sq·Sk·D FLOPs against q, O, k, v, the
    fp32 LSE and the key bias; K2: 10·B·H·Sq·Sk·D against q, O, dO, dq, k,
    v, dk, dv, the fp32 LSE and delta, the key bias."""
    elem = ELEM_BYTES[dtype]
    bias = B * Sk * 4 if has_bias else 0
    fwd = (4 * B * H * Sq * Sk * D,
           (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem
           + B * H * Sq * 4 + bias)
    bwd = (10 * B * H * Sq * Sk * D,
           (4 * B * Sq * H * D + 4 * B * Sk * H * D) * elem
           + 2 * B * H * Sq * 4 + bias)
    return tuple(max(f / PEAK_FLOPS[dtype], b / PEAK_BYTES)
                 for f, b in (fwd, bwd))


def attention_sites(c: dict, batch: int) -> List[Tuple[int, int, int, int,
                                                       bool]]:
    """Every attention call of one forward of the configuration's model:
    (B, S, H, D, key bias)."""
    from harness.common import model
    return model(c).attention_sites(c, batch)


def encoder_sites(e: dict, batch: int, seq: int, bias: bool
                  ) -> List[Tuple[int, int, int, int, bool]]:
    """The attention calls of one encoder stack."""
    return [(batch, seq, e["heads"], e["hidden"] // e["heads"], bias)
            ] * e["layers"]


def flash_bound_s(c: dict, batch: int, backward: bool) -> float:
    """Least seconds of one forward's K1 calls (and with ``backward`` its
    K2 calls too)."""
    total = 0.0
    for B, S, H, D, bias in attention_sites(c, batch):
        fwd, bwd = flash_bounds(B, S, S, H, D, c["compute_dtype"], bias)
        total += fwd + (bwd if backward else 0.0)
    return total
