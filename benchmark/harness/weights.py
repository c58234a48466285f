"""Weights drawn on the device from the seed, in one call.

The reference module (``models/<model>.py::reference``), built on the
``meta`` device, names every parameter
(the measured model's state-dict keys) and says what it is; one normal draw
of all of them is cut into leaves and scaled by kind: fan-in scaling for
matrices and convolutions, 1/√width for embeddings, 1 ± 0.1 for norm
scales, 0.02 for biases and bare vectors."""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from harness.common import model
from reference.towers import attention_heads, param_kinds

WEIGHT_STREAM = 0x5EED_0001


def meta_model(config: dict):
    return model(config).reference(config, device="meta")


def draw(config: dict, seed: int, device
         ) -> Tuple["OrderedDict[str, torch.Tensor]", torch.Tensor]:
    """(name → fp32 tensor on ``device``, the flat draw they are views
    of)."""
    ref = meta_model(config)
    kinds = param_kinds(ref)
    shapes = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + WEIGHT_STREAM) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    off = 0
    with torch.no_grad():
        for name, shape in shapes:
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            kind = kinds[name]
            if kind in ("linear", "qkv"):
                t.mul_(1.0 / math.sqrt(shape[1]))
            elif kind == "conv":
                t.mul_(1.0 / math.sqrt(shape[1] * shape[2]))
            elif kind == "embedding":
                t.mul_(1.0 / math.sqrt(shape[1]))
            elif kind == "norm":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.02)
            out[name] = t
    return out, flat


def flax_tree(config: dict, weights: Dict[str, torch.Tensor],
              flat: torch.Tensor) -> dict:
    """The weights as the nested flax-layout tree of host arrays that
    ``build_tav(params=...)`` takes: dense kernels [in, out], the fused
    attention kernel [hidden, 3, H, D], conv kernels [k, in, out], norm
    ``scale``, ``embedding``. Copied to the host once; the leaves are
    views."""
    ref = meta_model(config)
    kinds = param_kinds(ref)
    heads = attention_heads(ref)
    names = list(weights)
    flat = flat.cpu().numpy()
    tree: dict = {}
    off = 0
    for name in names:
        shape = tuple(weights[name].shape)
        n = int(np.prod(shape))
        a = flat[off:off + n].reshape(shape)
        off += n
        path = name.split(".")
        kind = kinds[name]
        if kind == "linear":
            a, leaf = a.T, "kernel"
        elif kind == "qkv":
            a, leaf = a.T.reshape((shape[1], 3) + heads[name]), "kernel"
        elif kind == "conv":
            a, leaf = a.transpose(2, 1, 0), "kernel"
        elif kind == "embedding":
            leaf = "embedding"
        elif kind == "norm":
            leaf = "scale"
        else:
            leaf = path[-1]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree
