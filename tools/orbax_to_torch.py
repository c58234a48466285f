"""Convert a JAX (orbax) checkpoint of ``mme_tpu`` into the port's.

``mme_tpu/train/checkpoint.py``'s manager writes a ``TrainState`` with
orbax: ``best_<n>_<host>-<pid>`` directories named by ``best_meta.json``
and the preemption slot ``latest`` with ``latest_meta.json``. This script
restores one of them (best or latest) without a target tree, turns every
scan-layout encoder (``{"layers_scan": {"block": [L, ...]}}``) back into
its ``layer_<i>`` leaves with ``mme_tpu/models/layers.py::from_scan_params``,
maps the flax trees through ``mme_tpu_torch/convert.py``'s names and
layouts, and writes the port's ``state.pt``
(``mme_tpu_torch/train/checkpoint.py::state_payload``'s layout) with its
meta file, so that the port's ``CheckpointManager.restore_best`` (or
``restore_latest``) on the output directory loads it:

- ``step`` and ``accum_count``;
- the parameters by the port's names, in the port model's order;
- the optimizer's ``count``, ``mu`` and ``nu`` (found in the optax chain as
  the Adam state: optax's ``ScaleByAdamState`` or ``mme_tpu``'s bf16
  ``ScaleByAdamLowmemState``, under a trainable mask too), in the dtype
  JAX stored them in; a leaf the mask freezes has None, as in the port;
- ``accum_grads`` where JAX holds them;
- a BatchNorm model's ``batch_stats`` as the state's ``buffers``.

The bf16 moments' stochastic rounding draws its dither from a seed of the
port's own (K3 draws it with Philox in the kernel), which cannot be
carried over from JAX's PRNG key: the state's ``seed`` is ``--seed``. A
factored second moment (``MME_OPT_STATE=factored``) is not converted.

The script needs JAX, orbax and the port's package, so it runs where JAX
is (not on the card's machine), from the repository's root::

    python tools/orbax_to_torch.py checkpoints/ port_checkpoints/ \\
        --model TAVModel [--tiny] [--output_dim 7] [--which best] [--seed 0]

``--model`` is a ``FUSION_MODELS`` name (the TAV spec, ``--tiny`` for its
tiny version) or ``package.module:function`` returning the port model the
state belongs to (built on any device, ``meta`` included). Where a CLI
wraps its network (``cli/common.py::BatchModel``, names ``net.<path>``)
the wrapper is that model; the script finds the submodule whose
parameters are the checkpoint's. From Python, :func:`convert` does the
same with a model.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mme_tpu.models.layers import from_scan_params  # noqa: E402

from mme_tpu_torch.convert import _flatten, from_flax  # noqa: E402
from mme_tpu_torch.train.checkpoint import STATE_FILE  # noqa: E402
from mme_tpu_torch.train.steps import model_buffers  # noqa: E402

OUT_BEST = "best_orbax"


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(tree)


def unscan(tree: Any) -> Any:
    """Every ``{"layers_scan": {"block": ...}}`` encoder subtree back to
    its ``layer_<i>`` leaves (L from the stacked leaves' first axis)."""
    if not isinstance(tree, dict):
        return tree
    if "layers_scan" in tree:
        stacked = tree["layers_scan"]["block"]
        n = next(a for _, a in _flatten(stacked)).shape[0]
        tree = from_scan_params(tree, n)
    return {k: unscan(v) for k, v in tree.items()}


def _prune(tree: Any) -> Any:
    """Drop the leaves a trainable mask left out (None, empty nodes)."""
    if isinstance(tree, dict):
        out = {k: _prune(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def port_tensors(tree: Any, batch_stats: Any = None
                 ) -> Dict[str, torch.Tensor]:
    """A flax tree → the port's tensors by name, in the dtype JAX stored
    each leaf in (``convert.from_flax`` gives one entry per leaf, in the
    tree's order, in fp32; a bf16 leaf goes back to bf16 exactly)."""
    tree = _prune(tree or {})
    leaves = [a for _, a in _flatten(tree)] + \
        [a for _, a in _flatten(batch_stats or {})]
    f32 = lambda t: {k: (f32(v) if isinstance(v, dict)
                         else np.asarray(v).astype(np.float32))
                     for k, v in t.items()}
    sd = from_flax(f32(tree), None if batch_stats is None
                   else f32(batch_stats))
    return {name: t.to(_torch_dtype(a))
            for (name, t), a in zip(sd.items(), leaves)}


def adam_states(opt_state: Any) -> List[Dict[str, Any]]:
    """The dicts of the optax chain holding ``count``, ``mu`` and ``nu``."""
    found = []
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            found.append(opt_state)
        else:
            for v in opt_state.values():
                found += adam_states(v)
    elif isinstance(opt_state, (list, tuple)):
        for v in opt_state:
            found += adam_states(v)
    return found


def _checkpoint_path(ckpt_dir: str, which: str) -> Tuple[str, Dict]:
    meta_file = os.path.join(ckpt_dir, f"{which}_meta.json")
    with open(meta_file) as f:
        meta = json.load(f)
    if which == "best":
        path = os.path.join(ckpt_dir, meta.pop("_data", "best"))
    else:
        path = os.path.join(ckpt_dir, "latest")
    return path, meta


def _owner(model: torch.nn.Module, names: set) -> str:
    """The prefix of the submodule whose parameters are ``names``."""
    for mod_name, mod in model.named_modules():
        if {n for n, _ in mod.named_parameters()} == names:
            return mod_name + "." if mod_name else ""
    raise ValueError("no submodule of the model has the checkpoint's "
                     f"{len(names)} parameters")


def convert(ckpt_dir: str, out_dir: str, model: torch.nn.Module,
            which: str = "best", seed: int = 0) -> str:
    """Restore ``ckpt_dir``'s ``which`` checkpoint (JAX's layout) and write
    it into ``out_dir`` in the port's, for ``model``'s state. Returns the
    directory written."""
    import orbax.checkpoint as ocp

    src, meta = _checkpoint_path(ckpt_dir, which)
    raw = _numpy_tree(ocp.StandardCheckpointer().restore(src))
    params = unscan(raw["params"])
    stats = raw.get("batch_stats")
    stats = unscan(stats) if stats else None

    flat_params = port_tensors(params)
    prefix = _owner(model, set(flat_params))
    order = [n for n, _ in model.named_parameters()]
    local = [n[len(prefix):] for n in order]

    adams = adam_states(raw["opt_state"])
    if len(adams) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, "
                         f"found {len(adams)} (a factored second moment is "
                         "not converted)")
    adam = adams[0]
    mu = port_tensors(unscan(adam["mu"]))
    nu = port_tensors(unscan(adam["nu"]))
    accum = raw.get("accum_grads")
    accum = port_tensors(unscan(accum)) if accum else None

    buffers = None
    want = model_buffers(model)
    if want:
        got = port_tensors({}, stats) if stats else {}
        buffers = {}
        for name in want:
            key = name[len(prefix):] if name.startswith(prefix) else name
            if key not in got:
                raise ValueError(f"buffer {name} is not in the checkpoint's "
                                 "batch_stats")
            buffers[name] = got[key]
    payload = {
        "step": int(raw["step"]),
        "params": {n: flat_params[k] for n, k in zip(order, local)},
        "opt_state": {"count": int(adam["count"]), "seed": int(seed),
                      "mu": [mu.get(k) for k in local],
                      "nu": [nu.get(k) for k in local],
                      "nu_row": None, "nu_col": None},
        "accum_grads": (None if accum is None
                        else [accum[k] for k in local]),
        "accum_count": int(raw.get("accum_count", 0)),
    }
    if buffers is not None:
        payload["buffers"] = buffers

    os.makedirs(out_dir, exist_ok=True)
    data = OUT_BEST if which == "best" else "latest"
    directory = os.path.join(out_dir, data)
    os.makedirs(directory, exist_ok=True)
    torch.save(payload, os.path.join(directory, STATE_FILE))
    if which == "best":
        meta = dict(meta, _data=data)
    with open(os.path.join(out_dir, f"{which}_meta.json"), "w") as f:
        json.dump(meta, f)
    return directory


def _build_model(name: str, tiny: bool, output_dim: int) -> torch.nn.Module:
    if ":" in name:
        module, fn = name.split(":", 1)
        return getattr(importlib.import_module(module), fn)()
    from mme_tpu_torch.models.fusion import FUSION_MODELS, TAVSpec
    spec = TAVSpec(output_dim=output_dim)
    if tiny:
        spec = spec.tiny()
    cls = FUSION_MODELS.get(name, FUSION_MODELS["MAE_encoder"])
    return cls(spec, device="meta")


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir", help="the JAX CheckpointManager's directory")
    p.add_argument("out_dir", help="the port CheckpointManager's directory")
    p.add_argument("--model", default="TAVModel",
                   help="a FUSION_MODELS name or package.module:function")
    p.add_argument("--tiny", action="store_true",
                   help="the TAV spec's tiny version (FUSION_MODELS names)")
    p.add_argument("--output_dim", type=int, default=7)
    p.add_argument("--which", choices=("best", "latest"), default="best")
    p.add_argument("--seed", type=int, default=0,
                   help="the port's dither seed for bf16 moments")
    args = p.parse_args(argv)
    model = _build_model(args.model, args.tiny, args.output_dim)
    out = convert(args.ckpt_dir, args.out_dir, model, args.which, args.seed)
    print(f"wrote {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
