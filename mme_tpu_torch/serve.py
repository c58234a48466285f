"""Batched inference serving: fixed-size chunks, padded ragged requests,
and model-code-free deployment bundles.

Port of ``mme_tpu/serve.py`` (``_pad_rows``, ``_batched_call``,
``Predictor`` with ``predict_dataset``, ``export_bundle``, ``load_bundle``,
``ExportedPredictor``). Requests come as dicts of numpy arrays with a common
leading dim; they are padded up to ``batch_size`` rows per chunk and the
padding is masked back out of the response. uint8 video is normalised on
the device. Mesh serving (``Predictor(mesh=..., batch_axis="dp")``): every
rank of the mesh runs the same chunks, computes its rows of each along the
batch axis, and the predictions and probabilities are gathered to every
rank; ``batch_size`` must divide by that axis' size, as in JAX. A model
whose tower is pipelined over a ``pp`` axis serves the same way: the ranks
of that axis take the same rows and run its stages together.

A bundle is the deterministic forward ``(argmax, fp32 softmax)`` of the
logits (a model's aux output is dropped) exported by ``torch.export`` on the
device it will serve on, written as ``forward.pt2`` (program and weights)
beside ``meta.json`` (which names the model's class). :func:`load_bundle`
serves it with no model code: it imports the port's ops (which register the
operators ``mme_tpu_torch::flash_fwd``, ``::layer_norm_fwd`` and
``::fused_mlp_fwd`` that the program calls by name), never
``mme_tpu_torch.models``. The fused knobs (``MME_FUSED_LN``,
``MME_FUSED_MLP``, ``MME_FLASH``) are read while the forward is traced and
are frozen into the program; the meta records them.

Under a ``torch.profiler`` session a ``Predictor`` records each chunk as
the span ``mme.serve.chunk`` with its phases ``mme.serve.h2d`` (the copy
to the device), ``mme.serve.transform`` (``predict_dataset``'s batch
transform), ``mme.serve.forward`` (from the normalisation to the enqueued
answers) and ``mme.serve.readback`` (the answers read to the host, which
waits for the device there); building the rows is the chunk's own time
(``utils/profiling.py``).

Use: ``p = Predictor(TAVModel(spec), batch_size=8); preds, probs = p(batch)``;
``export_bundle(model, example, "bundle")``;
``preds, probs = load_bundle("bundle")(batch)``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mme_tpu_torch.device import DeviceLike, resolve_device
# the operators a bundle's program calls, registered on import
from mme_tpu_torch.ops import (flash_attention, fused_mlp,  # noqa: F401
                               layer_norm)
from mme_tpu_torch.ops.video import normalize_uint8_video
from mme_tpu_torch.parallel.mesh import Mesh
from mme_tpu_torch.utils.profiling import span

BUNDLE_FORWARD = "forward.pt2"
BUNDLE_META = "meta.json"
# the knobs read while the forward is traced, recorded in the meta
TRACE_KNOBS = ("MME_FLASH", "MME_FLASH_MIN_SEQ", "MME_FUSED_LN",
               "MME_FUSED_MLP")


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _pad_rows_tensor(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])


def _batched_call(forward: Callable, batch: Dict[str, Any], batch_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged requests up to ``batch_size``-row chunks, run
    ``forward(chunk) -> (preds, probs)`` and drop the padding rows."""
    n = len(next(iter(batch.values())))
    preds, probs = [], []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        chunk = {k: _pad_rows(np.asarray(v[lo:hi]), batch_size)
                 for k, v in batch.items()}
        p, pr = forward(chunk)
        preds.append(p[: hi - lo])
        probs.append(pr[: hi - lo])
    return np.concatenate(preds), np.concatenate(probs)


def _to_device(chunk: Dict[str, np.ndarray], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in chunk.items()}


class _Forward(nn.Module):
    """The deterministic serving forward: ``(argmax, fp32 softmax)`` of
    ``model(batch)``'s logits; a ``(logits, aux)`` output (the MoE trunk's)
    serves its logits."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.model(batch)
        if isinstance(logits, tuple):
            logits = logits[0]
        return (torch.argmax(logits, dim=-1),
                torch.softmax(logits.float(), dim=-1))


class Predictor:
    """Fixed-shape batched predictor around a classifier ``model``
    (``model(batch) -> logits`` or ``-> (logits, aux)``, e.g.
    ``TAVModel`` or ``TAVMoEFormer``).

    ``device``: where the model runs; ``cuda`` unless the caller asks for
    the CPU. ``param_dtype=torch.bfloat16`` stores the weights in bf16 —
    half the memory; logits and probabilities stay fp32. ``mesh``: serve
    across its ranks, each computing its rows of every chunk along
    ``batch_axis`` (every rank holds the same weights, or under tensor
    parallelism its blocks of them, and makes the same calls: the ranks of
    the ``mp`` axis compute the same rows together); the results are
    gathered to every rank."""

    def __init__(self, model: nn.Module, batch_size: int = 8,
                 device: DeviceLike = "cuda",
                 param_dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None, batch_axis: str = "dp"):
        self.batch_size = int(batch_size)
        self._axis = None if mesh is None else mesh.axis(batch_axis)
        if self._axis is not None and self.batch_size % self._axis.size:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by "
                f"{batch_axis}={self._axis.size} for mesh serving")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if param_dtype is not None:
            for p in self.model.parameters():
                p.data = p.data.to(param_dtype)
        self._serving = _Forward(self.model)

    def _run(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[np.ndarray, np.ndarray]:
        with span("mme.serve.forward"):
            ax = self._axis
            if ax is not None and ax.size > 1:
                per = self.batch_size // ax.size
                batch = {k: v[ax.index * per:(ax.index + 1) * per]
                         for k, v in batch.items()}
            v = batch.get("video")
            if v is not None and v.dtype == torch.uint8:
                batch = dict(batch, video=normalize_uint8_video(v))
            with torch.inference_mode():
                preds, probs = self._serving(batch)
                if ax is not None and ax.size > 1:
                    preds, probs = ax.all_gather(preds), ax.all_gather(probs)
        with span("mme.serve.readback"):
            return preds.cpu().numpy(), probs.cpu().numpy()

    def _forward(self, chunk: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        with span("mme.serve.chunk"):
            with span("mme.serve.h2d"):
                batch = _to_device(chunk, self.device)
            return self._run(batch)

    def __call__(self, batch: Dict[str, Any]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """batch: dict of arrays with a common leading dim (larger than
        ``batch_size`` is chunked). Returns (preds [N], probs [N, C])."""
        return _batched_call(self._forward, batch, self.batch_size)

    def predict_dataset(self, dataset, id2label: Optional[Dict[int, str]]
                        = None, batch_transform: Optional[Callable] = None,
                        rng: Optional[torch.Generator] = None
                        ) -> Iterator[Dict[str, Any]]:
        """Predict an ``ArrayDataset`` (``data/dataset.py``); yields rows
        ``{"index", "pred", "probs" (6 decimals), "label"?}``.

        Streams in ``batch_size`` chunks, so only one chunk is on the
        device at a time. ``batch_transform(rng, chunk)`` (e.g. the video
        keep-mask and uint8 normalisation) runs per chunk on the device,
        before the chunk is padded; ``rng`` is the ``torch.Generator`` it
        draws from, by default one seeded with 0 on the predictor's device
        (never the global RNG)."""
        n = len(dataset)
        if rng is None and batch_transform is not None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        for lo in range(0, n, self.batch_size):
            hi = min(lo + self.batch_size, n)
            with span("mme.serve.chunk"):
                with span("mme.serve.h2d"):
                    chunk = _to_device({k: np.asarray(v[lo:hi])
                                        for k, v in dataset.features.items()},
                                       self.device)
                if batch_transform is not None:
                    with span("mme.serve.transform"):
                        chunk = batch_transform(rng, chunk)
                preds, probs = self._run(
                    {k: _pad_rows_tensor(v, self.batch_size)
                     for k, v in chunk.items()})
                rows = []
                for i in range(hi - lo):
                    row = {"index": lo + i, "pred": int(preds[i]),
                           "probs": [round(float(x), 6) for x in probs[i]]}
                    if id2label:
                        row["label"] = id2label.get(int(preds[i]),
                                                    str(preds[i]))
                    rows.append(row)
            yield from rows


def _drop_metadata_asserts(program) -> None:
    """Remove the ``aten._assert_tensor_metadata`` node that
    ``torch.export`` records beside every ``.to()`` of the model (about
    1 500 at full width). Each re-checks at every call a dtype and device
    fixed when the forward was traced, one dispatcher call of host time
    apiece; the program's inputs are still checked against the traced
    ones when it is called."""
    if not hasattr(torch.ops.aten, "_assert_tensor_metadata"):
        return
    check = torch.ops.aten._assert_tensor_metadata.default
    graph = program.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == check:
            graph.erase_node(node)
    program.graph_module.recompile()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_bundle(model: nn.Module, example_batch: Dict[str, Any],
                  path: str, *, batch_size: int = 8,
                  id2label: Optional[Dict[int, str]] = None,
                  device: DeviceLike = "cuda") -> Dict[str, float]:
    """Write a standalone serving bundle directory: ``forward.pt2`` and
    ``meta.json``.

    ``example_batch`` (numpy arrays) fixes the feature spec: shapes beyond
    the leading dim and dtypes, taken after padding or cutting it to
    ``batch_size`` rows. The forward is traced by ``torch.export.export``
    (non-strict) in eval mode without gradients on ``device``, the device
    the bundle will serve on, with the weights as they are (bf16 weights
    stay bf16), and stripped of its per-cast metadata checks
    (:func:`_drop_metadata_asserts`). A bundle is one rank's program:
    ``torch.export`` cannot trace the messages of a pipeline or a ring, so
    a model trained on a mesh is exported whole and unpipelined
    (``cli/common.py`` wraps the call in ``sharding_rules.whole_model``
    and ``models/layers.py::single_rank``). Returns the seconds of the
    export and of the save and the program file's bytes."""
    dev = resolve_device(device)
    batch_size = int(batch_size)
    feats = {k: _pad_rows(np.asarray(v)[:batch_size], batch_size)
             for k, v in example_batch.items()}
    model = model.to(dev)
    was_training = model.training
    model.eval()
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(_Forward(model),
                                          (_to_device(feats, dev),),
                                          strict=False)
        _drop_metadata_asserts(program)
        export_s = time.perf_counter() - t0
    finally:
        model.train(was_training)
    os.makedirs(path, exist_ok=True)
    forward_path = os.path.join(path, BUNDLE_FORWARD)
    t0 = time.perf_counter()
    torch.export.save(program, forward_path)
    save_s = time.perf_counter() - t0
    meta = {
        "model": type(model).__name__,
        "batch_size": batch_size,
        "platforms": [dev.type],
        "id2label": ({str(k): v for k, v in id2label.items()}
                     if id2label else None),
        "features": {k: {"shape": list(v.shape), "dtype": v.dtype.name}
                     for k, v in feats.items()},
        "leaves": [{"key": k, "shape": list(t.shape),
                    "dtype": _dtype_name(t.dtype)}
                   for k, t in program.state_dict.items()],
        "knobs": {k: os.environ.get(k) for k in TRACE_KNOBS},
        "ops": sorted({str(n.target).split(".")[1]
                       for n in program.graph.nodes
                       if str(n.target).startswith("mme_tpu_torch.")}),
    }
    with open(os.path.join(path, BUNDLE_META), "w") as fh:
        json.dump(meta, fh, indent=1)
    return {"export_s": export_s, "save_s": save_s,
            "bytes": os.path.getsize(forward_path)}


def load_bundle(path: str, device: DeviceLike = "cuda"
                ) -> "ExportedPredictor":
    """Rebuild a serving callable from an :func:`export_bundle` directory,
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    return ExportedPredictor(path, device)


class ExportedPredictor:
    """Predictor-shaped callable over a bundle: the same pad/chunk request
    handling, with the forward from the exported program — no model code
    involved. A bundle serves only on the device type it was exported on:
    asking for another raises (the program is not moved)."""

    def __init__(self, path: str, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(path, BUNDLE_META)) as fh:
            meta = json.load(fh)
        self.platforms = tuple(meta["platforms"])
        if self.device.type not in self.platforms:
            raise ValueError(
                f"bundle {path!r} was exported for {list(self.platforms)} "
                f"and cannot serve on {self.device}; export it again on "
                f"that device")
        self.batch_size = int(meta["batch_size"])
        self.features = meta["features"]
        self.ops = tuple(meta.get("ops", ()))
        self.id2label = ({int(k): v for k, v in meta["id2label"].items()}
                         if meta.get("id2label") else None)
        t0 = time.perf_counter()
        # the program as a module; its state dict holds the weights under
        # the model's names prefixed with "model."
        self.module = torch.export.load(
            os.path.join(path, BUNDLE_FORWARD)).module()
        self.load_s = time.perf_counter() - t0

    def _forward(self, chunk: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        with torch.inference_mode():
            preds, probs = self.module(_to_device(chunk, self.device))
        return preds.cpu().numpy(), probs.cpu().numpy()

    def __call__(self, batch: Dict[str, Any]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        return _batched_call(self._forward, batch, self.batch_size)
