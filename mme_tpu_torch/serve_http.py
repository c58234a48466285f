"""Standard-library HTTP serving daemon around the batched predictors.

Port of ``mme_tpu/serve_http.py``. A live :class:`~mme_tpu_torch.serve.
Predictor` or a bundle (:func:`~mme_tpu_torch.serve.load_bundle`) behind
``http.server`` alone:

    POST /predict   {"instances": [{<feature>: nested-list, ...}, ...]}
                 →  {"predictions": [{"pred": i, "label": "joy"?,
                                      "probs": [...]}, ...]}
    GET  /healthz   {"status": "ok", "batch_size": N, ...}

Concurrency: **synchronous chunking**. The ``ThreadingHTTPServer`` accepts
requests concurrently, but one lock serialises the device work; each
request's batch is padded and chunked to the predictor's batch size.
Integer video in [0, 255] is the uint8 request: a live ``Predictor`` keeps
it uint8 and normalises it on the device; a bundle's program takes the
normalised float video it was exported with, so there it is a 400. Request
errors are 400 and anything else 500, both as JSON.

CLI: ``python -m mme_tpu_torch.cli.serve --bundle DIR --port 8000``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.serve import Predictor, load_bundle

# JSON carries no dtype: Python's defaults go to the device-side convention
# (fp32 activations, int32 ids and masks) unless the feature spec (a
# bundle's meta) says otherwise
_DEFAULT_CASTS = {"float64": "float32", "int64": "int32"}


class PredictionService:
    """JSON ↔ predictor adapter shared by the HTTP handler and tests.

    ``predictor``: a ``Predictor`` or an ``ExportedPredictor`` (anything
    callable as ``predictor(batch) -> (preds, probs)`` with a
    ``batch_size``). ``feature_spec``: optional ``{name: {"dtype": ...,
    "shape": [...]}}``, a bundle's meta, to cast and validate instances
    with; without it only the float64 → float32 and int64 → int32 casts
    apply."""

    def __init__(self, predictor: Callable, *,
                 id2label: Optional[Dict[int, str]] = None,
                 feature_spec: Optional[Dict[str, Any]] = None):
        self.predictor = predictor
        self.id2label = id2label
        self.feature_spec = feature_spec
        self._lock = threading.Lock()

    def _to_batch(self, instances) -> Dict[str, np.ndarray]:
        if not instances:
            raise ValueError("empty instances")
        keys = set(instances[0].keys())
        for i, inst in enumerate(instances):
            if set(inst.keys()) != keys:
                raise ValueError(
                    f"instance {i} keys {sorted(inst.keys())} != "
                    f"instance 0 keys {sorted(keys)}")
        live = isinstance(self.predictor, Predictor)
        batch = {}
        for k in keys:
            arr = np.asarray([inst[k] for inst in instances])
            if k == "video" and np.issubdtype(arr.dtype, np.integer):
                if arr.min() < 0 or arr.max() > 255:
                    raise ValueError(
                        "integer video values outside [0, 255]")
                if not live:
                    raise ValueError(
                        "this bundle expects ImageNet-normalized float "
                        "video; integer pixel requests need a live "
                        "Predictor service (it normalizes on device)")
                arr = arr.astype(np.uint8)
            if self.feature_spec is not None:
                spec = self.feature_spec.get(k)
                if spec is None:
                    raise ValueError(f"unknown feature {k!r}")
                want_shape = tuple(spec["shape"][1:])
                if arr.shape[1:] != want_shape:
                    raise ValueError(
                        f"feature {k!r}: shape {arr.shape[1:]} != "
                        f"expected {want_shape}")
                want = spec["dtype"]
                keep_u8 = (arr.dtype.name == "uint8" and want == "float32"
                           and live)
                if not keep_u8:
                    arr = arr.astype(want)
            if arr.dtype.name in _DEFAULT_CASTS:
                arr = arr.astype(_DEFAULT_CASTS[arr.dtype.name])
            batch[k] = arr
        return batch

    def predict_json(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        instances = payload.get("instances")
        if not isinstance(instances, list):
            raise ValueError('payload must be {"instances": [...]}')
        batch = self._to_batch(instances)
        with self._lock:                 # synchronous chunking
            preds, probs = self.predictor(batch)
        out = []
        for i in range(len(instances)):
            row: Dict[str, Any] = {
                "pred": int(preds[i]),
                "probs": [round(float(x), 6) for x in probs[i]]}
            if self.id2label:
                row["label"] = self.id2label.get(int(preds[i]),
                                                 str(int(preds[i])))
            out.append(row)
        return {"predictions": out}

    def health(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"status": "ok",
                                "batch_size": self.predictor.batch_size,
                                "concurrency": "synchronous chunking"}
        if self.feature_spec is not None:
            info["features"] = self.feature_spec
        return info


def _make_handler(service: PredictionService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                self._reply(200, service.predict_json(payload))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — answer, don't crash
                self._reply(500, {"error": repr(e)})

        def log_message(self, fmt, *args):   # quiet by default
            pass

    return Handler


def make_server(service: PredictionService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 → a free port; read ``server.server_address``). Run
    with ``server.serve_forever()``, stop with ``shutdown()``."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve_bundle(bundle_dir: str, host: str = "0.0.0.0", port: int = 8000,
                 device: DeviceLike = "cuda") -> ThreadingHTTPServer:
    """A server for a bundle directory on ``device`` (no model code)."""
    pred = load_bundle(bundle_dir, device)
    service = PredictionService(pred, id2label=pred.id2label,
                                feature_spec=pred.features)
    return make_server(service, host, port)
