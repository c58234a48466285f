"""The port's HTTP daemon (mme_tpu_torch/serve_http.py) against
mme_tpu/serve_http.py: a live Predictor or a bundle behind ``http.server``,
POST /predict and GET /healthz, JSON in and out, synchronous chunking.

Mechanics run on the toy module of test_torch_serve_export.py (JAX's
``toy_apply`` with the same numpy weights); the JSON contract runs on the
tiny TAV through both packages' ``PredictionService``: predictions and
labels equal, probabilities within 1e-5 (the logits agree to ~1e-6).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch import nn

from mme_tpu.serve_http import PredictionService as JPredictionService

from mme_tpu_torch.data.records import IMAGENET_MEAN, IMAGENET_STD
from mme_tpu_torch.serve import Predictor, export_bundle
from mme_tpu_torch.serve_http import (PredictionService, make_server,
                                      serve_bundle)

from tests.test_torch_serve_export import (LABELS, Toy, _port_model,
                                           _requests, jax_predictor,
                                           tiny_params, toy_params)

torch.set_num_threads(2)


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return f"http://{host}:{port}"


def _error(url, obj):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, obj)
    return ei.value.code, json.loads(ei.value.read())["error"]


def test_http_predict_matches_direct():
    pred = Predictor(Toy(toy_params()), batch_size=4, device="cpu")
    server = make_server(PredictionService(pred, id2label=LABELS))
    try:
        url = _serve(server)
        health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        assert health == {"status": "ok", "batch_size": 4,
                          "concurrency": "synchronous chunking"}
        x = np.random.RandomState(0).randn(6, 5).astype(np.float32)
        out = _post(f"{url}/predict",
                    {"instances": [{"x": row.tolist()} for row in x]})
        preds, probs = pred({"x": x})
        got = out["predictions"]
        assert [r["pred"] for r in got] == [int(p) for p in preds]
        np.testing.assert_allclose([r["probs"] for r in got], probs,
                                   atol=1e-5)
        assert [r["label"] for r in got] == [LABELS[int(p)] for p in preds]
    finally:
        server.shutdown()


def test_http_bundle_service_and_errors(tmp_path):
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    export_bundle(Toy(toy_params()), {"x": x}, str(tmp_path / "bundle"),
                  batch_size=4, id2label=LABELS, device="cpu")
    server = serve_bundle(str(tmp_path / "bundle"), host="127.0.0.1",
                          port=0, device="cpu")
    try:
        url = _serve(server)
        # float64 JSON cast onto the spec's fp32
        out = _post(f"{url}/predict",
                    {"instances": [{"x": [0.1, 0.2, 0.3, 0.4, 0.5]}]})
        assert len(out["predictions"]) == 1
        assert set(out["predictions"][0]) == {"pred", "probs", "label"}
        code, msg = _error(f"{url}/predict", {"instances": [{"x": [1., 2.]}]})
        assert code == 400 and "shape" in msg
        code, msg = _error(f"{url}/predict", {"instances": [{"nope": [1.]}]})
        assert code == 400 and "unknown feature" in msg
        code, msg = _error(f"{url}/predict", {"instances": []})
        assert code == 400 and "empty" in msg
        code, msg = _error(f"{url}/predict", {"rows": []})
        assert code == 400 and "instances" in msg
        code, msg = _error(f"{url}/predict", {"instances": [
            {"x": [0.] * 5}, {"y": [0.] * 5}]})
        assert code == 400 and "keys" in msg
        code, _ = _error(f"{url}/elsewhere", {})
        assert code == 404
        health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        assert health["status"] == "ok" and "x" in health["features"]
    finally:
        server.shutdown()


def test_http_server_error_is_500_json():
    class Broken:
        batch_size = 2

        def __call__(self, batch):
            raise RuntimeError("device lost")

    server = make_server(PredictionService(Broken()))
    try:
        url = _serve(server)
        code, msg = _error(f"{url}/predict", {"instances": [{"x": [1.]}]})
        assert code == 500 and "device lost" in msg
    finally:
        server.shutdown()


def test_http_concurrent_requests():
    """The threading server and the service's lock: concurrent clients all
    get their own answers."""
    pred = Predictor(Toy(toy_params()), batch_size=4, device="cpu")
    server = make_server(PredictionService(pred))
    try:
        url = _serve(server)
        rng = np.random.RandomState(2)
        xs = [rng.randn(3, 5).astype(np.float32) for _ in range(6)]
        want = [[int(p) for p in pred({"x": x})[0]] for x in xs]
        got = [None] * len(xs)

        def worker(i):
            out = _post(f"{url}/predict",
                        {"instances": [{"x": r.tolist()} for r in xs[i]]})
            got[i] = [r["pred"] for r in out["predictions"]]

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(len(xs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert got == want
    finally:
        server.shutdown()


class _VideoToy(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w))

    def forward(self, batch):
        return batch["video"].reshape(batch["video"].shape[0], -1) @ self.w


def test_http_integer_video_routes_to_uint8_normalization(tmp_path):
    """Integer video in [0, 255] reaches a live Predictor as uint8 and
    matches a client that normalised to fp32; out-of-range integers, and
    integer video for a bundle, are a 400."""
    rng = np.random.RandomState(9)
    T, S = 2, 4
    w = rng.randn(T * S * S * 3, 3).astype(np.float32)
    pred = Predictor(_VideoToy(w), batch_size=4, device="cpu")
    vid = rng.randint(1, 256, (2, T, S, S, 3))
    vf = ((vid.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
    export_bundle(pred.model, {"video": vf.astype(np.float32)},
                  str(tmp_path / "b"), batch_size=4, device="cpu")
    server = make_server(PredictionService(pred))
    bundle_server = serve_bundle(str(tmp_path / "b"), "127.0.0.1", 0,
                                 device="cpu")
    try:
        url, bundle_url = _serve(server), _serve(bundle_server)
        out_int = _post(f"{url}/predict", {"instances": [
            {"video": v.tolist()} for v in vid]})
        out_f32 = _post(f"{url}/predict", {"instances": [
            {"video": v.tolist()} for v in vf]})
        assert [r["pred"] for r in out_int["predictions"]] == \
            [r["pred"] for r in out_f32["predictions"]]
        np.testing.assert_allclose(
            [r["probs"] for r in out_int["predictions"]],
            [r["probs"] for r in out_f32["predictions"]], atol=1e-4)
        code, msg = _error(f"{url}/predict", {"instances": [
            {"video": (vid[0] + 300).tolist()}]})
        assert code == 400 and "outside" in msg
        code, msg = _error(f"{bundle_url}/predict", {"instances": [
            {"video": vid[0].tolist()}]})
        assert code == 400 and "live Predictor" in msg
        out_b = _post(f"{bundle_url}/predict", {"instances": [
            {"video": v.tolist()} for v in vf]})
        np.testing.assert_allclose(
            [r["probs"] for r in out_b["predictions"]],
            [r["probs"] for r in out_f32["predictions"]], atol=1e-6)
    finally:
        server.shutdown()
        bundle_server.shutdown()


def test_service_json_matches_jax():
    """One payload (3 utterances, normalised float video, the keep-mask as
    JSON booleans) through the port's and JAX's service around the tiny
    TAV."""
    b = _requests(3, seed=8)
    payload = {"instances": [{k: v[i].tolist() for k, v in b.items()}
                             for i in range(3)]}
    names = {i: f"class_{i}" for i in range(7)}
    got = PredictionService(
        Predictor(_port_model(tiny_params()), batch_size=4, device="cpu"),
        id2label=names).predict_json(payload)["predictions"]
    want = JPredictionService(jax_predictor(), id2label=names).predict_json(
        payload)["predictions"]
    assert [(r["pred"], r["label"]) for r in got] == \
        [(r["pred"], r["label"]) for r in want]
    np.testing.assert_allclose([r["probs"] for r in got],
                               [r["probs"] for r in want], atol=1e-5)
