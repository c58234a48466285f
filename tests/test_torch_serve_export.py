"""The port's serving exports (mme_tpu_torch/serve.py: predict_dataset,
export_bundle, load_bundle, ExportedPredictor; the operators of
ops/kernels.py::define_op) against mme_tpu/serve.py.

Mechanics run on a toy module, the counterpart of JAX's ``toy_apply`` with
the same numpy weights. The full path runs on the tiny TAV, exported once
per file. Tolerances: ``predict_dataset`` against JAX's within 1e-5 (the
model logits agree to ~1e-6 at this size, test_torch_model.py); a bundle
against the live port ``Predictor`` within 1e-6 (the same ops on the same
weights, traced); predictions equal.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from mme_tpu import serve as j_serve
from mme_tpu.data.dataset import ArrayDataset as JArrayDataset
from mme_tpu.models import fusion as j_fusion
from mme_tpu.train import build_tav as j_build

from mme_tpu_torch.cli import serve as cli_serve
from mme_tpu_torch.cli import tav_nn
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.data.synthetic import synthetic_tav_dataset
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.ops.attention import (additive_mask,
                                         dot_product_attention_shd)
from mme_tpu_torch.ops.flash_attention import (flash_attention_fwd_plain,
                                               flash_fwd_op)
from mme_tpu_torch.ops.fused_mlp import fused_mlp_fwd_op
from mme_tpu_torch.ops.layer_norm import layer_norm_fwd_op
from mme_tpu_torch.ops.video import normalize_uint8_video, uniform_keep_mask
from mme_tpu_torch.serve import (BUNDLE_FORWARD, BUNDLE_META, Predictor,
                                 export_bundle, load_bundle)
from mme_tpu_torch.train.build_tav import (example_tav_batch,
                                           make_video_keep_transform)

torch.set_num_threads(2)

SPEC = TAVSpec().tiny()
J_SPEC = j_fusion.TAVSpec().tiny()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = {0: "neg", 1: "neu", 2: "pos"}
OPS = ("flash_fwd", "layer_norm_fwd", "fused_mlp_fwd")


# --- the toy classifier, both sides -----------------------------------

def toy_params():
    rng = np.random.RandomState(7)
    return {"w": rng.randn(5, 16).astype(np.float32),
            "b": rng.randn(16).astype(np.float32),
            "head": rng.randn(16, 3).astype(np.float32)}


def toy_apply(variables, batch, deterministic=True, rngs=None):
    h = batch["x"] @ variables["params"]["w"] + variables["params"]["b"]
    return jnp.tanh(h) @ variables["params"]["head"]


class Toy(nn.Module):
    """tanh(x w + b) head, computed in fp32 from weights of any dtype (JAX
    promotes a bf16 weight against fp32 x)."""

    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, batch):
        h = batch["x"] @ self.w.float() + self.b.float()
        return torch.tanh(h) @ self.head.float()


def test_bundle_round_trip_matches_live_predictor(tmp_path):
    x = np.random.RandomState(0).randn(11, 5).astype(np.float32)
    live = Predictor(Toy(toy_params()), batch_size=4, device="cpu")
    p_live, pr_live = live({"x": x})
    export_bundle(live.model, {"x": x}, str(tmp_path / "b"), batch_size=4,
                  id2label=LABELS, device="cpu")
    served = load_bundle(str(tmp_path / "b"), device="cpu")
    p_exp, pr_exp = served({"x": x})
    np.testing.assert_array_equal(p_exp, p_live)
    np.testing.assert_allclose(pr_exp, pr_live, rtol=1e-6, atol=1e-7)
    assert served.batch_size == 4 and served.id2label == LABELS
    # and JAX's live predictor on the same weights
    j_preds, j_probs = j_serve.Predictor(
        toy_apply, {k: jnp.asarray(v) for k, v in toy_params().items()},
        batch_size=4)({"x": x})
    np.testing.assert_array_equal(p_exp, j_preds)
    np.testing.assert_allclose(pr_exp, j_probs, rtol=1e-5, atol=1e-6)


def test_bundle_files_and_meta(tmp_path):
    x = np.zeros((2, 5), np.float32)
    info = export_bundle(Toy(toy_params()), {"x": x}, str(tmp_path / "b"),
                         batch_size=2, device="cpu")
    for name in (BUNDLE_FORWARD, BUNDLE_META):
        assert os.path.exists(tmp_path / "b" / name), name
    assert info["bytes"] == os.path.getsize(tmp_path / "b" / BUNDLE_FORWARD)
    assert info["export_s"] > 0 and info["save_s"] > 0
    meta = json.loads((tmp_path / "b" / BUNDLE_META).read_text())
    assert meta["batch_size"] == 2 and meta["platforms"] == ["cpu"]
    assert meta["features"] == {"x": {"shape": [2, 5], "dtype": "float32"}}
    assert {(l["key"], tuple(l["shape"]), l["dtype"])
            for l in meta["leaves"]} == {
        ("model.w", (5, 16), "float32"), ("model.b", (16,), "float32"),
        ("model.head", (16, 3), "float32")}
    assert set(meta["knobs"]) == {"MME_FLASH", "MME_FLASH_MIN_SEQ",
                                  "MME_FUSED_LN", "MME_FUSED_MLP"}
    assert meta["ops"] == [] and meta["id2label"] is None


def test_bundle_preserves_bf16_leaves(tmp_path):
    """Weights stored bf16 (``param_dtype``) are exported bf16 and serve as
    the live predictor does; JAX's bf16 predictor rounds the same weights."""
    x = np.ones((3, 5), np.float32)
    live = Predictor(Toy(toy_params()), batch_size=4, device="cpu",
                     param_dtype=torch.bfloat16)
    export_bundle(live.model, {"x": x}, str(tmp_path / "bf16"),
                  batch_size=4, device="cpu")
    meta = json.loads((tmp_path / "bf16" / BUNDLE_META).read_text())
    assert {l["dtype"] for l in meta["leaves"]} == {"bfloat16"}
    p1, pr1 = live({"x": x})
    p2, pr2 = load_bundle(str(tmp_path / "bf16"), device="cpu")({"x": x})
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_allclose(pr2, pr1, rtol=1e-6, atol=1e-7)
    _, j_probs = j_serve.Predictor(
        toy_apply, {k: jnp.asarray(v) for k, v in toy_params().items()},
        batch_size=4, param_dtype=jnp.bfloat16)({"x": x})
    np.testing.assert_allclose(pr2, j_probs, rtol=1e-5, atol=1e-6)


def test_bundle_on_another_device_raises(tmp_path):
    """A bundle from the card asked for on the CPU names both devices and
    is not moved."""
    export_bundle(Toy(toy_params()), {"x": np.zeros((2, 5), np.float32)},
                  str(tmp_path / "b"), batch_size=2, device="cpu")
    meta_path = tmp_path / "b" / BUNDLE_META
    meta = json.loads(meta_path.read_text())
    meta["platforms"] = ["cuda"]
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=r"\['cuda'\].*cannot serve on cpu"):
        load_bundle(str(tmp_path / "b"), device="cpu")


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    """``load_bundle``, ``export_bundle`` and ``cli.serve.main`` default to
    the card and raise without one."""
    path = str(tmp_path / "b")
    export_bundle(Toy(toy_params()), {"x": np.zeros((2, 5), np.float32)},
                  path, batch_size=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bundle(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_bundle(Toy(toy_params()), {"x": np.zeros((2, 5), np.float32)},
                      str(tmp_path / "c"), batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--bundle", path, "--port", "0"])
    load_bundle(path, device="cpu")


# --- the operators ----------------------------------------------------

def _op_cases():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 9, 3, 2, 64, generator=g)
    bias = additive_mask(torch.arange(9)[None, :] < torch.tensor([[9], [5]])
                         )[:, 0, 0, :]
    x = torch.randn(6, 256, generator=g)
    return {
        "flash_fwd": (flash_fwd_op, (qkv[:, :, 0], qkv[:, :, 1],
                                     qkv[:, :, 2], bias)),
        "layer_norm_fwd": (layer_norm_fwd_op, (
            x, torch.randn(256, generator=g), torch.randn(256, generator=g),
            1e-6, torch.bfloat16)),
        "fused_mlp_fwd": (fused_mlp_fwd_op, (
            x, torch.randn(512, 256, generator=g) * 0.05,
            torch.randn(512, generator=g), torch.randn(256, 512, generator=g)
            * 0.05, torch.randn(256, generator=g), "gelu")),
    }


@pytest.mark.parametrize("name", OPS)
def test_operator_schema_and_fake(name):
    """Each operator passes ``torch.library.opcheck`` (schema, fake
    implementation against the real outputs' shapes, dtypes and strides,
    tracing) on the CPU, where its kernel is the plain version."""
    op, args = _op_cases()[name]
    assert str(op).startswith(f"mme_tpu_torch.{name}")
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


class _Attention(nn.Module):
    def forward(self, q, k, v, bias):
        return dot_product_attention_shd(q, k, v, bias[:, None, None, :],
                                         use_flash=True)


def test_exported_attention_holds_flash_op_and_plain_numbers():
    _, (q, k, v, bias) = _op_cases()["flash_fwd"]
    with torch.no_grad():
        program = torch.export.export(_Attention(), (q, k, v, bias),
                                      strict=False)
    targets = {str(n.target) for n in program.graph.nodes}
    assert "mme_tpu_torch.flash_fwd.default" in targets
    out = program.module()(q, k, v, bias)
    want, _ = flash_attention_fwd_plain(q, k, v, bias)
    assert torch.equal(out, want)
    non_flash = dot_product_attention_shd(q, k, v, bias[:, None, None, :],
                                          use_flash=False)
    torch.testing.assert_close(out, non_flash, atol=1e-6, rtol=1e-6)


# --- the tiny TAV -----------------------------------------------------

def tiny_params():
    """The tiny TAV's flax-layout parameters drawn with numpy (seed 0): the
    tree ``j_fusion.TAVModel(J_SPEC).init`` gives, without compiling it."""
    return init_params(SPEC, 0)


@functools.lru_cache(maxsize=None)
def jax_predictor():
    """JAX's ``Predictor`` of the tiny TAV at batch 4, made (and compiled)
    once per process."""
    model = j_fusion.TAVModel(J_SPEC)

    def apply_fn(variables, batch, deterministic=True, rngs=None):
        return model.apply(variables, batch, deterministic=deterministic,
                           rngs=rngs)
    return j_serve.Predictor(apply_fn, tiny_params(), batch_size=4)


@pytest.fixture(scope="module")
def params():
    return tiny_params()


def _port_model(params):
    model = TAVModel(SPEC, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    return model


def _requests(n=11, seed=3):
    """Ragged requests with normalised float video and the fixed keep-mask:
    the features a bundle of the TAV model takes."""
    b = example_tav_batch(SPEC, n, 12, 4000, seed=seed)
    u8 = np.clip(b["video"] * 64 + 128, 0, 255).astype(np.uint8)
    u8[min(4, n - 1), 1] = 0                  # an all-zero (padding) frame
    b["video"] = normalize_uint8_video(torch.from_numpy(u8)).numpy()
    b["video_keep"] = uniform_keep_mask(
        n, SPEC.video.num_patches, SPEC.video_keep_k, "cpu").numpy()
    b["text_mask"][1::3, 6:] = 0
    b["audio_mask"][::2, 2200:] = 0
    return b


@pytest.fixture(scope="module")
def tav_bundle(params, tmp_path_factory):
    """The tiny TAV exported once, with ``MME_FUSED_LN=interpret
    MME_FUSED_MLP=interpret`` (the CLI test below exports it with the knobs
    off)."""
    path = tmp_path_factory.mktemp("tav_bundle") / "bundle"
    model = _port_model(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MME_FUSED_LN", "interpret")
        mp.setenv("MME_FUSED_MLP", "interpret")
        export_bundle(model, _requests(4, seed=9), str(path), batch_size=4,
                      id2label={i: f"c{i}" for i in range(7)}, device="cpu")
    return path, model


def test_tav_bundle_matches_live_predictor(tav_bundle, monkeypatch):
    """The knobs are frozen into the program: with them now off, the
    bundle calls the LayerNorm and MLP operators by name and serves what
    the live model gives with them on (their plain versions here), and
    the knobs-off model within 1e-5."""
    path, model = tav_bundle
    meta = json.loads((path / BUNDLE_META).read_text())
    assert meta["ops"] == ["fused_mlp_fwd", "layer_norm_fwd"]
    assert meta["knobs"]["MME_FUSED_LN"] == "interpret"
    reqs = _requests()
    served = load_bundle(str(path), device="cpu")
    b_preds, b_probs = served(reqs)
    assert b_probs.shape == (11, 7) and b_probs.dtype == np.float32
    assert served.features["video"] == {"shape": [4, 4, 32, 32, 3],
                                        "dtype": "float32"}
    assert served.features["video_keep"]["dtype"] == "bool"
    # the per-cast metadata checks are stripped, the casts stay
    targets = [str(n.target) for n in served.module.graph.nodes]
    assert "aten.to.dtype" in targets
    assert not any("assert_tensor_metadata" in t for t in targets)
    _, off = Predictor(model, batch_size=4, device="cpu")(reqs)
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    preds, probs = Predictor(model, batch_size=4, device="cpu")(reqs)
    np.testing.assert_array_equal(b_preds, preds)
    np.testing.assert_allclose(b_probs, probs, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(b_probs, off, atol=1e-5, rtol=1e-5)


def test_predict_dataset_matches_jax(params):
    """Rows of 10 utterances (uint8 video, a padded last chunk) through the
    fixed-mask transform on both sides."""
    b = example_tav_batch(SPEC, 10, 12, 4000, seed=4)
    b["video"] = np.clip(b["video"] * 64 + 128, 0, 255).astype(np.uint8)
    b["text_mask"][1::3, 6:] = 0
    labels = np.arange(10) % 7
    names = {i: f"class_{i}" for i in range(7)}
    got = list(Predictor(_port_model(params), batch_size=4,
                         device="cpu").predict_dataset(
        ArrayDataset(b, labels), names,
        batch_transform=make_video_keep_transform(SPEC, random_mask=False)))

    want = list(jax_predictor().predict_dataset(
        JArrayDataset(b, labels), names,
        batch_transform=j_build.make_video_keep_transform(
            J_SPEC, random_mask=False)))
    assert len(got) == len(want) == 10
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [(r["index"], r["pred"], r["label"]) for r in got] == \
        [(r["index"], r["pred"], r["label"]) for r in want]
    np.testing.assert_allclose([r["probs"] for r in got],
                               [r["probs"] for r in want], atol=1e-5)


def test_predict_dataset_draws_from_its_generator(params):
    """A random keep-mask transform draws from the generator passed (the
    default: one seeded with 0), never from the global RNG."""
    b = _requests(5, seed=6)
    del b["video_keep"]
    ds = ArrayDataset(b, np.zeros(5, np.int64))
    pred = Predictor(_port_model(params), batch_size=4, device="cpu")
    transform = make_video_keep_transform(SPEC, random_mask=True)
    first = list(pred.predict_dataset(ds, batch_transform=transform))
    torch.manual_seed(123)
    again = list(pred.predict_dataset(ds, batch_transform=transform))
    seeded = list(pred.predict_dataset(
        ds, batch_transform=transform,
        rng=torch.Generator().manual_seed(0)))
    assert first == again == seeded
    assert "label" not in first[0]
    np.testing.assert_allclose([sum(r["probs"]) for r in first], 1.0,
                               atol=1e-5)


_BLOCKED = """
import json, sys, threading, urllib.request
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mme_tpu",
             "mme_tpu_torch.models"):
    sys.modules[name] = None          # any import of these now raises
import numpy as np
from mme_tpu_torch.serve import load_bundle
from mme_tpu_torch.serve_http import serve_bundle
server = serve_bundle(sys.argv[1], "127.0.0.1", 0, device="cpu")
threading.Thread(target=server.serve_forever, daemon=True).start()
url = "http://%s:%d" % server.server_address[:2]
meta = json.loads(urllib.request.urlopen(url + "/healthz").read())
inst = [{k: np.zeros(v["shape"][1:], v["dtype"]).tolist()
         for k, v in meta["features"].items()}] * 3
req = urllib.request.Request(url + "/predict",
                             data=json.dumps({"instances": inst}).encode())
out = json.loads(urllib.request.urlopen(req).read())["predictions"]
assert len(out) == 3 and all(r["label"] == "c%d" % r["pred"] for r in out)
assert all(abs(sum(r["probs"]) - 1) < 1e-4 for r in out)
server.shutdown()
assert sys.modules["mme_tpu_torch.models"] is None
print("served")
"""


def test_bundle_and_daemon_run_without_jax_or_model_code(tav_bundle):
    path, _ = tav_bundle
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _BLOCKED, str(path)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served" in out.stdout


# --- the CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``tav_nn.main`` on the CPU with both serving exports set; the run
    directory and checkpoints stay in a temporary directory."""
    root = tmp_path_factory.mktemp("cli_exports")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("MME_RUN_DIR", str(root))
        mp.setenv("MME_PREDICT_OUT", str(root / "predictions.jsonl"))
        mp.setenv("MME_EXPORT_BUNDLE", str(root / "bundle"))
        summary = tav_nn.main(["--dataset", "synthetic", "-e", "1", "-b",
                               "8"], device="cpu")
    return root, summary


def test_predict_out_cli_wiring(cli_run):
    root, summary = cli_run
    rows = [json.loads(l) for l in
            (root / "predictions.jsonl").read_text().splitlines()]
    assert [r["index"] for r in rows] == list(range(16))   # the test split
    for r in rows:
        assert 0 <= r["pred"] < 7 and len(r["probs"]) == 7
        assert abs(sum(r["probs"]) - 1.0) < 1e-4
        assert r["label"] in ("neutral", "joy", "sadness", "anger",
                              "surprise", "fear", "disgust")
    assert np.isfinite(summary["test/loss"])
    logs = [json.loads(l) for l in (root / "metrics.jsonl").read_text()
            .splitlines()]
    assert {"predict_out": str(root / "predictions.jsonl"), "rows": 16} in [
        {k: d.get(k) for k in ("predict_out", "rows")} for d in logs]


def test_bundle_cli_wiring(cli_run):
    """The bundle takes the post-transform features (normalised float
    video and ``video_keep``): the test split's first 8 utterances through
    the run's transform (the fixed keep-mask of ``--mask`` off) give the
    prediction log's first 8 rows."""
    root, _ = cli_run
    served = load_bundle(str(root / "bundle"), device="cpu")
    assert served.features["video"]["dtype"] == "float32"
    assert served.features["video_keep"] == {
        "shape": [8, SPEC.video.num_patches], "dtype": "bool"}
    assert served.batch_size == 8 and served.id2label[0] == "neutral"
    test_ds = synthetic_tav_dataset(SPEC, 16, text_len=16, audio_len=2000,
                                    seed=2)
    batch = make_video_keep_transform(SPEC, random_mask=False)(
        None, {k: torch.from_numpy(v[:8])
               for k, v in test_ds.features.items()})
    preds, probs = served({k: v.numpy() for k, v in batch.items()})
    rows = [json.loads(l) for l in
            (root / "predictions.jsonl").read_text().splitlines()[:8]]
    np.testing.assert_array_equal(preds, [r["pred"] for r in rows])
    np.testing.assert_allclose(probs, [r["probs"] for r in rows], atol=2e-6)
