"""The port's serving path (mme_tpu_torch/serve.py) against mme_tpu/serve.py,
the port's independence from JAX, and its device default.

Tolerances: probabilities agree to 1e-5 in fp32 (the model logits agree to
~1e-6 at this size, see test_torch_model.py) and predictions exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mme_tpu import serve as j_serve
from mme_tpu.models import fusion as j_fusion

from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.serve import Predictor, _batched_call, _pad_rows
from mme_tpu_torch.train.build_tav import example_tav_batch

torch.set_num_threads(2)

SPEC = TAVSpec().tiny()
J_SPEC = j_fusion.TAVSpec().tiny()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests():
    """11 ragged utterances with uint8 video (a chunk of 4 pads 1 row)."""
    b = example_tav_batch(SPEC, 11, 12, 4000, seed=3)
    b["video"] = np.clip(b["video"] * 64 + 128, 0, 255).astype(np.uint8)
    b["video"][4, 1] = 0                  # an all-zero (padding) frame
    b["text_mask"][1::3, 6:] = 0
    b["audio_mask"][::2, 2200:] = 0
    return b


@pytest.fixture(scope="module")
def params():
    # numpy draws at flax's scales (convert.init_params): jit-compiling
    # JAX's init would cost every pytest worker that takes a test of this
    # file ~10 s; test_torch_model.py holds the drawn tree against JAX's
    return init_params(SPEC, 0)


def _jax_predictor(params, **kw):
    model = j_fusion.TAVModel(J_SPEC)

    def apply_fn(variables, batch, deterministic=True, rngs=None):
        return model.apply(variables, batch, deterministic=deterministic,
                           rngs=rngs)

    return j_serve.Predictor(apply_fn, params, batch_size=4, **kw)


def _port_model(params):
    model = TAVModel(SPEC, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    return model


def test_predictor_matches_jax_on_ragged_uint8_requests(params):
    reqs = _requests()
    want_preds, want_probs = _jax_predictor(params)(reqs)
    preds, probs = Predictor(_port_model(params), batch_size=4,
                             device="cpu")(reqs)
    assert preds.shape == (11,) and probs.shape == (11, 7)
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs, want_probs, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(preds, want_preds)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_predictor_bf16_weights_match_jax(params):
    """param_dtype=bf16 stores the weights rounded to bf16; the compute
    stays fp32, so both sides round the same weights."""
    reqs = {k: v[:5] for k, v in _requests().items()}
    _, want = _jax_predictor(params, param_dtype=jnp.bfloat16)(reqs)
    _, got = Predictor(_port_model(params), batch_size=4, device="cpu",
                       param_dtype=torch.bfloat16)(reqs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_batched_call_pads_chunks_and_drops_padding():
    seen = []

    def forward(chunk):
        seen.append(chunk["x"].shape)
        s = chunk["x"].sum(-1)
        return (s > 0).astype(np.int64), np.stack([s, -s], -1)

    x = np.arange(22, dtype=np.float32).reshape(11, 2)
    preds, probs = _batched_call(forward, {"x": x}, 4)
    assert seen == [(4, 2)] * 3
    np.testing.assert_array_equal(probs[:, 0], x.sum(-1))
    assert preds.shape == (11,)
    np.testing.assert_array_equal(_pad_rows(x[:3], 4)[3], 0)


def test_default_device_raises_without_cuda(monkeypatch):
    """Entry points default to cuda and never fall back to the CPU: with no
    card visible, the default raises and device='cpu' works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAVModel(SPEC)
    model = TAVModel(SPEC, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)
    Predictor(model, device="cpu")


_BLOCKED_IMPORT = """
import importlib, os, pkgutil, sys
import wave as wavemod
# any import of these now raises: the JAX side, and the media libraries the
# card's machine lacks
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "mme_tpu", "pandas",
             "cv2", "PIL", "transformers", "safetensors", "ml_dtypes",
             "yaml"):
    sys.modules[name] = None
import mme_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mme_tpu_torch.__path__,
                                              "mme_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import numpy as np, torch
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.serve import Predictor
from mme_tpu_torch.train.build_tav import example_tav_batch
spec = TAVSpec().tiny()
model = TAVModel(spec, device="cpu")
model.load_state_dict(from_flax(init_params(spec, 0)))
preds, probs = Predictor(model, batch_size=2, device="cpu")(
    example_tav_batch(spec, 3, 8, 4000))
assert probs.shape == (3, 7) and np.isfinite(probs).all()
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.train.build_tav import build_tav
cfg = ExperimentConfig(batch_size=2, text_max_len=8, audio_max_samples=4000)
_, state, train_step, eval_step = build_tav(spec, cfg, 10, device="cpu")
batch = example_tav_batch(spec, 2, 8, 4000)
labels, mask, cw = np.array([0, 1]), np.ones(2, np.int32), np.ones(7, "f")
state, loss, cm, norm = train_step(state, batch, labels, mask, cw, 1.0,
                                   True, 0)
assert np.isfinite(loss.item()) and int(cm.sum()) == 2 and state.step == 1
assert np.isfinite(eval_step(batch, labels, mask, cw)[0].item())
from mme_tpu_torch.cli.tav_nn import main
summary = main(["--dataset", "synthetic", "-e", "1", "-b", "8"], device="cpu")
assert np.array(summary["test/confusion_matrix"]).sum() == 16
from mme_tpu_torch.cli import audio_nn_wav2vec, images_nn, visual_nn
from mme_tpu_torch.convert import init_variables
from mme_tpu_torch.models.audio import Wav2Vec2Classifier, Wav2Vec2Spec
from mme_tpu_torch.models.video import SlowR50
w2v = Wav2Vec2Classifier(audio_nn_wav2vec.tiny_spec(Wav2Vec2Spec.base()), 4,
                         device="cpu")
w2v.load_state_dict(from_flax(**init_variables(w2v)))
w2v.eval()
wave = torch.randn(2, 4000)
assert w2v(wave, torch.ones(2, 4000, dtype=torch.int32)).shape == (2, 4)
slow = SlowR50(3, stage_sizes=(1, 1, 1, 1), device="cpu")
slow.load_state_dict(from_flax(**init_variables(slow)))
assert slow(torch.rand(2, 2, 32, 32, 3)).shape == (2, 3)
summary = images_nn.main(["--dataset", "synthetic", "-e", "1", "-b", "16"],
                         device="cpu")
assert np.array(summary["test/confusion_matrix"]).sum() == 16
# the parallel axes: the runtime, the mesh and the ring, on one rank
assert {"mme_tpu_torch.parallel.distributed", "mme_tpu_torch.parallel.mesh",
        "mme_tpu_torch.parallel.data", "mme_tpu_torch.parallel.launch",
        "mme_tpu_torch.parallel.pipeline",
        "mme_tpu_torch.ops.ring_attention"} <= set(mods)
from mme_tpu_torch.ops.attention import dot_product_attention_shd
from mme_tpu_torch.ops.ring_attention import ring_attention
from mme_tpu_torch.parallel import distributed
from mme_tpu_torch.parallel.mesh import make_mesh
assert distributed.maybe_initialize() is False
one = make_mesh(1, 1, axis_names=("dp", "sp"))
qkv = torch.randn(3, 2, 8, 2, 64)
for flash in (False, True):
    torch.testing.assert_close(
        ring_attention(*qkv, one, "sp", use_flash=flash),
        dot_product_attention_shd(*qkv, use_flash=False))
# the WAV decoder from the port's own source, into a directory of its own,
# then a file decoded through it and the data path's host pieces
from mme_tpu_torch.data import records, wavio
from mme_tpu_torch.ops.resample import resample_numpy
assert wavio.SOURCE == os.path.join(os.path.dirname(mme_tpu_torch.__file__),
                                    "native", "wavio.cpp")
build = os.path.join(os.getcwd(), "wavio_build")     # under tmp_path
lib, cmd = wavio.build_library(build)
assert cmd is not None and cmd[-1] == wavio.SOURCE
assert os.path.dirname(lib) == build and os.path.exists(lib)
x = (np.sin(np.arange(4410) / 7.0) * 12000).astype("<i2")
with wavemod.open(os.path.join(build, "a.wav"), "wb") as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(44100)
    w.writeframes(x.tobytes())
y = wavio.load_waveform(os.path.join(build, "a.wav"))
assert wavio.FALLBACKS == 0 and y.shape == (1600,)
assert np.abs(y - resample_numpy(x / 32768.0, 44100, 16000)).max() < 1e-5
ids, mask = records.tokenize_texts(["a b c"], 8,
                                   records.get_tokenizer(None, 100))
assert ids.shape == (1, 8) and mask.sum() == 5
# a .safetensors checkpoint through the port's own reader, and a BF16
# tensor, which numpy has no dtype for, refused as safetensors.numpy does
import json, struct
from mme_tpu_torch.models import pretrained
os.makedirs("ckpt")
tensors = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": np.array([1, -2], np.int64), "c": np.array(True)}
chip_smoke.write_safetensors(os.path.join("ckpt", "model.safetensors"),
                             tensors, {"format": "pt"})
got = pretrained.load_local_state_dict("ckpt")
assert got.keys() == tensors.keys()
assert all(got[k].dtype == v.dtype and np.array_equal(got[k], v)
           for k, v in tensors.items())
head = json.dumps({"w": {"dtype": "BF16", "shape": [2],
                         "data_offsets": [0, 4]}}).encode()
with open("bf16.safetensors", "wb") as f:
    f.write(struct.pack("<Q", len(head)) + head + bytes(4))
try:
    pretrained.load_local_state_dict("bf16.safetensors")
    raise AssertionError("a BF16 tensor was read")
except TypeError as e:
    assert str(e) == "data type 'bfloat16' not understood", e
# the sweeps read the configs without PyYAML; the alignment's trellis and
# the two timing tools are modules of the package
assert {"mme_tpu_torch.sweep", "mme_tpu_torch.cli.sweep",
        "mme_tpu_torch.data.alignment", "mme_tpu_torch.cli.align",
        "mme_tpu_torch.flash_crossover",
        "mme_tpu_torch.profile_towers"} <= set(mods)
from mme_tpu_torch.sweep import SweepConfig, iter_trials
cfg = SweepConfig.from_yaml(os.path.join(os.environ["PYTHONPATH"],
                                         "configs", "bert.yaml"))
assert cfg.program == "mme_tpu.cli.text_nn" and cfg.method == "bayes"
assert next(iter_trials(cfg, 1))["clip"] in (0.25, 1, 5)
assert len(mods) >= 63, mods
print(len(mods), "modules")
"""


def test_port_runs_with_jax_blocked(tmp_path):
    """Every port module imports (the parallel axes' too, with ring
    attention on a one-rank mesh), and serving, the train step, a
    one-epoch synthetic run of the TAV CLI and of ``images_nn``, the audio
    classifier and SlowR50 on drawn weights, and the WAV decoder built from
    the port's own source work, and a ``.safetensors`` checkpoint loads
    through ``models/pretrained.py`` (a BF16 tensor refused as
    ``safetensors.numpy`` refuses it), with JAX, flax, optax, orbax,
    mme_tpu, ml_dtypes, safetensors, PyYAML and the media libraries (pandas,
    cv2, PIL, transformers) blocked; the new modules of the sweeps, the
    alignment and the timing tools import, and ``configs/bert.yaml`` parses (the CLIs write their checkpoints under
    tmp_path)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout
