"""The port's CLI (mme_tpu_torch/cli/{common,tav_nn}.py) against mme_tpu's.

``run_classifier`` on the tiny TAV with every dropout and SpecAugment rate
at 0 and the fixed keep-mask, so both sides are deterministic, from one
flax parameter tree: 24/8/8 samples, batch 8, two epochs (the weighted
sampler with plain loss, then sequential with class weights), validation
every 2 steps. The train split carries no dialog ids here: dialog
accumulation would make JAX compile a second train step (13 s of this
file's budget); the loop's accumulation is held against JAX's in
tests/test_torch_loop.py. Every logged dict of both runs
(train, val and test): confusion matrices equal, losses and gradient norms
within 1e-4 relative (fp32 sums in other orders through every layer,
forward and backward, over six Adam steps), scores within 1e-5. An
eval-only run on the checkpoint reproduces the test summary (1e-6). The
helpers match JAX's exactly; every knob the port lacks raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.cli import common as j_common
from mme_tpu.core.config import ExperimentConfig as JConfig
from mme_tpu.data.synthetic import synthetic_tav_dataset as j_synthetic
from mme_tpu.models import fusion as j_fusion
from mme_tpu.train import build_tav as j_build

from mme_tpu_torch.cli import common, tav_nn
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import from_flax, init_params
from mme_tpu_torch.data.synthetic import synthetic_tav_dataset
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.train.build_tav import make_video_keep_transform

from tests.test_torch_loop import assert_logs_match
from tests.test_torch_train import _quiet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(epoch=2, batch_size=8, log_val=2, learning_rate=1e-4,
           dataset="synthetic", mask=False)
SPEC = _quiet(TAVSpec().tiny())
J_SPEC = _quiet(j_fusion.TAVSpec().tiny())


def _data(fn, spec):
    train, val, test = (fn(spec, n, text_len=16, audio_len=2000, seed=s)
                        for n, s in ((24, 0), (8, 1), (8, 2)))
    train.dialog_ids = None
    return train, val, test


def _jsonl(d):
    return [{k: v for k, v in json.loads(line).items()
             if not k.startswith("_")}
            for line in open(os.path.join(d, "metrics.jsonl"))]


def _port_model(params):
    model = TAVModel(SPEC, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's run_classifier from one parameter tree:
    (params, jax summary, jax logs, port summary, port logs, port dir, jax
    dir); JAX also dumps its test predictions."""
    params = init_params(SPEC, 0)
    mp = pytest.MonkeyPatch()
    mp.setenv("MME_MESH", "off")           # one device, as the port
    mp.setenv("MME_DUMP_PREDICTIONS", "1")
    try:
        jdir = str(tmp_path_factory.mktemp("jax_run"))
        model = j_fusion.TAVModel(J_SPEC)

        def apply_fn(variables, batch, deterministic=True, rngs=None,
                     mutable=None):
            return model.apply(variables, batch, deterministic=deterministic,
                               rngs=rngs)

        want = j_common.run_classifier(
            JConfig(**CFG, checkpoint_dir=jdir), apply_fn,
            jax.tree.map(jnp.asarray, params), *_data(j_synthetic, J_SPEC),
            batch_transform=j_build.make_video_keep_transform(
                J_SPEC, random_mask=False),
            rng_names=("dropout", "spec_augment"))
    finally:
        mp.undo()
    pdir = str(tmp_path_factory.mktemp("port_run"))
    got = common.run_classifier(
        ExperimentConfig(**CFG, checkpoint_dir=pdir), _port_model(params),
        *_data(synthetic_tav_dataset, SPEC),
        batch_transform=make_video_keep_transform(SPEC, random_mask=False),
        device="cpu")
    return params, want, _jsonl(jdir), got, _jsonl(pdir), pdir, jdir


def test_run_classifier_matches_jax(runs):
    _, want, want_logs, got, got_logs, _, _ = runs
    # 2 epochs x 2 log points x (train, val), then the test pass
    assert len(got_logs) == 9
    assert [sorted(d) for d in got_logs] == [sorted(d) for d in want_logs]
    assert_logs_match(got_logs, want_logs)
    assert got["test/confusion_matrix"] == want["test/confusion_matrix"]
    np.testing.assert_allclose(got["test/loss"], want["test/loss"],
                               rtol=1e-4)
    assert got["test/confusion_matrix"] != [[0] * 7] * 7


def test_eval_only_reproduces_the_test_summary(runs, monkeypatch):
    """... and its prediction dump is JAX's test pass, line for line."""
    params, _, _, got, _, pdir, jdir = runs
    monkeypatch.setenv("MME_EVAL_ONLY", "1")
    monkeypatch.setenv("MME_DUMP_PREDICTIONS", "1")
    monkeypatch.setenv("MME_RUN_DIR", os.path.join(pdir, "eval_only"))
    other = init_params(SPEC, 1)             # weights the restore replaces
    again = common.run_classifier(
        ExperimentConfig(**CFG, checkpoint_dir=pdir), _port_model(other),
        *_data(synthetic_tav_dataset, SPEC),
        batch_transform=make_video_keep_transform(SPEC, random_mask=False),
        device="cpu")
    assert again["test/confusion_matrix"] == got["test/confusion_matrix"]
    np.testing.assert_allclose(again["test/loss"], got["test/loss"],
                               rtol=1e-6)
    with open(os.path.join(pdir, "eval_only", "MAE_encoderTest.txt")) as f:
        dump = f.read()
    with open(os.path.join(jdir, "MAE_encoderTest.txt")) as f:
        assert dump == f.read() and dump.count("\n") == 8
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        common.run_classifier(
            ExperimentConfig(**CFG, checkpoint_dir=pdir + "_empty"),
            _port_model(other), *_data(synthetic_tav_dataset, SPEC),
            device="cpu")


def test_main_prints_reference_keyed_dicts(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    summary = tav_nn.main(["--dataset", "synthetic", "-e", "1", "-b", "8"],
                          device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    keys = set().union(*lines)
    for k in ("train/loss", "train/grad_norm", "train/multiF1/neutral",
              "val/loss", "val/confusion_matrix", "val/weighted-f1-score",
              "test/acc", "test/multiAcc/disgust", "test/confusion_matrix"):
        assert k in keys, k
    assert np.array(summary["test/confusion_matrix"]).sum() == 16
    assert os.path.exists(tmp_path / "checkpoints" / "best_meta.json")


@pytest.mark.parametrize("case", [
    ("env", "MME_MESH", "item 7"), ("env", "MME_MP", "item 7"),
    ("env", "MME_DP", "item 7"), ("env", "MME_SP", "item 7"),
    ("env", "MME_PP", "item 7"), ("env", "MME_COORDINATOR", "item 7"),
    ("env", "MME_NUM_PROCESSES", "item 7"),
    ("env", "MME_PRETRAINED", "item 6"),
    ("pickle", "exists", "item 3")])
def test_knobs_left_for_later_raise(case, tmp_path, monkeypatch):
    kind, what, item = case
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic", "-e", "1", "-b", "8"]
    if kind == "env":
        monkeypatch.setenv(what, {"MME_MESH": "on"}.get(what, "2"))
    else:
        open(tmp_path / "meld.pkl", "wb").close()
        argv[1] = str(tmp_path / "meld")
    with pytest.raises(NotImplementedError, match=item):
        tav_nn.main(argv, device="cpu")


def test_missing_pickle_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="not found"):
        tav_nn.main(["--dataset", str(tmp_path / "meld")], device="cpu")


@pytest.mark.parametrize("name", ["MAE_encoder", "TAVForMAE", "NoSuchModel"])
def test_model_flag_falls_back_to_tav_model(name, tmp_path, monkeypatch,
                                            capsys):
    seen = {}

    def capture(cfg, model, *a, **k):
        seen["model"], seen["device"] = model, k["device"]
        return {}

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tav_nn, "run_classifier", capture)
    monkeypatch.setenv("MME_SCAN_LAYERS", "1")
    monkeypatch.setenv("MME_SHARE_FRONTEND", "1")
    tav_nn.main(["--dataset", "synthetic", "-m", name], device="cpu")
    assert type(seen["model"]) is TAVModel
    assert seen["model"].spec.share_audio_frontend
    assert seen["device"] == torch.device("cpu")
    assert "MME_SCAN_LAYERS: no eager counterpart" in capsys.readouterr().out


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tav_nn.main(["--dataset", "synthetic"])
    out = subprocess.run(
        [sys.executable, "-m", "mme_tpu_torch.cli.tav_nn", "--dataset",
         "synthetic"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO))
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_helpers_match_jax(monkeypatch, capsys):
    for ds in ("synthetic", "iemocap_x", "mustard.pkl", "hateful", "meld"):
        for task in ("emotion", "sentiment", "sarcasm"):
            for dim in (2, 3, 7, 9):
                assert (common.label_names(ds, task, dim)
                        == j_common.label_names(ds, task, dim))
    lm = {"joy": 1, "anger": 0}
    assert common.invert_label_map(lm) == j_common.invert_label_map(lm)
    assert common.invert_label_map(None) is None
    d = {"a": 0.123456, "b": [1, 2], "c": 3}
    common.print_log(d)
    j_common.print_log(d)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]
    for env in ("", "off", "500,1000,2000"):
        monkeypatch.setenv("MME_BUCKETS", env)
        for default_on in (True, False):
            a = common.make_bucket_iter(2000, default_on)
            b = j_common.make_bucket_iter(2000, default_on)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.bucket_bounds == b.bucket_bounds
