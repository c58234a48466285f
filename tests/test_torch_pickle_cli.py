"""The pickle branch of the port's four CLIs (tav_nn, audio_nn_wav2vec,
text_nn, visual_nn) on a toy pickle of the records contract, on the CPU at
their tiny specs: each trains one epoch and tests, and hands
``run_classifier`` the same splits, label names and records as
mme_tpu/data/records.py's builders give on the same pickle with JAX's CLI
settings.

Tolerances: exact (splits, ids, token ids, uint8 and float video, and the
waves of one decoder source built with the same flags: JAX's is pointed at
a build of ``native/wavio.cpp`` in the test's own directory).
"""

import os
import shutil
import subprocess
import wave as wavemod

import numpy as np
import pandas as pd
import pytest
import torch

from PIL import Image

from mme_tpu.data import glove as j_glove
from mme_tpu.data import records as j_rec
from mme_tpu.data import wavio as j_wavio

from mme_tpu_torch.cli import audio_nn_wav2vec, tav_nn, text_nn, visual_nn
from mme_tpu_torch.data import wavio
from mme_tpu_torch.data.dataset import BucketedBatchIter

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
NAMES = ["anger", "joy", "neutral"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(pickle path, frame, keyframe glob pattern, GloVe file)."""
    d = tmp_path_factory.mktemp("pickle_cli")
    rng = np.random.RandomState(0)
    wavs = []
    for i in range(4):
        sr = (16000, 44100)[i % 2]
        t = np.arange(int(sr * (0.08 + 0.05 * i))) / sr
        x = 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t)
        p = str(d / f"u{i}.wav")
        with wavemod.open(p, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((x * 32767).astype(np.int16).tobytes())
        wavs.append(p)
        k = d / f"kf{i}"
        k.mkdir()
        for j in range(1 + i % 3):
            Image.fromarray(rng.randint(0, 255, (48, 64, 3)).astype(
                np.uint8)).save(k / f"frame_{j:03d}.jpg")
    labels = rng.randint(0, 3, N)
    df = pd.DataFrame({
        "text": [f"word{l} filler text number {i}" for i, l in
                 enumerate(labels)],
        "audio_path": [wavs[i % 4] for i in range(N)],
        "emotion": [NAMES[l] for l in labels],
        "split": ["train"] * 20 + ["val"] * 6 + ["test"] * 6,
        "dialog": np.repeat(np.arange(8), 4),
        "audio_shape": np.where(np.arange(N) % 5 == 4, 9000,
                                rng.randint(20000, 50000, N)),
        "kf": [f"kf{i % 4}" for i in range(N)],
    })
    pkl = str(d / "toy.pkl")
    df.to_pickle(pkl)
    glove = str(d / "glove.txt")
    with open(glove, "w") as f:
        for w in ["word0", "word1", "word2", "filler", "text", "number"]:
            f.write(w + " " + " ".join(f"{v:.3f}" for v in rng.randn(12))
                    + "\n")
    return pkl, df, str(d / "{kf}" / "*.jpg"), glove


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_lib") / "libwavio.so")
    subprocess.run([shutil.which("g++"), *wavio.CXX_FLAGS, "-o", out,
                    os.path.join(REPO, "native", "wavio.cpp")], check=True)
    return out


@pytest.fixture
def run(tmp_path, monkeypatch, jax_native):
    """Runs a CLI's main from tmp_path on the CPU with MME_TINY; returns
    (summary, the arguments its run_classifier got)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MME_TINY", "1")
    monkeypatch.setattr(j_wavio, "_LIB_PATH", jax_native)
    monkeypatch.setattr(j_wavio, "_lib", None)

    def go(cli, argv):
        seen = {}
        real = cli.run_classifier

        def spy(cfg, model, train_ds, val_ds, test_ds, **kw):
            seen.update(kw, splits=(train_ds, val_ds, test_ds))
            return real(cfg, model, train_ds, val_ds, test_ds, **kw)

        monkeypatch.setattr(cli, "run_classifier", spy)
        summary = cli.main(argv, device="cpu")
        assert np.array(summary["test/confusion_matrix"]).sum() == len(
            seen["splits"][2])
        return summary, seen

    return go


def _same(got, want):
    for g, w in zip(got, want):
        assert sorted(g.features) == sorted(w.features)
        for k, v in w.features.items():
            assert g.features[k].dtype == v.dtype, k
            np.testing.assert_array_equal(g.features[k], v, err_msg=k)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.labels.dtype == w.labels.dtype
        if w.dialog_ids is None:
            assert g.dialog_ids is None
        else:
            np.testing.assert_array_equal(g.dialog_ids, w.dialog_ids)


def _jax(df, rcfg, build, filtered=False):
    """JAX's CLI pickle branch: filters, the label map over the frame, the
    split, the builder."""
    if filtered:
        df = j_rec.apply_filters(df, rcfg)
    rcfg.label_map = j_rec.build_label_map(df, rcfg.label_col)
    return ([build(x) for x in j_rec.split_dataframe(df, rcfg)],
            {i: n for n, i in rcfg.label_map.items()})


ARGV = ["-e", "1", "-b", "4", "-y", "3", "-s", "5", "-l", "1e-4"]


def test_tav_nn_on_a_pickle(toy, run):
    pkl, df, _, _ = toy
    summary, seen = run(tav_nn, ["--dataset", pkl, *ARGV])
    tok = j_rec.get_tokenizer(None, 101)
    rcfg = j_rec.PickleDatasetConfig(text_max_len=16, audio_max_samples=2000,
                                     seed=5, video_uint8=True)
    want, id2label = _jax(df, rcfg, lambda x: j_rec.build_tav_dataset(
        x, rcfg, 4, 32, tokenizer=tok))
    _same(seen["splits"], want)
    assert [len(s) for s in seen["splits"]] == [20, 6, 6]
    assert seen["id2label"] == id2label == dict(enumerate(NAMES))
    # length buckets on by default for a pickle: quarters of the 2000 cap
    assert isinstance(seen["batch_iter"], BucketedBatchIter)
    assert seen["batch_iter"].bucket_bounds == (1000, 1500, 2000)
    assert seen["splits"][0].features["video"].dtype == np.uint8
    assert np.isfinite(summary["test/loss"])


def test_audio_nn_on_a_pickle_filters_before_the_label_map(toy, run):
    pkl, df, _, _ = toy
    summary, seen = run(audio_nn_wav2vec, ["--dataset", pkl, *ARGV])
    rcfg = j_rec.PickleDatasetConfig(audio_max_samples=4000,
                                     min_audio_shape=10000, seed=5)
    want, id2label = _jax(df, rcfg, lambda x: j_rec.build_audio_dataset(
        x, rcfg), filtered=True)
    _same(seen["splits"], want)
    assert sum(len(s) for s in seen["splits"]) == (df["audio_shape"]
                                                   > 10000).sum() < N
    assert seen["id2label"] == id2label
    assert seen["batch_iter"].bucket_bounds == (1000, 2000, 3000, 4000)


@pytest.mark.parametrize("model", ["Bert", "LSTM", "LSTM+GloVe"])
def test_text_nn_on_a_pickle(toy, run, model, monkeypatch):
    pkl, df, _, glove = toy
    if model.endswith("GloVe"):
        monkeypatch.setenv("MME_GLOVE", glove)
        gvocab, _ = j_glove.load_glove_txt(glove, 50000)

        def tok(text, max_length=70):
            ids = j_glove.tokenize_with_vocab([text], gvocab, max_length)[0]
            return ids.tolist(), (ids != 0).astype(int).tolist()
    else:
        tok = j_rec.get_tokenizer(None, 512 if model == "Bert" else 5000)
    summary, seen = run(text_nn, ["--dataset", pkl, "-m",
                                  model.split("+")[0], *ARGV])
    rcfg = j_rec.PickleDatasetConfig(text_max_len=70, seed=5)
    want, id2label = _jax(df, rcfg, lambda x: j_rec.build_text_dataset(
        x, rcfg, tok))
    _same(seen["splits"], want)
    assert seen["id2label"] == id2label


def test_visual_nn_on_a_pickle_reads_keyframes(toy, run, monkeypatch):
    pkl, df, kf, _ = toy
    monkeypatch.setenv("MME_KEYFRAME_GLOB", kf)
    summary, seen = run(visual_nn, ["--dataset", pkl, *ARGV])
    rcfg = j_rec.PickleDatasetConfig(seed=5)
    want, id2label = _jax(df, rcfg, lambda x: j_rec.build_video_dataset(
        x, rcfg, 8, 64, keyframe_glob=kf))
    _same(seen["splits"], want)
    assert seen["id2label"] == id2label
    assert np.abs(seen["splits"][0].features["video"]).sum() > 0


def test_chip_smoke_data_path_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 11 at the tiny size on the CPU: its WAV files
    decode natively within 1e-5 of the numpy path with no fallback, and
    its records train through the length buckets of the tiny cap (every
    bound trained for at least two steps, finite losses and logits, the
    prediction log in the label map's names; its own checks raise
    SystemExit). The launch
    counts it expects on the card follow the spec: 60 K4 a step at 40 000
    samples, whose 992 audio rows stay under the gate, 114 above."""
    import chip_smoke
    from mme_tpu_torch.models.fusion import TAVSpec
    monkeypatch.setenv("MME_TINY", "1")
    monkeypatch.setenv("MME_DTYPE", "bf16")
    files = chip_smoke.write_utterances(str(tmp_path), 2000, 0)
    assert len(files) == 144 and {f["format"] for f in files} == {16, 24,
                                                                 "f32"}
    decode = chip_smoke.decode_check(files, "cpu")
    assert decode["fallbacks"] == 0
    out = chip_smoke.data_path_run(files, "cpu", str(tmp_path))
    assert out["bounds"] == [1000, 1500, 2000] == out["bounds_fed"]
    assert out["splits"] == [128, 8, 8] and out["prediction_rows"] == 8
    assert all(out["step_samples"].count(b) >= 2 for b in out["bounds"])
    spec = TAVSpec(output_dim=7)
    step = {"train": True, "rows": 8}
    n_ln = [chip_smoke.expected_launches(spec, dict(step, samples=s))[
        "layer_norm_bwd"] for s in (40000, 80000, 160000)]
    assert n_ln == [60, 114, 114]
    assert chip_smoke.expected_launches(spec, dict(
        step, train=False, samples=40000))["adam_update"] == 0
