"""The port's record building (mme_tpu_torch/data/records.py) against
mme_tpu/data/records.py on one pickled-frame contract: wav files at 44.1
and 48 kHz, JPEG keyframe directories written with PIL and mp4 clips
written with ``cv2.VideoWriter``.

Tolerances: exact. Splits, filters, label maps and token ids are the same
numbers; waveforms come from the same decoder source built with the same
flags (JAX's is pointed at a build of ``native/wavio.cpp`` in the test's
own directory) and video from the same PIL and OpenCV calls.
"""

import os
import shutil
import subprocess
import sys
import wave as wavemod

import numpy as np
import pandas as pd
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from mme_tpu.data import records as j_rec
from mme_tpu.data import wavio as j_wavio
from mme_tpu.models import pretrained as j_pretrained

from mme_tpu_torch.data import records as rec
from mme_tpu_torch.data import wavio
from mme_tpu_torch.data.dataset import ArrayDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16


def _write_wav(path, seconds, sr, channels, seed):
    n = int(sr * seconds)
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * (150 + 30 * seed) * t)[:, None] \
        + 0.1 * rng.randn(n, channels)
    with wavemod.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def _write_mp4(path, n_frames, seed):
    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                         (720, 400))
    for i in range(n_frames):
        vw.write(np.clip(rng.randint(0, 255, (400, 720, 3)) // 2 + 8 * i,
                         0, 255).astype(np.uint8))
    vw.release()


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    wavs, clips, kdirs = [], [], []
    for i in range(4):
        p = d / f"a{i}.wav"
        _write_wav(p, 0.15 + 0.1 * i, (44100, 48000)[i % 2], 1 + i % 2, i)
        wavs.append(str(p))
        c = d / f"clip{i}.mp4"
        _write_mp4(c, 12 + 4 * i, i)
        clips.append(str(c))
        k = d / f"clip{i}"
        k.mkdir()
        for j in range(2 + i):
            Image.fromarray(rng.randint(0, 255, (400, 720, 3)).astype(
                np.uint8)).save(k / f"frame_{j:03d}.jpg")
        kdirs.append(str(k))
    names = ["joy", "anger", "fear", "neutral"]
    return pd.DataFrame({
        "text": [f"Utterance {i} is about THE emotions of row {i % 5}"
                 for i in range(N)],
        "audio_path": [wavs[i % 4] for i in range(N)],
        "video_path": [clips[i % 4] for i in range(N)],
        "emotion": rng.randint(0, 3, N),
        "emotion_label": [names[i % 4] for i in range(N)],
        "sentiment": [("positive", "negative", "neutral")[i % 3]
                      for i in range(N)],
        "split": ["train"] * 10 + ["val"] * 3 + ["test"] * 3,
        "dialog": np.repeat(np.arange(4), 4),
        "audio_shape": rng.randint(5000, 20000, N),
        "speaker": [(True, False, None, np.bool_(True))[i % 4]
                    for i in range(N)],
        "timings": [(0.1 * (i % 3), 1.0 + 0.2 * (i % 2)) for i in range(N)],
        "clip": [os.path.join(kdirs[i % 4], "*.jpg") for i in range(N)],
    })


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_lib") / "libwavio.so")
    subprocess.run([shutil.which("g++"), *wavio.CXX_FLAGS, "-o", out,
                    os.path.join(REPO, "native", "wavio.cpp")], check=True)
    return out


@pytest.fixture
def same_decoder(jax_native, monkeypatch):
    monkeypatch.setattr(j_wavio, "_LIB_PATH", jax_native)
    monkeypatch.setattr(j_wavio, "_lib", None)


def _same_ds(got: ArrayDataset, want):
    assert sorted(got.features) == sorted(want.features)
    for k, v in want.features.items():
        assert got.features[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.features[k], v, err_msg=k)
    assert got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.labels, want.labels)
    if want.dialog_ids is None:
        assert got.dialog_ids is None
    else:
        np.testing.assert_array_equal(got.dialog_ids, want.dialog_ids)


def _frames_of(df):
    """The split variants of the contract, by name."""
    no_split = df.drop(columns=["split"])
    singleton = df[df["split"] != "val"].copy()
    tr = singleton["split"] == "train"
    fear = singleton.index[tr & (singleton["emotion_label"] == "fear")]
    return {
        "official": df,
        "no_val": df[df["split"] != "val"],
        "no_test": df[df["split"] != "test"],
        "train_only": df.assign(split="train"),
        "no_column": no_split,
        "only_other_values": df.assign(split="dev"),
        "singleton_class": singleton.drop(fear[1:]),
    }


@pytest.mark.parametrize("label_col", ["emotion", "emotion_label"])
@pytest.mark.parametrize("case", ["official", "no_val", "no_test",
                                  "train_only", "no_column",
                                  "only_other_values", "singleton_class"])
def test_split_dataframe_matches_jax(frame, case, label_col, capsys):
    df = _frames_of(frame)[case]
    got = rec.split_dataframe(df, rec.PickleDatasetConfig(label_col=label_col,
                                                          seed=5))
    out = capsys.readouterr().out
    want = j_rec.split_dataframe(df, j_rec.PickleDatasetConfig(
        label_col=label_col, seed=5))
    assert capsys.readouterr().out == out
    for g, w in zip(got, want):
        assert list(g.index) == list(w.index)
    assert sum(len(x) for x in got) == len(df)


def test_split_refuses_a_frame_of_held_out_rows_as_jax(frame):
    df = frame[frame["split"] != "train"]
    for mod in (rec, j_rec):
        with pytest.raises(ValueError, match="no train rows"):
            mod.split_dataframe(df, mod.PickleDatasetConfig())


def test_filters_and_label_maps_match_jax(frame):
    long = frame["audio_shape"] > 12000
    # the last: no "sentiment_label" column, so nothing is dropped
    for kw, kept in ((dict(min_audio_shape=10000),
                      (frame["audio_shape"] > 10000).sum()),
                     (dict(drop_labels=("fear",)), 12),
                     (dict(min_audio_shape=12000, drop_labels=("joy",
                                                               "anger")),
                      (long & frame["emotion_label"].isin(
                          ["fear", "neutral"])).sum()),
                     (dict(label_col="sentiment", drop_labels=("neutral",)),
                      N)):
        got = rec.apply_filters(frame, rec.PickleDatasetConfig(**kw))
        want = j_rec.apply_filters(frame, j_rec.PickleDatasetConfig(**kw))
        assert list(got.index) == list(want.index)
        assert len(got) == kept
    for col in ("emotion", "emotion_label", "sentiment"):
        got = rec.build_label_map(frame, col)
        assert got == j_rec.build_label_map(frame, col)
        part = frame[col].values[:5]
        for m in (got, None):
            ids, names = rec.labels_to_ids(part, m)
            jids, jnames = j_rec.labels_to_ids(part, m)
            assert ids.dtype == jids.dtype == np.int64
            np.testing.assert_array_equal(ids, jids)
            assert names == jnames


def test_tokenizers_match_jax(frame, monkeypatch):
    texts = frame["text"].tolist() + ["", "a " * 100]
    for vocab, max_len in ((50265, 70), (512, 16), (5000, 8)):
        h, jh = rec.HashTokenizer(vocab), j_rec.HashTokenizer(vocab)
        for t in texts:
            assert h(t, max_len) == jh(t, max_len)
        got = rec.tokenize_texts(texts, max_len, rec.get_tokenizer(None,
                                                                   vocab))
        want = j_rec.tokenize_texts(texts, max_len,
                                    j_rec.get_tokenizer(None, vocab))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    # a checkpoint that resolves nowhere (here: no transformers at all):
    # the loud hash fallback on both
    monkeypatch.delenv("MME_PRETRAINED", raising=False)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.warns(UserWarning, match="FALLING BACK TO A HASH TOKENIZER"):
        tok = rec.get_tokenizer("no-such-org/no-such-model", 777)
    jtok = j_rec.get_tokenizer("no-such-org/no-such-model", 777)
    assert tok(texts[0], 12) == jtok(texts[0], 12)
    parent, name = os.path.split(REPO)
    for root, repo_id in ((REPO, "org/tests"), (parent, f"{name}/tests"),
                          (REPO, "org/absent")):
        assert rec.find_checkpoint_dir(root, repo_id) == \
            j_pretrained.find_checkpoint_dir(root, repo_id)
    assert rec.find_checkpoint_dir(REPO, "org/tests") == os.path.join(
        REPO, "tests")


def test_keyframes_match_jax(frame):
    for kw in (dict(num_frames=4, size=32),
               dict(num_frames=2, size=16, crop_box=(5, 10, 40, 50)),
               dict(num_frames=6, size=24, normalize=False)):
        for glob in frame["clip"].unique():
            got = rec.load_keyframes(glob, **kw)
            want = j_rec.load_keyframes(glob, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_text_audio_and_video_builders_match_jax(frame, same_decoder):
    cfg = dict(text_max_len=16, audio_max_samples=6000,
               label_col="emotion_label")
    lm = rec.build_label_map(frame, "emotion_label")
    c, jc = (mod.PickleDatasetConfig(**cfg, label_map=lm)
             for mod in (rec, j_rec))
    _same_ds(rec.build_text_dataset(frame, c, rec.get_tokenizer(None, 512)),
             j_rec.build_text_dataset(frame, jc,
                                      j_rec.get_tokenizer(None, 512)))
    got = rec.build_audio_dataset(frame, c)
    _same_ds(got, j_rec.build_audio_dataset(frame, jc))
    assert got.features["audio_mask"].sum(1).max() == 6000
    for kw in (dict(keyframe_glob="{clip}"), {}):
        _same_ds(rec.build_video_dataset(frame, c, 4, 16, **kw),
                 j_rec.build_video_dataset(frame, jc, 4, 16, **kw))


def test_builders_read_a_mapping_of_columns_as_jax_reads_the_frame(
        frame, same_decoder):
    """The label map and the text, audio and TAV builders on a dict of
    column arrays (no pandas) give what JAX's give on the frame; rows
    without a video column get zero clips on both."""
    frame = frame.drop(columns=["video_path"])
    columns = {k: frame[k].to_numpy() for k in frame.columns}
    for col in ("emotion", "emotion_label"):
        assert (rec.build_label_map(columns, col)
                == j_rec.build_label_map(frame, col))
    cfg = dict(text_max_len=12, audio_max_samples=4000, video_uint8=True,
               label_col="emotion_label")
    lm = j_rec.build_label_map(frame, "emotion_label")
    c, jc = (mod.PickleDatasetConfig(**cfg, label_map=lm)
             for mod in (rec, j_rec))
    tok, jtok = rec.get_tokenizer(None, 512), j_rec.get_tokenizer(None, 512)
    _same_ds(rec.build_text_dataset(columns, c, tok),
             j_rec.build_text_dataset(frame, jc, jtok))
    _same_ds(rec.build_audio_dataset(columns, c),
             j_rec.build_audio_dataset(frame, jc))
    got = rec.build_tav_dataset(columns, c, 3, 16, tokenizer=tok)
    _same_ds(got, j_rec.build_tav_dataset(frame, jc, 3, 16, tokenizer=jtok))
    assert got.features["video"].shape == (N, 3, 16, 16, 3)


@pytest.mark.parametrize("uint8", [True, False])
def test_tav_builder_matches_jax(frame, same_decoder, uint8):
    cfg = dict(text_max_len=12, audio_max_samples=4000, video_uint8=uint8)
    c, jc = rec.PickleDatasetConfig(**cfg), j_rec.PickleDatasetConfig(**cfg)
    tok, jtok = rec.get_tokenizer(None, 512), j_rec.get_tokenizer(None, 512)
    kw = dict(video_frames=3, video_size=16)
    for extra in (dict(keyframe_glob="{clip}"),
                  dict(keyframe_glob=os.path.join(
                      os.path.dirname(frame["clip"][0]), "..", "{name}",
                      "*.jpg")),
                  {}):
        got = rec.build_tav_dataset(frame, c, tokenizer=tok, **kw, **extra)
        _same_ds(got, j_rec.build_tav_dataset(frame, jc, tokenizer=jtok,
                                              **kw, **extra))
        assert got.features["video"].dtype == (np.uint8 if uint8
                                               else np.float32)
        assert np.abs(got.features["video"].astype(np.float32)).sum() > 0
    missing = frame.assign(
        video_path=frame["video_path"].str.replace(".mp4", "_gone.mp4"))
    for mod, cc, t in ((rec, c, tok), (j_rec, jc, jtok)):
        with pytest.raises(IOError):
            mod.build_tav_dataset(missing, cc, tokenizer=t, **kw)
