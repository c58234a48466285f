"""The port's offline tools (mme_tpu_torch/cli/preprocess.py and
cli/keyframes.py) against mme_tpu's, on MELD-style CSVs, WAV and mp4
files the tests write.

Tolerances: exact. The same CSVs give the same frame (``assert_frame_equal``),
the same pickle, the same warnings and the same refusals; the same videos
give the same keyframe folders with JPEG files equal byte for byte (both
call the same OpenCV functions on the same frames).
"""

import os
import wave

import numpy as np
import pandas as pd
import pytest

cv2 = pytest.importorskip("cv2")

from mme_tpu.cli import keyframes as j_keyframes
from mme_tpu.cli import preprocess as j_preprocess

from mme_tpu_torch.cli import keyframes, preprocess

from test_torch_videodec import write_mp4


@pytest.fixture(scope="module")
def meld(tmp_path_factory):
    """Three MELD CSVs with disjoint dialogue ids, a WAV per utterance, a
    speaker and a sarcasm column, an unknown emotion and one of the two
    utterances the reference drops."""
    root = tmp_path_factory.mktemp("meld")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(0)
    emotions = ["neutral", "joy", "anger", "sadness", "Frustrated"]
    k = 0
    for csvname, base, n_dialog in (("train_sent_emo.csv", 0, 3),
                                    ("dev_sent_emo.csv", 10, 2),
                                    ("test_sent_emo.csv", 20, 2)):
        recs = []
        for d in range(base, base + n_dialog):
            for u in range(3):
                recs.append({"Utterance": f"hello number {k}",
                             "Emotion": emotions[k % 5].capitalize(),
                             "Sentiment": ("positive", "negative",
                                           "neutral")[k % 3],
                             "Dialogue_ID": d, "Utterance_ID": u,
                             "Left": k % 2 == 0,
                             "Sarcasm": ("TRUE", "false", 1, 0)[k % 4]})
                with wave.open(str(wavs / f"dia{d}_utt{u}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes((rng.randn(800 + 160 * (k % 5)) * 3000)
                                  .astype(np.int16).tobytes())
                k += 1
        if base == 0:
            recs.append({"Utterance": "dropped", "Emotion": "neutral",
                         "Sentiment": "neutral", "Dialogue_ID": 110,
                         "Utterance_ID": 7, "Left": True, "Sarcasm": 0})
        pd.DataFrame(recs).to_csv(root / csvname, index=False)
    return root


CASES = {
    "splits_from_names": [],
    "media_and_flags": ["--video_dir", "{root}/mp4s", "--keep_bad",
                        "--speaker_col", "Left", "--sarcasm_col", "Sarcasm"],
    "one_split": ["--split", "train", "--audio_pattern",
                  "{{split}}/dia{{dialog}}_utt{{utterance}}.wav"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_jax(case, meld, tmp_path, capsys):
    root = str(meld)
    csvs = [os.path.join(root, n) for n in ("train_sent_emo.csv",
                                             "dev_sent_emo.csv",
                                             "test_sent_emo.csv")]
    extra = [a.format(root=root) for a in CASES[case]]
    frames, printed = [], []
    for mod, name in ((preprocess, "port"), (j_preprocess, "jax")):
        out = str(tmp_path / f"{name}.pkl")
        df = mod.main(csvs + ["--out", out, "--audio_dir",
                              os.path.join(root, "wavs")] + extra)
        pd.testing.assert_frame_equal(df, pd.read_pickle(out))
        frames.append(df)
        printed.append(capsys.readouterr().out.replace(out, "OUT"))
    pd.testing.assert_frame_equal(frames[0], frames[1])
    assert printed[0] == printed[1]
    df = frames[0]
    assert (df.emotion_label == "frustrated").any()
    assert ((df.dialog == 110) & (df.utterance == 7)).any() == \
        ("--keep_bad" in extra)
    if case == "splits_from_names":
        assert set(df.split) == {"train", "val", "test"}
        assert (df.audio_shape > 0).all()


def test_preprocess_refusals_match_jax(meld, tmp_path):
    """A media path claimed by two splits (a split-blind pattern over the
    train and dev CSVs), and a CSV with no rows, end both with the same
    ``SystemExit`` and write nothing."""
    train, dev = (str(meld / n) for n in ("train_sent_emo.csv",
                                          "dev_sent_emo.csv"))
    empty = tmp_path / "empty.csv"
    pd.DataFrame(columns=["Utterance", "Emotion", "Sentiment", "Dialogue_ID",
                          "Utterance_ID"]).to_csv(empty, index=False)
    out = tmp_path / "nope.pkl"
    for argv in ([train, dev, "--audio_dir", "a", "--audio_pattern",
                  "same.wav"], [str(empty)]):
        msgs = []
        for mod in (preprocess, j_preprocess):
            with pytest.raises(SystemExit) as err:
                mod.main(argv + ["--out", str(out)])
            msgs.append(str(err.value))
            assert not out.exists()
        assert msgs[0] == msgs[1]


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_keyframes_match_jax(tmp_path, capsys):
    """Two clips (one on two rows), one path that does not decode: the
    same counts, the same folders and JPEG files byte for byte."""
    a = write_mp4(tmp_path / "dia0_utt0.mp4", 24, seed=1)
    b = write_mp4(tmp_path / "dia1_utt2.mp4", 10, seed=2)
    pkl = tmp_path / "rows.pkl"
    pd.DataFrame({"video_path": [a, a, b, str(tmp_path / "missing.mp4")],
                  "split": ["train", "train", "test", "val"]}).to_pickle(pkl)
    results, trees = [], []
    for mod, name in ((keyframes, "port"), (j_keyframes, "jax")):
        out = str(tmp_path / name)
        res = mod.main([str(pkl), "--out_root", out, "--num_frames", "6"])
        assert res.pop("pattern") == os.path.join(
            out, "{split}_KeyFrameFolder", "{name}", "*.jpg")
        results.append(res)
        trees.append(_tree(out))
        capsys.readouterr()
    assert results[0] == results[1] == {"done": 2, "failed": 1}
    assert trees[0].keys() == trees[1].keys()
    assert sorted(trees[0]) == sorted(
        [f"train_KeyFrameFolder/dia0_utt0/frame_{i:03d}.jpg"
         for i in range(6)]
        + [f"test_KeyFrameFolder/dia1_utt2/frame_{i:03d}.jpg"
           for i in range(6)])
    assert all(trees[0][k] == trees[1][k] for k in trees[0])
