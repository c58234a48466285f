"""The CLIs' pickle branch read with ``pickle.load``
(``mme_tpu_torch/cli/common.py::pickle_splits``), and the H100 timing
tools ``mme_tpu_torch/flash_crossover.py`` and ``profile_towers.py`` at
tiny shapes on the CPU through their ``device`` argument.

``pickle_splits`` gives the same splits, labels, label map and first batch
from a pickled frame and from a pickled plain mapping of columns (what the
card's machine, which has no pandas, can write): with the split column
(one partition missing, carved from train), without it (the stratified
75/12.5/12.5 split), and through the audio-length and label-drop
filters. The frame's splits are JAX's (``mme_tpu/data/records.py``).
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from mme_tpu.data import records as j_records

from mme_tpu_torch import flash_crossover, profile_towers
from mme_tpu_torch.cli.common import pickle_splits
from mme_tpu_torch.data.dataset import batches
from mme_tpu_torch.data.records import (PickleDatasetConfig,
                                        build_text_dataset, get_tokenizer)
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.ops.audio import conv_output_lengths

torch.set_num_threads(2)

EMOTIONS = ["neutral", "joy", "sadness", "anger", "surprise", "fear",
            "disgust"]


def _columns(n, split, seed=0):
    rng = np.random.RandomState(seed)
    cols = {
        "text": np.array([f"utterance {i} says {rng.randint(1000)}"
                          for i in range(n)]),
        "emotion": np.array([EMOTIONS[i] for i in rng.randint(7, size=n)]),
        "dialog": rng.randint(0, n // 4, size=n),
        "audio_shape": rng.randint(5000, 20000, size=n),
    }
    cols["emotion_label"] = cols["emotion"].copy()
    if split:
        cols["split"] = np.array(["train"] * (n - n // 4) + ["test"]
                                 * (n // 4))
    return cols


def _write(tmp_path, name, obj):
    path = tmp_path / name
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


@pytest.mark.parametrize("split,filtered", [(True, False), (False, False),
                                            (False, True)])
def test_pickle_splits_frame_and_mapping_agree(tmp_path, split, filtered):
    cols = _columns(96, split)
    frame = _write(tmp_path, "frame.pkl", pd.DataFrame(cols))
    mapping = _write(tmp_path, "mapping.pkl", cols)
    tok = get_tokenizer(None, 512)
    out = []
    for path in (frame, mapping):
        rcfg = PickleDatasetConfig(seed=7, text_max_len=12,
                                   min_audio_shape=8000 if filtered else None,
                                   drop_labels=("fear",) if filtered else ())
        out.append(pickle_splits(path, rcfg,
                                 lambda x: build_text_dataset(x, rcfg, tok),
                                 filtered=filtered))
    (*f_splits, f_names), (*m_splits, m_names) = out
    assert f_names == m_names and len(f_names) == (6 if filtered else 7)
    for f, m in zip(f_splits, m_splits):
        assert len(f) == len(m) > 0
        np.testing.assert_array_equal(f.labels, m.labels)
        np.testing.assert_array_equal(f.dialog_ids, m.dialog_ids)
        for key in f.features:
            np.testing.assert_array_equal(f.features[key], m.features[key])
        order = np.arange(len(f))
        fb, mb = next(batches(f, order, 8)), next(batches(m, order, 8))
        for key in fb[0]:
            np.testing.assert_array_equal(fb[0][key], mb[0][key])
        np.testing.assert_array_equal(fb[1], mb[1])
    # the frame's splits are JAX's
    df = pd.DataFrame(cols)
    jcfg = j_records.PickleDatasetConfig(
        seed=7, min_audio_shape=8000 if filtered else None,
        drop_labels=("fear",) if filtered else ())
    if filtered:
        df = j_records.apply_filters(df, jcfg)
    for j_part, f in zip(j_records.split_dataframe(df, jcfg), f_splits):
        assert len(j_part) == len(f)


def test_flash_crossover_on_the_cpu(capsys):
    rows = flash_crossover.run(shapes=((2, 2, 16, 64), (1, 3, 24, 64)),
                               device="cpu", steps=1, windows=1)
    assert [(r["B"], r["H"], r["S"], r["D"]) for r in rows] == [
        (2, 2, 16, 64), (1, 3, 24, 64)]
    for r in rows:
        assert all(isinstance(r[k], float) and r[k] > 0
                   for k in ("flash", "plain", "sdpa"))
        # the wrappers run their plain versions on the CPU: no launch
        assert r["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_flash_legs_agree_on_the_cpu():
    """The three legs compute one function: their bf16 gradients agree
    within two bf16 steps at their largest magnitude (|g| < 8: 2 · 2^-5;
    measured one)."""
    q, k, v, keep = flash_crossover._inputs(2, 2, 16, 64,
                                            torch.device("cpu"), seed=0)
    legs = flash_crossover._legs(q, k, v, keep)
    plain = legs["plain"]()
    for name in ("flash", "sdpa"):
        for got, want in zip(legs[name](), plain):
            assert want.abs().max() < 8
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2 * 2 ** -5, rtol=0)


def test_profile_towers_on_the_cpu():
    report = profile_towers.run(TAVSpec(output_dim=7).tiny(), device="cpu",
                                batch=2, steps=1, windows=1, text_len=12,
                                audio_len=4000)
    spec = TAVSpec(output_dim=7).tiny()
    fusion = 12 + int(conv_output_lengths(
        torch.tensor([4000]), spec.audio.conv_kernels,
        spec.audio.conv_strides)[0]) + spec.video_keep_k
    video = spec.video.num_patches - spec.video_keep_k
    assert set(report["ms"]) == {
        "text_tower", "audio_tower_with_conv", f"video_tower_{video}",
        f"fusion_trunk_{fusion}", "full_model_fwd_bwd", "adamw_update"}
    assert all(v > 0 for v in report["ms"].values())
    assert report["n_params"] > 0 and report["card"] is None
    assert report["utt_per_sec_full_fwd_bwd"] > 0
