"""The port's CTC forced alignment (``mme_tpu_torch/data/alignment.py``,
``cli/align.py``) against ``mme_tpu/data/alignment.py`` and
``mme_tpu/cli/align.py`` on the CPU.

Emissions are log-probabilities that favour planted token spans, as in
``tests/test_alignment.py``, and drawn ones. The trellis matches JAX's
``lax.scan`` within 1e-6 (both sum the same fp32 terms in the same order:
measured equal); paths, segments, bounds (the ``None`` cases included) and
the CLI's timings are equal. The CLI reads a frame or a plain mapping of
columns and writes back the same kind.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from mme_tpu.cli import align as j_align_cli
from mme_tpu.data import alignment as j_alignment

from mme_tpu_torch.cli import align as align_cli
from mme_tpu_torch.data import alignment

torch.set_num_threads(2)


def _emission_for(seq, num_frames, num_classes, spans, seed=None):
    """Log-probabilities favouring ``seq[k]`` during ``spans[k]`` and the
    blank elsewhere (plus drawn noise with a seed)."""
    em = np.full((num_frames, num_classes), -10.0, np.float32)
    em[:, 0] = -0.5
    for tok, (s, e) in zip(seq, spans):
        em[s:e, tok] = 0.0
    if seed is not None:
        em += np.random.RandomState(seed).rand(*em.shape).astype(np.float32)
    return em - np.log(np.exp(em).sum(-1, keepdims=True))


@pytest.mark.parametrize("text", [
    "Hello, World! 21", "it's 100%!", "3   dogs", "Year 1999, 42 cats",
    "123456 and 1000000", "0 or 10 or 19 or 90 or 101", "  ",
    "ÉLAN -- vital?"])
def test_normalize_transcript(text):
    assert alignment.normalize_transcript(text) == \
        j_alignment.normalize_transcript(text)


CASES = [
    ([5, 3, 7], 50, 10, [(10, 15), (20, 26), (30, 36)], None),
    ([4, 5], 40, 10, [(8, 12), (14, 18)], 1),
    ([2, 2, 6, 1], 30, 8, [(3, 6), (9, 12), (15, 20), (22, 25)], 2),
    ([3] * 10, 5, 8, [], 3),                       # cannot fit: None
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_trellis_backtrack_and_segments_equal_jax(case):
    seq, frames, classes, spans, seed = CASES[case]
    em = _emission_for(seq, frames, classes, spans, seed)
    want = np.asarray(j_alignment.ctc_trellis(jnp.asarray(em),
                                              jnp.asarray(seq)))
    got = alignment.ctc_trellis(torch.from_numpy(em),
                                torch.tensor(seq)).numpy()
    assert got.dtype == np.float32 and got.shape == (frames + 1, len(seq) + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    path = alignment.backtrack(got, em, seq)
    j_path = j_alignment.backtrack(want, em, seq)
    if j_path is None:
        assert path is None
        return
    assert [vars(p) for p in path] == [vars(p) for p in j_path]
    text = "abcdefghij"[:len(seq)]
    assert [vars(s) for s in alignment.merge_repeats(path, text)] == \
        [vars(s) for s in j_alignment.merge_repeats(j_path, text)]


CHAR2ID = {"a": 4, "b": 5, "|": 6, "c": 7}


@pytest.mark.parametrize("em,text,samples", [
    (_emission_for([4, 5], 40, 10, [(8, 12), (14, 18)]), "AB", 40 * 320),
    (_emission_for([4, 6, 7], 60, 10, [(5, 9), (20, 22), (40, 47)], 4),
     "a c", 19_000),
    (np.full((5, 10), -0.1, np.float32), "aaaaaaaaaa", 1600),   # None
    (_emission_for([4], 20, 10, [(2, 5)]), "xyz 7", 6400),     # no tokens
])
def test_utterance_bounds_equal_jax(em, text, samples):
    if text == "aaaaaaaaaa":
        em = em.copy()
        em[:, 4] = -20.0
    got = alignment.utterance_bounds(em, text, CHAR2ID, samples,
                                     device="cpu")
    assert got == j_alignment.utterance_bounds(em, text, CHAR2ID, samples)


def _align_inputs(tmp_path):
    """Three rows: an aligned one, one without an emission file, and one
    without the sample-count column's value falling back to T·320."""
    labels = tmp_path / "labels.txt"
    labels.write_text("-\n|\n'\na\nb\n")     # blank, |, ', a=3, b=4
    emdir = tmp_path / "em"
    emdir.mkdir()
    np.save(emdir / "0.npy", _emission_for([3, 4], 40, 8,
                                           [(8, 12), (14, 18)]))
    np.save(emdir / "2.npy", _emission_for([4, 1, 3], 50, 8,
                                           [(5, 9), (20, 23), (30, 38)], 6))
    return labels, emdir


def test_align_cli_equals_jax_on_frame_and_mapping(tmp_path):
    labels, emdir = _align_inputs(tmp_path)
    df = pd.DataFrame({"text": ["ab", "ba", "b a!"],
                       "audio_shape": [40 * 320, 9000, 16000]})
    df.to_pickle(tmp_path / "d.pkl")
    flags = ["--emissions_dir", str(emdir), "--labels", str(labels)]
    want = pd.read_pickle(j_align_cli.main(
        [str(tmp_path / "d.pkl"), *flags, "--out",
         str(tmp_path / "jax.pkl")]))
    got = pd.read_pickle(align_cli.main(
        [str(tmp_path / "d.pkl"), *flags], device="cpu"))
    assert isinstance(got, pd.DataFrame)
    pd.testing.assert_frame_equal(got, want)
    assert want["timings"].iloc[1] is None
    assert want["timings"].iloc[0] is not None

    mapping = {"text": np.array(["ab", "ba", "b a!"]),
               "audio_shape": np.array([40 * 320, 9000, 16000])}
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump(mapping, f)
    out = align_cli.main([str(tmp_path / "m.pkl"), *flags, "--out",
                          str(tmp_path / "m_out.pkl")], device="cpu")
    with open(out, "rb") as f:
        table = pickle.load(f)
    assert isinstance(table, dict) and set(table) == {"text", "audio_shape",
                                                      "timings"}
    assert table["timings"] == list(want["timings"])

    # a missing sample-count column: T·320 on both sides
    del mapping["audio_shape"]
    with open(tmp_path / "m2.pkl", "wb") as f:
        pickle.dump(mapping, f)
    df.drop(columns="audio_shape").to_pickle(tmp_path / "d2.pkl")
    j2 = pd.read_pickle(j_align_cli.main([str(tmp_path / "d2.pkl"), *flags]))
    with open(align_cli.main([str(tmp_path / "m2.pkl"), *flags],
                             device="cpu"), "rb") as f:
        assert pickle.load(f)["timings"] == list(j2["timings"])
