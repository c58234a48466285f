"""The port's video decode (mme_tpu_torch/data/videodec.py) against
mme_tpu/data/videodec.py, on mp4 files the test writes with
``cv2.VideoWriter``.

Tolerances: exact. Both call the same OpenCV functions on the same frames,
so decoded clips (float and uint8), keyframe picks and the written JPEGs
agree bit for bit.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mme_tpu.data import videodec as j_vd

from mme_tpu_torch.data import videodec as vd


def write_mp4(path, n_frames, w=64, h=48, fps=8.0, seed=0):
    """Frames of rising brightness with noise and a scene change at the
    middle."""
    rng = np.random.RandomState(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    assert vw.isOpened()
    for i in range(n_frames):
        val = min(10 * i, 255) if i < n_frames // 2 else 255 - 8 * i
        frame = np.clip(val + rng.randint(-20, 20, (h, w, 3)), 0, 255)
        frame[:, : w // 3] = 30 * (i % 4)
        vw.write(frame.astype(np.uint8))
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_mp4(tmp_path_factory.mktemp("mp4") / "a.mp4", 24)


def test_helpers_match_jax():
    for timings in (None, (1.0, 2.0), (1.0, 1.01), ("x", 2), (5.0,),
                    (-1.0, 100.0), (2.9, 4.0)):
        for total in (1, 24, 300):
            assert vd._clip_bounds(timings, 8.0, total) == \
                j_vd._clip_bounds(timings, 8.0, total)
    for lo, hi, num in ((0, 24, 16), (3, 5, 16), (8, 16, 4), (0, 1, 3)):
        np.testing.assert_array_equal(vd._subsample_indices(lo, hi, num),
                                      j_vd._subsample_indices(lo, hi, num))
    for speaker in (None, float("nan"), True, False, np.bool_(True),
                    np.bool_(False), 1, 0):
        assert vd.speaker_crop_box(speaker) == j_vd.speaker_crop_box(speaker)
    np.testing.assert_array_equal(vd.IMAGENET_MEAN, j_vd.IMAGENET_MEAN)
    np.testing.assert_array_equal(vd.IMAGENET_STD, j_vd.IMAGENET_STD)


@pytest.mark.parametrize("kw", [
    dict(num_frames=4, size=32),
    dict(num_frames=6, size=16, timings=(1.0, 2.0), normalize=False),
    dict(num_frames=4, size=32, timings=(1.0, 1.01)),
    dict(num_frames=30, size=20, crop_box=(4, 10, 30, 40)),
    dict(num_frames=3, size=16, crop_box=(100, 100, 5, 5)),   # empty crop
])
def test_decode_matches_jax(clip, kw):
    got = vd.decode_video_frames(clip, **kw)
    want = j_vd.decode_video_frames(clip, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0 or kw.get("crop_box") == (100, 100, 5, 5)


def test_read_frames_and_open_match_jax(clip):
    cap, fps, total = vd._open(clip)
    jcap, jfps, jtotal = j_vd._open(clip)
    try:
        assert (fps, total) == (jfps, jtotal) == (8.0, 24)
        got = vd._read_frames(cap, [5, 0, 5, 23, 30])
        want = j_vd._read_frames(jcap, [5, 0, 5, 23, 30])
    finally:
        cap.release()
        jcap.release()
    assert sorted(got) == sorted(want) == [0, 5, 23, 30]
    for i in got:
        np.testing.assert_array_equal(got[i], want[i])
    with pytest.raises(IOError):
        vd._open(clip + ".missing")


def test_extract_keyframes_matches_jax(clip, tmp_path):
    got = vd.extract_keyframes(clip, str(tmp_path / "port"), num_frames=5)
    want = j_vd.extract_keyframes(clip, str(tmp_path / "jax"), num_frames=5)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    short = write_mp4(tmp_path / "short.mp4", 3)
    assert len(vd.extract_keyframes(short, str(tmp_path / "s"), 16)) == \
        len(j_vd.extract_keyframes(short, str(tmp_path / "sj"), 16)) == 3
