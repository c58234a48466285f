"""Raw video ingestion: clip decode and keyframe extraction with OpenCV.

Port of ``mme_tpu/data/videodec.py`` (numpy and ``cv2``, imported inside
the functions that need it; the card's machine has no ``cv2``, so this
module runs on the host that builds the records):

- ``decode_video_frames``: one utterance's clip by its ``timings`` (the
  whole video when absent or shorter than 0.1 s), a uniform subsample of
  ``num_frames`` frames read in one sequential pass, BGR to RGB, the
  speaker crop, a bilinear resize to ``size`` and ImageNet normalisation
  (or raw uint8 with ``normalize=False``);
- ``extract_keyframes``: ``num_frames`` keyframes, the frame of largest
  change to its predecessor in each of ``num_frames`` uniform segments,
  written as ``frame_{k:03d}.jpg``;
- ``speaker_crop_box``: the IEMOCAP left or right speaker box.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from mme_tpu_torch.data.records import IMAGENET_MEAN, IMAGENET_STD
from mme_tpu_torch.ops.transforms import IEMOCAP_LEFT_BOX, IEMOCAP_RIGHT_BOX


def _open(path: str):
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    return cap, (fps if fps > 0 else 30.0), total


def _clip_bounds(timings, fps: float, total: int) -> Tuple[int, int]:
    """Frame range [lo, hi) of a clip (begin, end) in seconds: None, an
    unreadable pair or a clip under 0.1 s → the whole video (0..500 s)."""
    beg_s, end_s = 0.0, 500.0
    if timings is not None:
        try:
            beg_s, end_s = float(timings[0]), float(timings[1])
        except (TypeError, ValueError, IndexError):
            beg_s, end_s = 0.0, 500.0
        if end_s - beg_s < 0.1:
            beg_s, end_s = 0.0, 500.0
    lo = max(0, min(total - 1, int(round(beg_s * fps))))
    hi = max(lo + 1, min(total, int(round(end_s * fps))))
    return lo, hi


def _subsample_indices(lo: int, hi: int, num: int) -> np.ndarray:
    """UniformTemporalSubsample semantics: linspace over the clip,
    clamped — short clips repeat frames rather than shrink the output."""
    return np.clip(np.linspace(lo, hi - 1, num).round().astype(np.int64),
                   lo, hi - 1)


def _read_frames(cap, wanted: Sequence[int]) -> dict:
    """Sequential single pass collecting the wanted frame indices (seeking
    per index is O(keyframe-distance) per seek on many codecs)."""
    import cv2  # noqa: F401

    need = sorted(set(int(i) for i in wanted))
    out = {}
    pos = 0
    last = None
    for target in need:
        while pos <= target:
            ok, frame = cap.read()
            if not ok:
                break
            last = frame
            pos += 1
        out[target] = last
    return out


def decode_video_frames(path: str, num_frames: int = 16, size: int = 224,
                        timings=None,
                        crop_box: Optional[Tuple[int, int, int, int]] = None,
                        normalize: bool = True) -> np.ndarray:
    """mp4 → [num_frames, size, size, 3] float32, ImageNet-normalized
    (``normalize=False`` → raw uint8: 4× smaller records and host→device
    copies; ``train/build_tav.py::make_video_keep_transform`` normalises on
    the device).

    ``crop_box`` = (top, left, height, width), the IEMOCAP speaker crop.
    """
    import cv2

    cap, fps, total = _open(path)
    try:
        if total <= 0:
            # some containers report 0; count by reading
            frames = []
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                frames.append(f)
            total = len(frames)
            if total == 0:
                raise IOError(f"no decodable frames in {path}")
            lo, hi = _clip_bounds(timings, fps, total)
            idx = _subsample_indices(lo, hi, num_frames)
            got = {int(i): frames[int(i)] for i in idx}
        else:
            lo, hi = _clip_bounds(timings, fps, total)
            idx = _subsample_indices(lo, hi, num_frames)
            got = _read_frames(cap, idx)
    finally:
        cap.release()

    out = np.zeros((num_frames, size, size, 3),
                   np.float32 if normalize else np.uint8)
    for j, i in enumerate(idx):
        frame = got.get(int(i))
        if frame is None:
            continue
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if crop_box is not None:
            t, l, h, w = crop_box
            rgb = rgb[t:t + h, l:l + w]
            if rgb.size == 0:
                continue
        rgb = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_LINEAR)
        if normalize:
            out[j] = (rgb.astype(np.float32) / 255.0
                      - IMAGENET_MEAN) / IMAGENET_STD
        else:
            out[j] = rgb
    return out


def extract_keyframes(path: str, out_dir: str, num_frames: int = 16,
                      score_size: int = 64) -> list:
    """Keyframe picker, one frame per temporal segment.

    Scores every frame by mean absolute difference to its predecessor
    (downscaled grayscale), then picks the top-scoring frame inside each of
    ``num_frames`` uniform temporal segments — scene-change selection with
    guaranteed coverage. Writes ``frame_{k:03d}.jpg`` files and returns the
    written paths (fewer when the video is shorter than ``num_frames``).
    """
    import cv2

    cap, _fps, _total = _open(path)
    frames, scores = [], []
    prev = None
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            small = cv2.cvtColor(
                cv2.resize(frame, (score_size, score_size)),
                cv2.COLOR_BGR2GRAY).astype(np.float32)
            scores.append(0.0 if prev is None
                          else float(np.abs(small - prev).mean()))
            prev = small
            frames.append(frame)
    finally:
        cap.release()
    n = len(frames)
    if n == 0:
        raise IOError(f"no decodable frames in {path}")

    k = min(num_frames, n)
    bounds = np.linspace(0, n, k + 1).round().astype(np.int64)
    picks = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        e = max(int(e), int(s) + 1)
        seg = np.asarray(scores[int(s):e])
        picks.append(int(s) + int(seg.argmax()))

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for j, i in enumerate(picks):
        p = os.path.join(out_dir, f"frame_{j:03d}.jpg")
        cv2.imwrite(p, frames[i])
        written.append(p)
    return written


def speaker_crop_box(speaker) -> Optional[Tuple[int, int, int, int]]:
    """IEMOCAP fixed speaker boxes: truthy → the left speaker's box, falsy
    → the right one's; None/NaN → no crop. Accepts Python and numpy bools
    (pandas columns store the latter)."""
    if speaker is None:
        return None
    try:
        if np.isnan(speaker):
            return None
    except TypeError:
        pass
    return IEMOCAP_LEFT_BOX if bool(speaker) else IEMOCAP_RIGHT_BOX
