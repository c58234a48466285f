"""Keyframe extraction: 16 keyframes per video into per-video folders.

Port of ``mme_tpu/cli/keyframes.py`` (the reference's offline Katna step).
For each distinct video of a records pickle (the ``data/records.py``
contract) it writes ``{split}_KeyFrameFolder/{video basename}/`` under
``--out_root`` through ``data/videodec.py::extract_keyframes`` (the frame
of largest change in each of ``--num_frames`` uniform segments, in place
of Katna's clustering); the CLIs read them back through
``MME_KEYFRAME_GLOB``::

    python -m mme_tpu_torch.cli.keyframes data.pkl --out_root data/keyframes
    # then: MME_KEYFRAME_GLOB='data/keyframes/{split}_KeyFrameFolder/{name}/*.jpg'

A video that does not decode is reported and counted, and the rest go
on. Runs on the host that builds the records (pandas and cv2, imported
when it runs); it uses no card.
"""

from __future__ import annotations

import argparse
import os


def video_name(path: str) -> str:
    return os.path.splitext(os.path.basename(str(path)))[0]


def main(argv=None):
    p = argparse.ArgumentParser("mme_tpu_torch keyframe extraction")
    p.add_argument("pickle", help="dataset pickle with a video-path column")
    p.add_argument("--out_root", required=True)
    p.add_argument("--video_col", default="video_path")
    p.add_argument("--split_col", default="split")
    p.add_argument("--num_frames", type=int, default=16)
    args = p.parse_args(argv)

    import pandas as pd

    from mme_tpu_torch.data.videodec import extract_keyframes

    df = pd.read_pickle(args.pickle)
    done, failed = 0, 0
    seen = set()
    for _, row in df.iterrows():
        path = row.get(args.video_col, None)
        if path is None or str(path) in seen:
            continue
        seen.add(str(path))
        split = str(row.get(args.split_col, "train"))
        out_dir = os.path.join(args.out_root, f"{split}_KeyFrameFolder",
                               video_name(path))
        try:
            extract_keyframes(str(path), out_dir, args.num_frames)
            done += 1
        except Exception as e:  # keep going over a corrupt video
            print(f"FAILED {path}: {e}", flush=True)
            failed += 1
    pattern = os.path.join(args.out_root, "{split}_KeyFrameFolder",
                           "{name}", "*.jpg")
    print(f"extracted keyframes for {done} videos ({failed} failed)")
    print(f"MME_KEYFRAME_GLOB pattern: {pattern}")
    return {"done": done, "failed": failed, "pattern": pattern}


if __name__ == "__main__":
    main()
