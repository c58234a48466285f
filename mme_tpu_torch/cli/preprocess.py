"""Offline dataset builder: MELD-style CSVs → the records pickle.

Port of ``mme_tpu/cli/preprocess.py``: the reference's notebook chain as
one command. It maps emotion and sentiment strings to the reference's ids
(strings it does not know get new ids after them, with a warning), builds
each utterance's ``dia{d}_utt{u}`` media paths from patterns, drops the two
utterances the reference drops (unless ``--keep_bad``), refuses a media
path claimed by two splits (MELD's ids restart per split), and reads each
WAV header for the ``audio_shape`` column::

    python -m mme_tpu_torch.cli.preprocess train.csv dev.csv test.csv \
        --out meld.pkl --audio_dir wavs/ --video_dir mp4s/

The columns are the records contract every CLI reads
(``data/records.py``): text, audio_path, video_path, emotion,
emotion_label, sentiment, sentiment_label, dialog, utterance, split,
audio_shape, timings, speaker (and sarcasm, sarcasm_label with
``--sarcasm_col``). Runs on the host (pandas, imported when it runs); it
uses no card.
"""

from __future__ import annotations

import argparse
import os
import wave

# the reference's emotion int map (run_scripts/pre_process_for_audio.py:14)
MELD_EMOTION_IDS = {"neutral": 0, "surprise": 1, "fear": 2, "sadness": 3,
                    "joy": 4, "disgust": 5, "anger": 6}
MELD_SENTIMENT_IDS = {"neutral": 0, "positive": 1, "negative": 2}
# not present in the val split upstream (pre_process_for_audio.py:28-29)
BAD_UTTERANCES = {"dia110_utt7", "dia125_utt3"}


def _parse(argv):
    p = argparse.ArgumentParser("mme_tpu_torch preprocess")
    p.add_argument("csvs", nargs="+",
                   help="MELD-format CSV(s); split inferred from filename "
                        "(train/dev|val/test) unless --split is given")
    p.add_argument("--out", required=True, help="output pickle path")
    p.add_argument("--split", default=None,
                   help="force one split name for all inputs")
    p.add_argument("--audio_dir", default=None)
    p.add_argument("--video_dir", default=None)
    p.add_argument("--audio_pattern", default="dia{dialog}_utt{utterance}.wav",
                   help="media filename pattern; {split} is available "
                        "(MELD ids restart per split — multi-split builds "
                        "need it, e.g. '{split}/dia{dialog}_utt{utterance}"
                        ".wav')")
    p.add_argument("--video_pattern", default="dia{dialog}_utt{utterance}.mp4",
                   help="see --audio_pattern")
    p.add_argument("--text_col", default="Utterance")
    p.add_argument("--emotion_col", default="Emotion")
    p.add_argument("--sentiment_col", default="Sentiment")
    p.add_argument("--dialog_col", default="Dialogue_ID")
    p.add_argument("--utterance_col", default="Utterance_ID")
    p.add_argument("--speaker_col", default=None,
                   help="speaker boolean column (IEMOCAP crop); absent for "
                        "MELD")
    p.add_argument("--sarcasm_col", default=None,
                   help="MUStARD++ sarcasm column (0/1 or TRUE/FALSE); "
                        "emits 'sarcasm'/'sarcasm_label' columns usable "
                        "as --label_task sarcasm")
    p.add_argument("--sep", default=",", help="CSV separator")
    p.add_argument("--keep_bad", action="store_true",
                   help="keep dia110_utt7/dia125_utt3 (the reference "
                        "drops them)")
    return p.parse_args(argv)


def _infer_split(path: str) -> str:
    name = os.path.basename(path).lower()
    for key, split in (("train", "train"), ("dev", "val"), ("val", "val"),
                       ("test", "test")):
        if key in name:
            return split
    return "train"


def _wav_frames(path: str) -> int:
    """audio_shape: sample count from the WAV header only (the reference
    loads whole files to measure; the header is enough and O(1))."""
    try:
        with wave.open(path, "rb") as w:
            return int(w.getnframes())
    except (OSError, wave.Error):
        return 0


def _label_map(base, values, kind):
    """Known strings keep the reference ids; unknown ones (other datasets,
    e.g. IEMOCAP's frustrated/excited) get fresh ids after the known
    range, loudly — never a silent collapse onto id 0."""
    mapping = dict(base)
    unknown = sorted({v for v in values if v not in mapping})
    if unknown:
        nxt = max(mapping.values()) + 1
        for u in unknown:
            mapping[u] = nxt
            nxt += 1
        print(f"WARNING: {kind} labels not in the reference map get new "
              f"ids: { {u: mapping[u] for u in unknown} }", flush=True)
    return mapping


def build_frame(args):
    import pandas as pd

    rows = []
    frames = [(args.split or _infer_split(p), pd.read_csv(p, sep=args.sep))
              for p in args.csvs]
    # MELD dialogue/utterance ids RESTART per split: with a split-blind
    # media pattern, train.csv's dia0_utt0 and test.csv's dia0_utt0 would
    # silently resolve to the SAME file — media duplicated across splits
    # (train/test leakage) and audio_shape probed from the wrong wav.
    # Track path→split and fail loudly on any cross-split collision.
    seen_media = {}

    def _claim(path, split):
        prev = seen_media.setdefault(path, split)
        if prev != split:
            raise SystemExit(
                f"preprocess: media path {path!r} is claimed by both the "
                f"{prev!r} and {split!r} splits (MELD ids restart per "
                "split). Put {split} in --audio_pattern/--video_pattern "
                "(e.g. '{split}/dia{dialog}_utt{utterance}.wav') or run "
                "one split per invocation with --split and per-split "
                "media dirs.")
        return path
    emo_map = _label_map(
        MELD_EMOTION_IDS,
        [str(v).strip().lower() for _, d in frames
         for v in d[args.emotion_col]], "emotion")
    sent_map = _label_map(
        MELD_SENTIMENT_IDS,
        [str(v).strip().lower() for _, d in frames
         if args.sentiment_col in d.columns
         for v in d[args.sentiment_col]], "sentiment")
    for split, df in frames:
        for _, r in df.iterrows():
            dialog = int(r[args.dialog_col])
            utt = int(r[args.utterance_col])
            name = f"dia{dialog}_utt{utt}"
            if not args.keep_bad and name in BAD_UTTERANCES:
                continue
            emo = str(r[args.emotion_col]).strip().lower()
            sent = str(r.get(args.sentiment_col, "neutral")).strip().lower()
            fmt = dict(dialog=dialog, utterance=utt, name=name, split=split)
            audio_path = (_claim(os.path.join(
                args.audio_dir, args.audio_pattern.format(**fmt)), split)
                if args.audio_dir else "")
            video_path = (_claim(os.path.join(
                args.video_dir, args.video_pattern.format(**fmt)), split)
                if args.video_dir else "")
            row_extra = {}
            if args.sarcasm_col:
                sar = str(r[args.sarcasm_col]).strip().lower()
                sar_id = 1 if sar in ("1", "true", "yes", "sarcastic",
                                      "1.0") else 0
                row_extra["sarcasm"] = sar_id
                row_extra["sarcasm_label"] = ("sarcastic" if sar_id
                                              else "not_sarcastic")
            rows.append({
                **row_extra,
                "text": str(r[args.text_col]),
                "audio_path": audio_path,
                "video_path": video_path,
                "emotion": emo_map[emo],
                "emotion_label": emo,
                "sentiment": sent_map.get(sent, 0),
                "sentiment_label": sent,
                "dialog": dialog,
                "utterance": utt,
                "split": split,
                "audio_shape": (_wav_frames(audio_path)
                                if audio_path else 0),
                "timings": None,
                "speaker": (bool(r[args.speaker_col])
                            if args.speaker_col else None),
            })
    return pd.DataFrame(rows)


def main(argv=None):
    args = _parse(argv)
    df = build_frame(args)
    if len(df) == 0:
        raise SystemExit("preprocess: no rows produced (empty CSVs or "
                         "everything filtered) — refusing to write "
                         f"{args.out}")
    df.to_pickle(args.out)
    by_split = df.groupby("split").size().to_dict()
    print(f"wrote {args.out}: {len(df)} rows, splits={by_split}",
          flush=True)
    return df


if __name__ == "__main__":
    main()
