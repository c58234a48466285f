"""Records from the pickled-DataFrame dataset contract.

Port of ``mme_tpu/data/records.py`` (numpy; ``transformers`` and ``PIL``
imported inside the functions that need them, ``pandas`` only through the
frames callers pass in). A frame has the columns ``text``, ``audio_path``,
``video_path``, ``emotion`` / ``sentiment`` (and ``*_label`` strings),
``split``, ``dialog``, ``timings``, ``speaker`` and ``audio_shape``; this
module turns one into the port's ``data/dataset.py::ArrayDataset``, with
JAX's seeds, row order and dtypes:

- text: a tokenizer from local files when one resolves offline, else a
  deterministic hash tokenizer with the same padding and truncation
  contract (loudly, unless asked for with ``name=None``);
- audio: ``data/wavio.py`` decode + sinc resample to 16 kHz, padded to
  ``audio_max_samples`` with keep-masks;
- video: keyframe JPEG directories through PIL, zero-padded to
  ``num_frames`` and ImageNet-normalised (or raw uint8), or raw clips
  through ``data/videodec.py``.

Splits: the ``split`` column when present, else a seeded stratified
75/12.5/12.5 split. Filters: ``audio_shape > min_audio_shape`` and dropped
labels. The splits, the filters, ``build_label_map`` and the text, audio
and TAV builders also take a plain mapping of column name → array (or
list) in place of a frame (no pandas), save for the TAV builder's
keyframe and raw-video branches, which walk the frame's rows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.data.wavio import load_waveforms_parallel

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def __getattr__(name: str):
    # ``records.find_checkpoint_dir`` is the weights' lookup in
    # models/pretrained.py, imported only when asked for: a served bundle
    # reaches this module (through ops/video.py) without the model code
    if name == "find_checkpoint_dir":
        from mme_tpu_torch.models.pretrained import find_checkpoint_dir
        return find_checkpoint_dir
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class HashTokenizer:
    """Deterministic offline tokenizer with the HF call contract
    (padding='max_length', truncation). Ids 0=pad, 1=bos, 2=eos, 3=unk;
    words hash into [4, vocab)."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size
        self.pad_token_id = 0

    def __call__(self, text: str, max_length: int = 70):
        words = text.lower().split()
        ids = [1]
        for w in words[: max_length - 2]:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(4 + h % (self.vocab_size - 4))
        ids.append(2)
        mask = [1] * len(ids)
        while len(ids) < max_length:
            ids.append(self.pad_token_id)
            mask.append(0)
        return ids, mask


def get_tokenizer(name: Optional[str] = "j-hartmann/emotion-english-distilroberta-base",
                  vocab_size: int = 50265):
    """HF tokenizer if resolvable offline, else the hash fallback.
    ``name=None`` forces the hash tokenizer (e.g. reduced-vocab models)."""
    if name is None:
        h = HashTokenizer(vocab_size)
        return lambda text, max_length=70: h(text, max_length)
    try:
        from transformers import AutoTokenizer
        # MME_PRETRAINED holds locally cached checkpoints (incl. tokenizer
        # files); prefer it over the (network-dependent) hub cache
        source = name
        root = os.environ.get("MME_PRETRAINED")
        if root:
            from mme_tpu_torch.models.pretrained import find_checkpoint_dir
            local = find_checkpoint_dir(root, name)
            if local and os.path.exists(os.path.join(local,
                                                     "tokenizer_config.json")):
                source = local
        tok = AutoTokenizer.from_pretrained(source, local_files_only=True)

        def encode(text: str, max_length: int = 70):
            out = tok(text, padding="max_length", max_length=max_length,
                      truncation=True)
            return out["input_ids"], out["attention_mask"]

        return encode
    except Exception:
        # LOUD fallback: hash ids are fine for smoke tests but garbage for a
        # real pretrained model — a silent swap would just read as lower F1.
        import warnings
        warnings.warn(
            f"tokenizer '{name}' not resolvable offline (set MME_PRETRAINED "
            "to a dir of cached checkpoints); FALLING BACK TO A HASH "
            "TOKENIZER — token ids will NOT match pretrained embeddings",
            stacklevel=2)
        h = HashTokenizer(vocab_size)
        return lambda text, max_length=70: h(text, max_length)


def tokenize_texts(texts: Sequence[str], max_length: int = 70,
                   tokenizer=None) -> Tuple[np.ndarray, np.ndarray]:
    tokenizer = tokenizer or get_tokenizer()
    ids, masks = [], []
    for t in texts:
        i, m = tokenizer(str(t), max_length)
        ids.append(i)
        masks.append(m)
    return np.asarray(ids, np.int32), np.asarray(masks, np.int32)


def load_audio_bucket(paths: Sequence[str], max_samples: int,
                      target_sr: int = 16000, workers: int = 8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """[N, max_samples] padded waveforms + keep-masks."""
    waves = load_waveforms_parallel(paths, target_sr, max_samples, workers)
    n = len(waves)
    out = np.zeros((n, max_samples), np.float32)
    mask = np.zeros((n, max_samples), np.int32)
    for i, w in enumerate(waves):
        L = min(len(w), max_samples)
        out[i, :L] = w[:L]
        mask[i, :L] = 1
    return out, mask


def load_keyframes(dir_glob: str, num_frames: int = 16, size: int = 224,
                   crop_box: Optional[Tuple[int, int, int, int]] = None,
                   normalize: bool = True) -> np.ndarray:
    """Keyframe JPEGs (a glob) → [num_frames, size, size, 3] normalized
    floats, zero-padded to ``num_frames``. ``crop_box`` = (top, left,
    height, width) cuts the IEMOCAP speaker box out first.

    ``normalize=False`` → raw uint8 frames: 4× smaller records and
    host→device transfers; normalization then happens on device
    (train/build_tav.py::make_video_keep_transform)."""
    import glob as globlib

    from PIL import Image

    frames = []
    for path in sorted(globlib.glob(dir_glob))[:num_frames]:
        img = Image.open(path).convert("RGB")
        arr = np.asarray(img, np.uint8)
        if crop_box is not None:
            t, l, h, w = crop_box
            arr = arr[t:t + h, l:l + w]
        arr = np.asarray(
            Image.fromarray(arr).resize((size, size)), np.uint8)
        if normalize:
            frames.append((arr.astype(np.float32) / 255.0
                           - IMAGENET_MEAN) / IMAGENET_STD)
        else:
            frames.append(arr)
    dtype = np.float32 if normalize else np.uint8
    out = np.zeros((num_frames, size, size, 3), dtype)
    if frames:
        out[:len(frames)] = np.stack(frames)
    return out


@dataclasses.dataclass
class PickleDatasetConfig:
    label_col: str = "emotion"
    text_col: str = "text"
    audio_col: str = "audio_path"
    video_col: str = "video_path"
    split_col: str = "split"
    dialog_col: str = "dialog"
    text_max_len: int = 70
    audio_max_samples: int = 160000
    min_audio_shape: Optional[int] = None     # the audio CLI: 10000
    drop_labels: Sequence[str] = ()           # e.g. ("fear", "disgust")
    seed: int = 32
    # store video as raw uint8 (4× smaller records + host→device traffic);
    # ImageNet normalization then runs on device in the batch transform
    video_uint8: bool = False
    # string-label → id map built ONCE over the full dataframe
    # (build_label_map) so a class absent from one split cannot shift the
    # ids of every later class in that split (train/val id misalignment)
    label_map: Optional[Dict[str, int]] = None


def _columns(df):
    """A frame's column names, or a mapping's keys."""
    return df.columns if hasattr(df, "columns") else list(df)


def _num_rows(df) -> int:
    if hasattr(df, "iloc"):
        return len(df)
    return len(next(iter(df.values()))) if len(df) else 0


def _rows(df, idx: np.ndarray):
    """The rows ``idx`` (ascending positions) of a frame, or of a mapping
    of columns: arrays are indexed, lists keep their items."""
    if hasattr(df, "iloc"):
        return df.iloc[idx]
    return {k: (v[idx] if isinstance(v, np.ndarray) else [v[i] for i in idx])
            for k, v in df.items()}


def _stratified_take(df, label_col, seed, frac):
    """Carve a stratified ``frac`` slice off ``df`` → (remainder, slice)."""
    rng = np.random.RandomState(seed)
    idx = np.arange(_num_rows(df))
    labels = np.asarray(df[label_col])
    take = []
    for c in np.unique(labels):
        ci = idx[labels == c]
        if len(ci) < 2:
            continue  # a class's only row stays in the remainder (train)
        rng.shuffle(ci)
        # never drain a class: the carve takes at most len-1 rows
        k = min(max(1, int(round(len(ci) * frac))), len(ci) - 1)
        take.extend(ci[:k])
    take = np.sort(np.asarray(take, dtype=int))
    mask = np.ones(len(idx), bool)
    mask[take] = False
    return _rows(df, np.flatnonzero(mask)), _rows(df, take)


def split_dataframe(df, cfg: PickleDatasetConfig):
    """The split column when present, else a stratified 75/12.5/12.5
    split; ``df`` is a frame or a mapping of columns, and each split is of
    the same kind.

    A split column with SOME empty partitions is handled without ever
    folding official held-out rows back into training: a missing val
    (or test) partition is carved out of the official TRAIN rows only
    (stratified 12.5%), while every non-empty official partition is kept
    verbatim. Only when no held-out partition exists at all (a pickle
    built from one CSV: everything is "train") does the full stratified
    re-split run."""
    if cfg.split_col in _columns(df):
        split = np.asarray(df[cfg.split_col])
        train, val, test = (_rows(df, np.flatnonzero(split == name))
                            for name in ("train", "val", "test"))
        n_train, n_val, n_test = (int(np.sum(split == name))
                                  for name in ("train", "val", "test"))
        if n_train > 0 and n_val > 0 and n_test > 0:
            return train, val, test
        if n_train > 0 and (n_val > 0 or n_test > 0):
            # official held-out data exists — never re-split it
            if n_val == 0:
                train, val = _stratified_take(train, cfg.label_col,
                                              cfg.seed, 0.125)
                print("split column has no val rows — carved a stratified "
                      "12.5% val set out of the official train split "
                      "(official test untouched)", flush=True)
            if n_test == 0:
                train, test = _stratified_take(train, cfg.label_col,
                                               cfg.seed + 1, 0.125)
                print("split column has no test rows — carved a stratified "
                      "12.5% test set out of the official train split "
                      "(official val untouched)", flush=True)
            return train, val, test
        if n_val > 0 or n_test > 0:
            # official held-out rows exist but there is NOTHING to train
            # on — re-splitting here would silently fold val/test rows
            # into training (protocol violation). Refuse loudly instead.
            raise ValueError(
                f"split column {cfg.split_col!r} has no train rows but "
                f"{n_val} val / {n_test} test rows — refusing to "
                "re-split official held-out data into training; fix the "
                "pickle's split column or drop it for a stratified split")
        print("split column present but no usable train/eval partitions — "
              "using the stratified 75/12.5/12.5 split instead", flush=True)
    rng = np.random.RandomState(cfg.seed)
    idx = np.arange(_num_rows(df))
    labels = np.asarray(df[cfg.label_col])
    train_idx, rest_idx = [], []
    for c in np.unique(labels):
        ci = idx[labels == c]
        rng.shuffle(ci)
        k = int(len(ci) * 0.75)
        train_idx.extend(ci[:k])
        rest_idx.extend(ci[k:])
    rest_idx = np.asarray(rest_idx, dtype=int)
    rng.shuffle(rest_idx)
    half = len(rest_idx) // 2
    return (_rows(df, np.sort(np.asarray(train_idx, dtype=int))),
            _rows(df, np.sort(rest_idx[:half])),
            _rows(df, np.sort(rest_idx[half:])))


def apply_filters(df, cfg: PickleDatasetConfig,
                  label_names: Optional[Dict[int, str]] = None):
    """The audio_shape and label-drop filters, on a frame or a mapping of
    columns."""
    if cfg.min_audio_shape is not None and "audio_shape" in _columns(df):
        df = _rows(df, np.flatnonzero(
            np.asarray(df["audio_shape"]) > cfg.min_audio_shape))
    if cfg.drop_labels:
        col = (f"{cfg.label_col}_label"
               if f"{cfg.label_col}_label" in _columns(df) else None)
        if col is not None:
            df = _rows(df, np.flatnonzero(~np.isin(
                np.asarray(df[col]), list(cfg.drop_labels))))
    return df


def build_label_map(df, label_col: str) -> Optional[Dict[str, int]]:
    """The string-label → id map over the FULL dataframe. Build this once
    before ``split_dataframe`` and pass it via ``PickleDatasetConfig
    .label_map`` so every split factorizes identically (a class absent
    from val/test must not shift later ids). Returns None for integer
    labels (they pass through unchanged)."""
    arr = np.asarray(df[label_col])
    if np.issubdtype(arr.dtype, np.integer):
        return None
    return {n: i for i, n in enumerate(sorted(set(map(str, arr))))}


def labels_to_ids(values, name2id: Optional[Dict[str, int]] = None
                  ) -> Tuple[np.ndarray, Dict[int, str]]:
    """Int labels pass through; strings factorize in sorted order
    (the label2id of the CLIs). ``name2id``: a prebuilt
    full-dataframe map (build_label_map) — required for per-split calls
    to agree when a split is missing a class."""
    arr = np.asarray(values)
    if np.issubdtype(arr.dtype, np.integer):
        uniq = np.unique(arr)
        return arr.astype(np.int64), {int(u): str(u) for u in uniq}
    if name2id is None:
        names = sorted(set(map(str, arr)))
        name2id = {n: i for i, n in enumerate(names)}
    return (np.asarray([name2id[str(v)] for v in arr], np.int64),
            {i: n for n, i in name2id.items()})


def build_text_dataset(df, cfg: PickleDatasetConfig,
                       tokenizer=None) -> ArrayDataset:
    ids, mask = tokenize_texts(list(df[cfg.text_col]), cfg.text_max_len,
                               tokenizer)
    labels, _ = labels_to_ids(df[cfg.label_col], cfg.label_map)
    dialogs = np.asarray(df[cfg.dialog_col]) if cfg.dialog_col in df else None
    return ArrayDataset({"input_ids": ids, "text_mask": mask}, labels,
                        dialog_ids=dialogs)


def build_audio_dataset(df, cfg: PickleDatasetConfig) -> ArrayDataset:
    wave, mask = load_audio_bucket(list(df[cfg.audio_col]),
                                   cfg.audio_max_samples)
    labels, _ = labels_to_ids(df[cfg.label_col], cfg.label_map)
    return ArrayDataset({"waveform": wave, "audio_mask": mask}, labels)


def build_video_dataset(df, cfg: PickleDatasetConfig, video_frames: int = 16,
                        video_size: int = 224,
                        keyframe_glob: Optional[str] = None) -> ArrayDataset:
    """Video-only records (``cli/visual_nn.py``): decode raw video
    (timings + speaker crop) or ingest keyframe JPEG dirs."""
    from mme_tpu_torch.data.videodec import (decode_video_frames,
                                             speaker_crop_box)

    n = len(df)
    video = np.zeros((n, video_frames, video_size, video_size, 3),
                     np.float32)
    for i, (_, row) in enumerate(df.iterrows()):
        crop = speaker_crop_box(row.get("speaker", None))
        if keyframe_glob is not None:
            ctx = dict(row)
            if cfg.video_col in row:
                ctx.setdefault("name", os.path.splitext(
                    os.path.basename(str(row[cfg.video_col])))[0])
            video[i] = load_keyframes(keyframe_glob.format(**ctx),
                                      video_frames, video_size, crop)
        elif cfg.video_col in row:
            video[i] = decode_video_frames(
                str(row[cfg.video_col]), video_frames, video_size,
                timings=row.get("timings", None), crop_box=crop)
    labels, _ = labels_to_ids(df[cfg.label_col].values, cfg.label_map)
    dialogs = (df[cfg.dialog_col].values
               if cfg.dialog_col in df.columns else None)
    return ArrayDataset({"video": video}, labels, dialog_ids=dialogs)


def build_tav_dataset(df, cfg: PickleDatasetConfig, video_frames: int = 16,
                      video_size: int = 224, tokenizer=None,
                      keyframe_glob: Optional[str] = None) -> ArrayDataset:
    """Triple-modal records. Video comes from keyframe dirs
    (``keyframe_glob``.format(row) → jpg glob) or, when the frame has a
    video-path column, from raw video decode (timings + speaker crop)."""
    ids, tmask = tokenize_texts(list(df[cfg.text_col]), cfg.text_max_len,
                                tokenizer)
    wave, amask = load_audio_bucket(list(df[cfg.audio_col]),
                                    cfg.audio_max_samples)
    n = len(ids)
    norm = not cfg.video_uint8
    video = np.zeros((n, video_frames, video_size, video_size, 3),
                     np.float32 if norm else np.uint8)
    from mme_tpu_torch.data.videodec import (decode_video_frames,
                                             speaker_crop_box)
    if keyframe_glob is not None:
        for i, (_, row) in enumerate(df.iterrows()):
            crop = speaker_crop_box(row.get("speaker", None))
            ctx = dict(row)
            if cfg.video_col in row:
                # '{name}' = the video's basename, the keyframe folders'
                # names
                ctx.setdefault("name", os.path.splitext(
                    os.path.basename(str(row[cfg.video_col])))[0])
            video[i] = load_keyframes(keyframe_glob.format(**ctx),
                                      video_frames, video_size, crop,
                                      normalize=norm)
    elif cfg.video_col in df:
        # raw video decode at record-build time:
        # timings-clipped uniform 16-frame subsample + speaker crop
        for i, (_, row) in enumerate(df.iterrows()):
            path = row.get(cfg.video_col, None)
            if path is None or not str(path).endswith(
                    (".mp4", ".avi", ".mov", ".mkv", ".webm")):
                continue
            video[i] = decode_video_frames(
                str(path), video_frames, video_size,
                timings=row.get("timings", None),
                crop_box=speaker_crop_box(row.get("speaker", None)),
                normalize=norm)
    labels, _ = labels_to_ids(df[cfg.label_col], cfg.label_map)
    dialogs = np.asarray(df[cfg.dialog_col]) if cfg.dialog_col in df else None
    return ArrayDataset(
        {"input_ids": ids, "text_mask": tmask, "waveform": wave,
         "audio_mask": amask, "video": video}, labels, dialog_ids=dialogs)
