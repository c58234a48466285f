"""Pretrained weights from local HF / torch checkpoints into the CLIs' runs.

Port of ``mme_tpu/models/pretrained.py``. Given a directory of locally
cached checkpoints (``MME_PRETRAINED``; nothing is downloaded), it reads a
checkpoint's state dict (``model.safetensors`` through this module's own
reader, else ``pytorch_model.bin`` through ``torch.load(weights_only=True)``),
converts it with ``models/hf_import.py`` into the flax layout and merges it
into the flax-layout parameter tree a CLI drew (``convert.init_variables``
/ ``init_params``); ``convert.from_flax`` then loads the tree into the
model. A checkpoint that is not there loads nothing; one that leaves a
model leaf uninitialized or has a leaf of another shape raises
``ValueError``.

Layout under the root, per checkpoint, the full repo id or its basename::

    $MME_PRETRAINED/j-hartmann/emotion-english-distilroberta-base/...
    $MME_PRETRAINED/emotion-english-distilroberta-base/model.safetensors
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mme_tpu_torch.models.hf_import import (convert_slow_r50,
                                            convert_text_encoder,
                                            convert_videomae,
                                            convert_wav2vec2, state_dict_np)

ENV_VAR = "MME_PRETRAINED"

# the reference's checkpoints
TEXT_EMOTION = "j-hartmann/emotion-english-distilroberta-base"
AUDIO_XLSR = "ehcalabres/wav2vec2-lg-xlsr-en-speech-emotion-recognition"
AUDIO_SUPERB = "superb/wav2vec2-base-superb-er"
VIDEO_MAE = "MCG-NJU/videomae-base-finetuned-kinetics"
SLOW_R50 = "slow_r50"

# safetensors dtype → numpy dtype name; numpy has no bfloat16 or float8,
# so np.dtype raises TypeError for them, as safetensors.numpy does
_SAFETENSORS_DTYPES = {
    "BOOL": "bool", "U8": "uint8", "I8": "int8", "U16": "uint16",
    "I16": "int16", "F16": "float16", "BF16": "bfloat16", "U32": "uint32",
    "I32": "int32", "F32": "float32", "U64": "uint64", "I64": "int64",
    "F64": "float64", "C64": "complex64", "F8_E5M2": "float8_e5m2",
    "F8_E4M3": "float8_e4m3fn"}


def pretrained_root(explicit: Optional[str] = None) -> Optional[str]:
    """``explicit`` or ``MME_PRETRAINED`` when it names a directory."""
    root = explicit or os.environ.get(ENV_VAR)
    return root if root and os.path.isdir(root) else None


def find_checkpoint_dir(root: str, repo_id: str) -> Optional[str]:
    """Locate ``repo_id`` under ``root`` (full id or basename)."""
    for cand in (repo_id, repo_id.split("/")[-1]):
        d = os.path.join(root, cand)
        if os.path.isdir(d):
            return d
    return None


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file → ``{name: array}``, the arrays
    ``safetensors.numpy.load_file`` gives, without that package. The file
    is an 8-byte little-endian header length, a JSON header (per tensor its
    ``dtype``, ``shape`` and ``data_offsets`` into the data; an optional
    ``__metadata__``), then the data. The file is read once into one
    buffer; the arrays are writable views of it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.empty(os.fstat(f.fileno()).st_size - 8 - n, np.uint8)
        view, got = memoryview(data), 0
        while got < data.size:
            k = f.readinto(view[got:])
            if not k:
                raise ValueError(f"{path}: data ends at byte {got} of "
                                 f"{data.size}")
            got += k
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = np.dtype(_SAFETENSORS_DTYPES.get(info["dtype"],
                                                 info["dtype"]))
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        if end - start != int(np.prod(shape)) * dtype.itemsize or \
                end > data.size:
            raise ValueError(f"{path}: {name} has data_offsets "
                             f"{info['data_offsets']} for {shape} "
                             f"{info['dtype']}")
        out[name] = data[start:end].view(dtype.newbyteorder("<")
                                         ).reshape(shape)
    return out


def load_local_state_dict(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint directory (or a file path) into numpy."""
    if os.path.isfile(ckpt_dir):
        candidates = [ckpt_dir]
    else:
        candidates = [os.path.join(ckpt_dir, n)
                      for n in ("model.safetensors", "pytorch_model.bin")]
        candidates = [c for c in candidates if os.path.exists(c)]
        if not candidates:
            raise FileNotFoundError(
                f"no model.safetensors/pytorch_model.bin in {ckpt_dir}")
    path = candidates[0]
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_np(sd)


_TOWER_PREFIXES = ("roberta.", "bert.", "wav2vec2.", "videomae.",
                   "distilbert.", "model.")


def strip_model_prefix(sd: Mapping[str, np.ndarray],
                       probe: str = "embeddings") -> Dict[str, np.ndarray]:
    """Classifier checkpoints nest the base model under e.g. ``roberta.``;
    the converters take base-model keys. Detect and strip one prefix (the
    head's keys go with it)."""
    if any(k.startswith(probe) or k.startswith("feature_extractor")
           or k.startswith("feature_projection") for k in sd):
        return dict(sd)
    for p in _TOWER_PREFIXES:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    return dict(sd)


def merge_params(target: Any, source: Any, _path: str = ""
                 ) -> Tuple[Any, List[str], List[str]]:
    """Replace ``target``'s leaves with ``source``'s leaves at the same
    paths, shapes checked, cast to the target's dtype. A target leaf may be
    shape-only (anything with ``shape`` and ``dtype``). Returns (merged,
    missing, extra): ``missing`` the target leaf paths absent from source
    (left as they were), ``extra`` the source leaf paths absent from target
    (ignored)."""
    if not isinstance(target, (dict,)):
        src = np.asarray(source)
        tgt_shape = tuple(getattr(target, "shape", np.shape(target)))
        tgt_dtype = np.dtype(getattr(target, "dtype",
                                     np.asarray(target).dtype
                                     if not hasattr(target, "shape")
                                     else target.dtype))
        if tuple(src.shape) != tgt_shape:
            raise ValueError(
                f"shape mismatch at {_path}: checkpoint {src.shape} vs "
                f"model {tgt_shape}")
        return src.astype(tgt_dtype, copy=False), [], []
    merged: Dict[str, Any] = {}
    missing: List[str] = []
    extra: List[str] = [f"{_path}/{k}" for k in source
                        if k not in target] if isinstance(source, dict) else []
    for k, v in target.items():
        if isinstance(source, dict) and k in source:
            m, mi, ex = merge_params(v, source[k], f"{_path}/{k}")
            merged[k] = m
            missing += mi
            extra += ex
        else:
            merged[k] = v
            missing += _leaf_paths(v, f"{_path}/{k}")
    return merged, missing, extra


def _leaf_paths(tree: Any, path: str) -> List[str]:
    if not isinstance(tree, dict):
        return [path]
    out: List[str] = []
    for k, v in tree.items():
        out += _leaf_paths(v, f"{path}/{k}")
    return out


def _replace(params: Dict[str, Any], keys: Sequence[str],
             subtree: Any) -> Dict[str, Any]:
    """Copy-on-write replacement of ``params[keys[0]][keys[1]]...``."""
    out = dict(params)
    node = out
    for k in keys[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[keys[-1]] = subtree
    return out


def _inject(params: Dict[str, Any], keys: Sequence[str], converted: Any,
            allow_missing: Sequence[str] = (), what: str = "") -> Dict[str, Any]:
    node = params
    for k in keys:
        node = node[k]
    merged, missing, _extra = merge_params(node, converted)
    bad = [m for m in missing
           if not any(a in m for a in allow_missing)]
    if bad:
        raise ValueError(
            f"pretrained load of {what or '/'.join(keys)} left model leaves "
            f"uninitialized: {bad[:8]}{'...' if len(bad) > 8 else ''}")
    return _replace(params, keys, merged)


def load_text_classifier(params: Dict[str, Any], spec: Any, root: str,
                         repo_id: str = TEXT_EMOTION,
                         tower_key: str = "bert") -> Tuple[Dict[str, Any], bool]:
    """``BertClassifier``: the ``bert`` tower from a local checkpoint (the
    head stays as drawn, as in the reference). Returns (params, loaded)."""
    d = find_checkpoint_dir(root, repo_id)
    if d is None:
        return params, False
    sd = strip_model_prefix(load_local_state_dict(d))
    conv = convert_text_encoder(sd, spec)
    # classifier checkpoints (j-hartmann) have no pooler; ours stays drawn
    allow = () if "pooler" in conv else ("pooler",)
    return _inject(params, (tower_key,), conv, allow, repo_id), True


def load_audio_classifier(params: Dict[str, Any], spec: Any, root: str,
                          repo_id: str = AUDIO_SUPERB,
                          tower_key: str = "wav2vec2"
                          ) -> Tuple[Dict[str, Any], bool]:
    """``Wav2Vec2Classifier``: the ``wav2vec2`` tower from a local
    checkpoint. Returns (params, loaded)."""
    d = find_checkpoint_dir(root, repo_id)
    if d is None:
        return params, False
    sd = strip_model_prefix(load_local_state_dict(d))
    conv = convert_wav2vec2(sd, spec)
    return _inject(params, (tower_key,), conv, (), repo_id), True


def load_tav(params: Dict[str, Any], spec: Any, root: str
             ) -> Tuple[Dict[str, Any], List[str]]:
    """``TAVModel``: the three pretrained towers and the PreFormer's
    embedding stages, which are copies of the towers' own. The fusion
    trunk, the modality embedding, the wav→hidden projections, the norms
    and the classifier stay as drawn (the reference draws its fusion
    encoder too). Returns (params, the repo ids loaded)."""
    loaded: List[str] = []

    d = find_checkpoint_dir(root, TEXT_EMOTION)
    if d is not None:
        sd = strip_model_prefix(load_local_state_dict(d))
        conv = convert_text_encoder(sd, spec.text)
        allow = () if "pooler" in conv else ("pooler",)
        params = _inject(params, ("model", "text_encoder"), conv, allow,
                         TEXT_EMOTION)
        params = _inject(params, ("preformer", "text_embeddings"),
                         conv["embeddings"], (), TEXT_EMOTION)
        loaded.append(TEXT_EMOTION)

    d = find_checkpoint_dir(root, AUDIO_XLSR)
    if d is not None:
        sd = strip_model_prefix(load_local_state_dict(d))
        conv = convert_wav2vec2(sd, spec.audio)
        params = _inject(params, ("model", "wav2vec2"), conv, (), AUDIO_XLSR)
        # the PreFormer's audio stage reuses the tower's feature extractor,
        # feature projection, positional conv, encoder LayerNorm and
        # masked_spec_embed; with TAVSpec.share_audio_frontend the conv
        # stack is one, at the model's root
        if "audio_frontend" in params:
            params = _inject(params, ("audio_frontend",),
                             conv["feature_extractor"], (), AUDIO_XLSR)
        if "feature_extractor" in params.get("preformer", {}):
            params = _inject(params, ("preformer", "feature_extractor"),
                             conv["feature_extractor"], (), AUDIO_XLSR)
        params = _inject(params, ("preformer", "feature_projection"),
                         conv["feature_projection"], (), AUDIO_XLSR)
        params = _inject(params, ("preformer", "pos_conv"),
                         conv["encoder"]["pos_conv"], (), AUDIO_XLSR)
        enc_ln = (conv["encoder"]["layers"].get("final_ln")
                  or conv["encoder"].get("ln"))
        if enc_ln is not None:
            params = _inject(params, ("preformer", "audio_ln"), enc_ln, (),
                             AUDIO_XLSR)
        params = _replace(params, ("preformer", "masked_spec_embed"),
                          np.asarray(conv["masked_spec_embed"]))
        loaded.append(AUDIO_XLSR)

    d = find_checkpoint_dir(root, VIDEO_MAE)
    if d is not None:
        sd = strip_model_prefix(load_local_state_dict(d))
        conv = convert_videomae(sd, spec.video)
        params = _inject(params, ("model", "videomae"), conv, (), VIDEO_MAE)
        # the PreFormer's video module is the embedding stage alone
        params = _inject(params, ("preformer", "video"),
                         {"patch_embed": conv["patch_embed"]}, (), VIDEO_MAE)
        loaded.append(VIDEO_MAE)

    return params, loaded


def load_slow_r50(params: Dict[str, Any], batch_stats: Dict[str, Any],
                  root: str, stage_sizes: Sequence[int] = (3, 4, 6, 3)
                  ) -> Tuple[Dict[str, Any], Dict[str, Any], bool]:
    """``SlowR50``'s backbone and its BatchNorm statistics from a local
    torch.hub / pytorchvideo checkpoint: ``slow_r50.pt`` / ``.pth`` /
    ``.pyth`` / ``.bin`` (or ``SLOW_8x8_R50.*``) under ``root``, or the
    files of a ``slow_r50/`` directory. ``proj`` and ``classifier`` stay
    as drawn (the reference replaces the head too). Returns (params,
    batch_stats, loaded)."""
    cands: List[str] = []
    for name in (SLOW_R50, "SLOW_8x8_R50"):
        cands += [os.path.join(root, name + ext)
                  for ext in (".pt", ".pth", ".pyth", ".bin")]
        d = os.path.join(root, name)
        if os.path.isdir(d):
            cands += sorted(glob.glob(os.path.join(d, "*.p*")))
    path = next((c for c in cands if os.path.isfile(c)), None)
    if path is None:
        return params, batch_stats, False
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model_state" in raw:
        raw = raw["model_state"]
    conv = convert_slow_r50(raw, stage_sizes)
    merged_p, missing, _ = merge_params(params, conv["params"])
    bad = [m for m in missing if "proj" not in m and "classifier" not in m]
    if bad:
        raise ValueError(f"slow_r50 load left leaves uninitialized: "
                         f"{bad[:8]}")
    merged_s, missing_s, _ = merge_params(batch_stats, conv["batch_stats"])
    if missing_s:
        raise ValueError(f"slow_r50 load left batch stats uninitialized: "
                         f"{missing_s[:8]}")
    return merged_p, merged_s, True
