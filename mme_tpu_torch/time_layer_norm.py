"""Time the fused LayerNorm kernels alone at the model's shapes.

A short loop for iterating on ``csrc/layer_norm.cu``. For every [N, H] that
``MME_FUSED_LN=1`` sends to the kernels in one train step of the bf16 bench
configuration (batch 8, shared audio frontend; :func:`fused_ln_shapes`, with
the launches of one step and of one served chunk) it prints, as one JSON
line:

- the forward (K4a) and backward (K4b) wrapper per call by CUDA events (20
  calls after one warm-up);
- the host time of a wrapper call (µs on the host clock over 200 calls
  queued back to back, before the device is waited for);
- each kernel a wrapper call starts, in launch order, by its device time in
  a ``torch.profiler`` trace (``time_flash.kernel_ms``);
- the library call on the same inputs, a yardstick the port never calls:
  ``F.layer_norm`` with its weight and bias cast to the input's type once
  beforehand, and its autograd backward, one call each;
- the bound (``ops/layer_norm.py::bounds``) and the sums over the launches
  of a step (and of a served chunk for the forward).

``--parent DIR`` also times another checkout (the parent commit unpacked by
``git archive`` into a directory that ``.gitignore`` lists) in a process of
its own, this file run against that checkout's package, in turns parent,
this tree, this tree, parent, so that both are timed on one card.

Run on a machine with a CUDA card: ``python -m mme_tpu_torch.time_layer_norm
[--parent _archive]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter

import torch
import torch.nn.functional as F

from mme_tpu_torch.device import card_line
from mme_tpu_torch.models.audio import Wav2Vec2Spec
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.models.text import TextEncoderSpec
from mme_tpu_torch.models.text_audio import TextAudioSpec
from mme_tpu_torch.models.text_video import TextVideoSpec
from mme_tpu_torch.models.video import VideoMAESpec
from mme_tpu_torch.models.visualbert import VisualBertSpec
from mme_tpu_torch.ops.layer_norm import (MIN_FUSED_ROWS,
                                          fused_layer_norm_bwd,
                                          fused_layer_norm_fwd)
from mme_tpu_torch.time_flash import event_ms, host_us, kernel_ms

EPS = 1e-5


def _encoder_sites(e, rows: int) -> list:
    return [(rows, e.hidden)] * (2 * e.layers + int(e.final_ln))


def ln_sites(spec: TAVSpec, batch: int, text_len: int = 70,
             samples: int = 96000, model: str = "TAVModel"):
    """(rows, features) of every FusedLayerNorm call of one forward of
    ``FUSION_MODELS[model]`` (``TAVModel`` for any name it lacks), from the
    spec alone. The PreFormer and a fusion trunk of ``spec.fusion``'s depth
    are in every model (the variants' trunks differ in LN placement, not in
    count); ``TAVModel`` adds its audio, video and text towers and four
    pooled norms, ``TAVForMAE2Tower`` the text tower and one pooled norm,
    the other variants one pooled norm. The variants' PreFormer keeps its
    own conv stack whatever ``share_audio_frontend`` says."""
    a = spec.audio
    frames, conv = samples, []
    for k, st, d in zip(a.conv_kernels, a.conv_strides, a.conv_dims):
        frames = (frames - k) // st + 1
        conv.append((batch * frames, d))

    text = ([(batch * text_len, spec.text.encoder.hidden)]    # embeddings
            + _encoder_sites(spec.text.encoder, batch * text_len))
    # the PreFormer's conv stack, feature projection, audio_ln and text
    # embeddings, then the fusion trunk
    sites = conv + [(batch * frames, a.conv_dims[-1]),
                    (batch * frames, a.encoder.hidden),
                    (batch * text_len, spec.text.encoder.hidden)]
    sites += _encoder_sites(spec.fusion,
                            batch * (text_len + frames + spec.video_keep_k))
    if model in ("TAVFormer", "TAVForW2V2", "TAVMoE"):
        return sites + [(batch, spec.hidden)]
    if model == "TAVForMAE2Tower":
        return sites + text + [(batch, spec.hidden)]
    if spec.share_audio_frontend:
        sites = sites[len(conv):]     # one conv stack, outside the PreFormer
    # the audio tower's conv stack and feature projection and encoder, the
    # video and text towers and the four pooled norms
    sites += conv + [(batch * frames, a.conv_dims[-1])]
    sites += _encoder_sites(a.encoder, batch * frames)
    sites += _encoder_sites(spec.video.encoder,
                            batch * (spec.video.num_patches
                                     - spec.video_keep_k))
    return sites + text + [(batch, spec.hidden)] * 4


def _wav2vec2_sites(a, batch: int, samples: int) -> list:
    """A full wav2vec2 tower: its extractor's per-conv LayerNorms (the
    ``"layer"`` variant; ``"group"`` has one GroupNorm instead), the
    feature projection's, the post-LN encoder's ``ln`` and the stack."""
    frames, sites = samples, []
    for k, st, d in zip(a.conv_kernels, a.conv_strides, a.conv_dims):
        frames = (frames - k) // st + 1
        if a.feat_extract_norm == "layer":
            sites.append((batch * frames, d))
    rows = batch * frames
    sites.append((rows, a.conv_dims[-1]))
    if not a.do_stable_layer_norm:
        sites.append((rows, a.encoder.hidden))
    return sites + _encoder_sites(a.encoder, rows)


def classifier_ln_sites(spec, batch: int, text_len: int = 70,
                        samples: int = 160000, visual: int = 1) -> list:
    """(rows, features) of every FusedLayerNorm call of one forward of a
    single- or two-modality classifier, from its spec alone: a
    ``TextEncoderSpec`` (``BertClassifier``), ``TextAudioSpec``
    (``BertAudioClassifier``), ``TextVideoSpec`` (``BertVideoMAEMTLShared``
    and ``BertVideoMAELateFusion``, whose sites are the same),
    ``VisualBertSpec`` (``VBertClassifier`` with ``visual`` feature
    vectors), ``VideoMAESpec`` (``VideoMAEClassifier``), ``Wav2Vec2Spec``
    (``Wav2Vec2Classifier``), or None (``LSTMClassifier``, no LayerNorm)."""
    def text(t):
        rows = batch * text_len
        return [(rows, t.encoder.hidden)] + _encoder_sites(t.encoder, rows)

    def video(v):
        return _encoder_sites(v.encoder, batch * v.num_patches)

    if spec is None:
        return []
    if isinstance(spec, TextEncoderSpec):
        return text(spec)
    if isinstance(spec, TextAudioSpec):
        return text(spec.text) + _wav2vec2_sites(spec.audio, batch, samples)
    if isinstance(spec, TextVideoSpec):
        # the pooled fc_norm over B rows
        return (text(spec.text) + video(spec.video)
                + [(batch, spec.video.encoder.hidden)])
    if isinstance(spec, VisualBertSpec):
        e, rows = spec.encoder, batch * (text_len + visual)
        # the embeddings' LN over text and visual tokens, the stack, the MLM
        # head's transform_ln
        return [(rows, e.hidden)] + _encoder_sites(e, rows) + [(rows,
                                                                 e.hidden)]
    if isinstance(spec, VideoMAESpec):
        return video(spec)
    if isinstance(spec, Wav2Vec2Spec):
        return _wav2vec2_sites(spec, batch, samples)
    raise TypeError(f"no LayerNorm sites for a {type(spec).__name__}")


def fused_ln_sites(sites) -> Counter:
    """The sites that MME_FUSED_LN=1 sends to the kernels, by shape."""
    return Counter((n, h) for n, h in sites
                   if n >= MIN_FUSED_ROWS and h % 8 == 0)


def fused_ln_shapes(spec: TAVSpec, batch: int,
                    model: str = "TAVModel") -> Counter:
    """The sites of a fusion model that MME_FUSED_LN=1 sends to the
    kernels, by shape."""
    return fused_ln_sites(ln_sites(spec, batch, model=model))


def step_and_chunk_shapes(batch: int = 8) -> list:
    """(N, H, launches per train step, launches per served chunk) of every
    shape, the step's model sharing its audio frontend as ``bench.py``'s."""
    spec = TAVSpec(output_dim=7)
    step = fused_ln_shapes(dataclasses.replace(
        spec, share_audio_frontend=True), batch)
    chunk = fused_ln_shapes(spec, batch)
    return [(n, h, step[(n, h)], chunk[(n, h)])
            for n, h in sorted(set(step) | set(chunk))]


def time_tree() -> dict:
    """Times only, through the wrappers that every checkout of the port
    has; the bounds are added by the caller."""
    dt = torch.bfloat16
    rows = []
    for n, h, per_step, per_chunk in step_and_chunk_shapes():
        g = torch.Generator(device="cuda").manual_seed(n)
        x = (torch.randn(n, h, generator=g, device="cuda") * 2 + 0.5).to(dt)
        w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
        b = 0.2 * torch.randn(h, generator=g, device="cuda")
        gy = torch.randn(n, h, generator=g, device="cuda").to(dt)
        calls = {"fwd": lambda: fused_layer_norm_fwd(x, w, b, EPS, dt),
                 "bwd": lambda: fused_layer_norm_bwd(gy, x, w, EPS)}
        # the library's operands in the input's type, cast once here
        lx, lw, lb = (t.detach().to(dt).requires_grad_() for t in (x, w, b))
        ly = F.layer_norm(lx, (h,), lw, lb, EPS)
        library = {"fwd": lambda: F.layer_norm(x, (h,), lw, lb, EPS),
                   "bwd": lambda: torch.autograd.grad(
                       ly, (lx, lw, lb), gy, retain_graph=True)}
        row = {"N": n, "H": h, "dtype": "bf16", "launches_per_step": per_step,
               "launches_per_chunk": per_chunk}
        with torch.no_grad():           # no graph for the forwards
            row["fwd"] = _times(calls["fwd"], library["fwd"])
        row["bwd"] = _times(calls["bwd"], library["bwd"])
        rows.append(row)
        del ly, lx
    return {"layer_norm": rows}


def _times(call, library) -> dict:
    return {"ms": event_ms(call, iters=20), "host_us": host_us(call),
            "kernels": kernel_ms(call),
            "library_ms": event_ms(library, iters=20)}


def with_bounds(result: dict) -> dict:
    """Adds the bound of each call and the sums over the launches of a step
    (both kernels) and of a served chunk (the forward)."""
    from mme_tpu_torch.ops.layer_norm import bounds
    total = {}
    for row in result["layer_norm"]:
        for (_, _, bound, by), key in zip(
                bounds(row["N"], row["H"], 2), ("fwd", "bwd")):
            t = row[key]
            t.update(bound_ms=bound, bound_by=by,
                     kernels_ms=sum(k["ms"] for k in t["kernels"]))
            units = [("step", row["launches_per_step"])]
            if key == "fwd":
                units.append(("chunk", row["launches_per_chunk"]))
            for unit, count in units:
                for what in ("ms", "kernels_ms", "library_ms", "bound_ms",
                             "host_us"):
                    name = f"{key}_{what}_per_{unit}"
                    total[name] = total.get(name, 0.0) + t[what] * count
                name = f"{key}_launches_per_{unit}"
                total[name] = total.get(name, 0) + count
    return {**result, "sums": total}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=None,
                        help="another checkout to time in turns with this one")
    parser.add_argument("--times-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_layer_norm needs a CUDA device")
    if args.times_only:
        print(json.dumps(time_tree()), flush=True)
        return
    card = card_line()
    if args.parent is None:
        print(json.dumps({**with_bounds(time_tree()), "card": card}),
              flush=True)
        return
    # this file against the other checkout's package: run from its root
    script = (f"import runpy, sys; sys.argv = ['time_layer_norm', "
              f"'--times-only']; runpy.run_path({os.path.abspath(__file__)!r},"
              f" run_name='__main__')")
    for turn in ("parent", "change", "change", "parent"):
        if turn == "parent":
            out = subprocess.run([sys.executable, "-c", script],
                                 cwd=args.parent, capture_output=True,
                                 text=True)
            if out.returncode != 0:
                raise SystemExit(f"the parent's turn failed:\n{out.stderr}")
            result = json.loads(out.stdout.strip().splitlines()[-1])
        else:
            result = time_tree()
        print(json.dumps({"turn": turn, **with_bounds(result), "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
