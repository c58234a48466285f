"""Where the TAV train step's time goes, tower by tower.

Port of ``scripts/profile_towers.py``. At ``bench.py``'s shapes (batch 8,
70 tokens, 96 000 samples, a 16x224x224 clip; bf16 compute over fp32
weights, the audio conv stack shared and recomputed) it times each
tower's forward and backward alone, the whole model's, and the AdamW
update alone over the whole model's parameters:

- ``text_tower``: DistilRoBERTa's 6 layers over 70 tokens;
- ``audio_tower_with_conv``: the conv stack and wav2vec2-large's 24 layers
  over 299 frames;
- ``video_tower_1464``: VideoMAE's 12 layers over the 1 464-token
  complement of the fused tower's visible patches;
- ``fusion_trunk_473``: the 12-layer trunk over 70 + 299 + 104 tokens
  (the two names carry the token counts of the spec and shapes given);
- ``full_model_fwd_bwd``: ``TAVModel`` (no optimizer);
- ``adamw_update``: one ``Optimizer.update`` with all-ones gradients
  (``MME_OPT_STATE`` as the train step reads it; K3 with
  ``MME_FUSED_ADAM=1`` and bf16 moments).

Each loss is ``sum(out**2) * 1e-6`` and each time the best of
``PROF_WINDOWS`` windows (default 3) of ``PROF_STEPS`` calls (default
10) after one warm-up call, at ``PROF_BATCH`` (default 8): CUDA events on
the card, the host clock on the CPU. Weights are drawn on the device from
a seed (normal at 1/sqrt(fan-in), norm scales 1, biases 0): a timing
needs their scale, not flax's exact draw. It prints one JSON object with
the kernels each part launched per call, the card's name and power limit.

Run on the card: ``python -m mme_tpu_torch.profile_towers``; from Python,
:func:`run` takes a ``spec`` and a ``device``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
from typing import Callable, Dict, Optional

import torch

from mme_tpu_torch.device import DeviceLike, card_line, resolve_device
from mme_tpu_torch.flash_crossover import best_ms
from mme_tpu_torch.models.audio import Wav2Vec2Model
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.models.layers import TransformerEncoder
from mme_tpu_torch.models.text import TextEncoder
from mme_tpu_torch.models.video import VideoMAEModel
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.audio import conv_output_lengths
from mme_tpu_torch.train.build_tav import example_tav_batch
from mme_tpu_torch.train.steps import make_optimizer, to_device

TEXT_LEN, AUDIO_LEN = 70, 96000


def bench_spec() -> TAVSpec:
    """``bench.py``'s model: full width, bf16 compute, the audio conv stack
    shared and recomputed."""
    spec = TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16)
    return dataclasses.replace(
        spec, audio=dataclasses.replace(spec.audio, remat_conv=True),
        share_audio_frontend=True)


def draw_on_device(module: torch.nn.Module, seed: int) -> None:
    """Fill every parameter on its own device: a matrix or kernel normal
    with std 1/sqrt(fan-in) (its elements over its first dimension), a
    1-D ``weight`` (a norm's scale) 1, any other vector 0."""
    g = None
    with torch.no_grad():
        for name, p in module.named_parameters():
            if g is None:
                g = torch.Generator(device=p.device).manual_seed(seed)
            if p.dim() >= 2:
                fan_in = max(p.numel() // p.shape[0], 1)
                p.normal_(0.0, fan_in ** -0.5, generator=g)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def _fwd_bwd(module: torch.nn.Module, call: Callable) -> Callable:
    params = [p for p in module.parameters() if p.requires_grad]

    def step():
        out = call()
        if isinstance(out, tuple):
            out = out[0]
        loss = torch.sum(out.float() ** 2) * 1e-6
        return torch.autograd.grad(loss, params, allow_unused=True)
    return step


def _launches(fn: Callable) -> Dict[str, int]:
    kernels.reset_launches()
    fn()
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def run(spec: Optional[TAVSpec] = None, device: DeviceLike = "cuda",
        batch: Optional[int] = None, steps: Optional[int] = None,
        windows: Optional[int] = None, text_len: int = TEXT_LEN,
        audio_len: int = AUDIO_LEN) -> dict:
    """Time every part; returns (and prints) the report. The modules run
    in eval mode (no dropout, no SpecAugment), their gradients recorded."""
    dev = resolve_device(device)
    spec = bench_spec() if spec is None else spec
    B = batch or int(os.environ.get("PROF_BATCH", "8"))
    steps = steps or int(os.environ.get("PROF_STEPS", "10"))
    windows = windows or int(os.environ.get("PROF_WINDOWS", "3"))
    batch_np = example_tav_batch(spec, B, text_len, audio_len)
    b = to_device(batch_np, dev)
    ms: Dict[str, float] = {}
    launches: Dict[str, Dict[str, int]] = {}

    def part(name: str, module: torch.nn.Module, call: Callable) -> None:
        draw_on_device(module, seed=len(ms))
        module.eval()
        fn = _fwd_bwd(module, call)
        ms[name] = best_ms(fn, dev, steps, windows)
        launches[name] = _launches(fn)
        print(f"# {name}: {ms[name]:.3f} ms", flush=True)
        del fn
        gc.collect()

    text = TextEncoder(spec.text, device=dev)
    part("text_tower", text, lambda: text(b["input_ids"], b["text_mask"]))
    del text

    audio = Wav2Vec2Model(spec.audio, device=dev)
    part("audio_tower_with_conv", audio,
         lambda: audio(b["waveform"], b["audio_mask"]))
    del audio

    video = VideoMAEModel(spec.video, device=dev)
    comp_keep = torch.logical_not(b["video_keep"])
    k_comp = spec.video.num_patches - spec.video_keep_k
    part(f"video_tower_{k_comp}", video,
         lambda: video(b["video"], comp_keep, k_comp))
    del video

    fusion = TransformerEncoder(spec.fusion, device=dev)
    frames = int(conv_output_lengths(torch.tensor([audio_len]),
                                     spec.audio.conv_kernels,
                                     spec.audio.conv_strides)[0])
    s_f = text_len + frames + spec.video_keep_k
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, s_f, spec.fusion.hidden), generator=g, device=dev)
    bias = additive_mask(torch.ones((B, s_f), device=dev))
    part(f"fusion_trunk_{s_f}", fusion, lambda: fusion(x, bias))
    del fusion, x

    model = TAVModel(spec, device=dev)
    try:
        part("full_model_fwd_bwd", model, lambda: model(b))
    except torch.cuda.OutOfMemoryError as e:
        print(f"# full_model_fwd_bwd skipped: {type(e).__name__}",
              flush=True)
    gc.collect()

    # the optimizer alone: clip → AdamW over every leaf of the model
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    tx = make_optimizer(lambda step: 1e-5, 1e-4, 1.0)
    opt_gen = torch.Generator(device=dev).manual_seed(0)
    state = tx.init(params, opt_gen)
    grads = [torch.ones_like(p) for p in params]

    def opt_step():
        tx.update(params, grads, state, opt_gen)

    ms["adamw_update"] = best_ms(opt_step, dev, steps, windows)
    launches["adamw_update"] = _launches(opt_step)
    report = {
        "batch": B, "n_params": n_params, "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
        "opt_state": tx.state_dtype,
        "fused_adam": os.environ.get("MME_FUSED_ADAM", "0"),
        "ms": ms, "launches": launches,
        "sum_towers_ms": sum(v for k, v in ms.items()
                             if k != "full_model_fwd_bwd"),
        "utt_per_sec_full_fwd_bwd": (B * 1e3 / ms["full_model_fwd_bwd"]
                                     if "full_model_fwd_bwd" in ms
                                     else None),
    }
    if dev.type == "cuda":
        report["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated(dev) / 1e9)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    run()
