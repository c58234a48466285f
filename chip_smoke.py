"""Smoke run of the PyTorch/CUDA port (``mme_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.
2. Build: every CUDA kernel from ``mme_tpu_torch/csrc/`` (flash forward
   and backward, the fused MLP, the fused LayerNorm, the fused Adam
   update), one ``nvcc`` per source started together; prints the build
   time, ``-Xptxas -v`` of the flash kernels and a summary of the fused
   MLP's (registers, spills), of every flash kernel's (registers, spills,
   wgmma serialized by ptxas or not), of every LayerNorm instance's
   (registers, spills, static shared memory; the ring's dynamic shared
   memory is printed per shape in phase 3) and of the Adam kernel's.
3. Kernels against their plain PyTorch versions on the card:
   - the flash forward (K1) and backward (K2), q/k/v as strided views of a
     fused QKV tensor, at the four model shapes, wav2vec2-base's
     [8, 299, 12 heads] and phase 10's [8, 499], [8, 1 568] (no key mask)
     and [8, 71] at 12 heads in bf16 and fp32, a ragged
     key length with head_dim 128, rows whose every key is masked by bias
     and, for K2, a sentinel row (every score -inf). Times each kernel, its
     plain version and ``scaled_dot_product_attention`` forward / backward
     (a yardstick the port never calls) at the bf16 shapes with CUDA events;
   - the fused bf16-moment Adam update (K3) on the model's leaf shapes:
     exact in ``zero_noise`` mode, and with noise every moment is one of
     the two bf16 neighbours, the mean error is within 5 standard errors,
     other leaves and steps get other dither, and the moments equal the
     plain version's bit for bit on the same Philox words; one launch over
     a mixed list (fp32 and bf16 gradients, 1 to 38.6 M elements, a leaf
     not 16-byte aligned), fresh and in place; one launch over the step's
     725 trainable leaves against the plain version on the same words.
     Times one call over the step's trainable leaves (and over its 235 big
     ones, the per-leaf kernel's old set): wrapper by CUDA events, kernel
     alone in a profiler trace, host µs per call, the plain version once;
   - the fused LayerNorm forward (K4a) and backward (K4b) at [2 392, 1024],
     [11 712, 768], [3 784, 768], [153 592, 512], wav2vec2-base's
     [2 392, 768] and [2 392, 512], phase 10's [3 992, 768], [3 992, 512]
     and [12 544, 768], a ragged [3 001, 768] and
     the widest row [1 024, 8 192] in bf16 and fp32, fp32 in / bf16 out, and
     x as a row-offset view: y, dx, dscale, dbias, two runs bit-equal. Times
     them at every shape a training step launches, beside ``F.layer_norm``
     and its backward (weight and bias cast to bf16 once, outside the
     timed call), with the bounds of ``ops/layer_norm.py::bounds``;
   - the wgmma/TMA product core of the bf16 MLP kernels alone
     (``gemm_bf16``) against an fp32 product at the four operand orders,
     ragged extents and the video tower's product shapes;
   - the fused MLP forward (K5a) and backward (K5b) at the four full-width
     tower shapes and wav2vec2-base's (2 392, 768, 3072) in bf16, phase
     10's (3 992 | 12 544 | 568, 768, 3072) in bf16 and fp32, a small
     shape in fp32 and bf16 with each of the four activations, N = 1, 17
     and 129 at H = 256 to 1024 in bf16, and a wide fp32 shape: out, dx,
     dW1, dW2, db1, db2, two runs bit-equal.
     Times them at the tower shapes beside the unfused
     ``F.linear → gelu → F.linear`` and its autograd backward.
4. Serving at full width: ``init_params(TAVSpec(output_dim=7))`` →
   ``from_flax`` → ``TAVModel`` → ``Predictor(batch_size=8)`` serving ragged
   requests (8, 5 and 11 utterances, uint8 video) in an fp32 and a bf16
   leg. Each leg is held against the same Predictor with ``MME_FLASH=0``
   (54 flash launches per chunk), then served again with
   ``MME_FUSED_LN=1 MME_FUSED_MLP=1`` and held against the knobs-off
   probabilities: 54 K5a launches per chunk and the K4a count computed from
   the spec. Prints ms per batch of 8 with the knobs off and on,
   utterances per second and peak device memory for the bf16 leg.
5. Training at full width and depth through ``build_tav`` (70 tokens,
   96 000 samples, a 16x224x224 clip, shared audio frontend, no remat, no
   accumulation buffer):
   (1) fp32 compute, dropout and SpecAugment off, batch 4: loss and
       gradients of one batch with the kernels against ``MME_FLASH=0``
       (54 forward and 54 backward launches with, none without), and with
       both knobs on against both off: 54 + 54 launches of K5a/K5b and
       K1/K2, the computed K4a/K4b counts;
   (2) a deterministic bf16 leg (dropout off) on one fixed batch of 8: the
       loss after four steps must lie below the first;
   (3) the benchmark configuration: bf16 compute, batch 8, dropout and
       SpecAugment on, ``MME_OPT_STATE=bf16``, lr 5e-6, cosine warm
       restarts; 2 warm-up and 4 timed steps, 54 + 54 launches per step;
       prints ms per step, utterances per second, peak memory and a
       forward / backward / optimizer split by CUDA events;
   (4) the same state with ``MME_FUSED_ADAM=1``: one K3 launch per step
       covering every trainable leaf, the moments bf16 and updated in
       place, peak memory within 0.2 GB of leg (3)'s; device kernels per
       step beside leg (3)'s (profiler);
   (5) the same state with ``MME_FUSED_LN=1 MME_FUSED_MLP=1``: launches per
       step, ms per step, the split and peak memory beside leg (3)'s.
6. The training loop at full width: phase 5's weights in a fresh bf16
   ``TAVModel`` (dropout 0.1, shared audio frontend) through the CLI's
   ``cli/common.py::run_classifier`` with ``MME_OPT_STATE=bf16
   MME_FUSED_ADAM=1`` on synthetic records (70 tokens, 96 000 samples, a
   16x224x224 clip; 32 / 8 / 8 utterances), batch 8, two epochs,
   validation every 2 steps, random keep-masks and SpecAugment, checkpoints
   in a temporary directory deleted at the end. Epoch 0 runs the weighted
   sampler and plain loss; epoch 1 runs in order with class weights and
   dialog accumulation (dialogs of 16: two batches per update). Checks:
   finite losses in both epochs; 54 K1 launches per train step and eval
   batch, 54 K2 per train step, one K3 per applied update (6 for 8
   steps); no saved state carries the accumulation buffer; the best
   checkpoint restored into fresh tensors equals the state the loop
   returned bit for bit; a save followed by a train step before its
   ``wait()`` still restores the state of the save (the step rewrites
   parameters and moments in place); ``MME_EVAL_ONLY=1`` on the same
   directory reproduces the test matrix and loss. Prints the loop's
   utterances per second beside leg (4)'s bare step, peak memory,
   checkpoint size, the host ms of each save's blocking part, of each
   ``wait()`` and of each restore, free disk space and the phase's time;
   then runs one more epoch under ``torch.profiler`` (device activity
   only) for the device's busy share of it. The eval-only run also sets
   ``MME_PREDICT_OUT`` and ``MME_EXPORT_BUNDLE`` to a temporary directory:
   phase 7's first leg.
7. The serving front ends at full width, on phase 6's trained model (bf16
   compute over fp32 weights, batch 8):
   (1) the eval-only run's exports: one prediction row per test utterance,
       probabilities summing to 1; a bundle whose program calls K1 as the
       operator ``mme_tpu_torch::flash_fwd``; export, save and load
       seconds and the bundle's size;
   (2) the bundle loaded with ``load_bundle(device="cuda")`` serves phase
       4's requests (video normalised, fixed keep-masks) against a live
       ``Predictor`` on the bundle's weights: probabilities within
       ``SERVE_TOL[bf16]``, predictions equal where the top-2 margin
       exceeds it, 54 K1 launches per chunk and no other kernel; ms per
       batch of 8 of both;
   (3) a second bundle exported with ``MME_FUSED_LN=1 MME_FUSED_MLP=1``,
       served with the knobs unset: K1, K5a (54 each) and K4a (the spec's
       count) per chunk through the operators, against the live model;
   (4) ``python -m mme_tpu_torch.cli.serve`` on the first bundle in a
       process of its own: ``/healthz`` and one float-video utterance
       against leg (2); then a live ``Predictor`` behind ``make_server`` in
       this process with 3 uint8-video utterances against the Predictor
       itself. Prints ms per request and request bytes, the phase's time
       and peak memory; the temporary directory is deleted.
8. The rest of the fusion family at full width and depth: ``TAVFormer``,
   ``TAVForMAE2Tower``, ``TAVForW2V2`` and the sparse-MoE ``TAVMoE``, each
   ``TAVSpec(output_dim=7)`` with weights from ``init_params(spec, seed,
   model=name)``, one after another, each freed before the next:
   (1) served by ``Predictor(batch_size=8)`` on phase 4's requests in bf16
       against ``MME_FLASH=0`` (K1 per chunk: 12, 18, 12, 12), then with
       ``MME_FUSED_LN=1 MME_FUSED_MLP=1`` against the knobs-off
       probabilities (K5a: 12, 18, 12, 6; K4a from the spec,
       ``time_layer_norm.ln_sites(model=name)``); a zero-padded partial
       chunk gives its rows the probabilities of a full chunk. ``TAVMoE``
       holds both comparisons in fp32, where every token's expert set must
       agree (a flip is allowed only at a near-tie of the router, and then
       the run is not held to the fp32 tolerance but says so); its bf16 leg
       checks finite probabilities and prints how many tokens routed
       differently;
   (2) trained: fp32, no dropout, batch 4, loss and gradients with the
       kernels against ``MME_FLASH=0`` (K1 and K2 as in serving; for
       ``TAVMoE`` the aux term finite, positive and in the loss, the
       router's gradient nonzero); then four bf16 steps on one batch of 8
       with ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and both knobs on: the
       eval loss after them below the one before, one K3 launch per step;
   (3) ``TAVMoE`` only: ``run_classifier(..., has_aux_loss=True)`` for one
       epoch of 4 steps and one validation (bf16, ``MME_OPT_STATE=bf16
       MME_FUSED_ADAM=1``) with ``MME_EXPORT_BUNDLE`` set, and the bundle
       loaded with ``load_bundle(device="cuda")`` against a live
       ``Predictor`` on its weights (12 K1 per chunk through the operator).
   Prints one JSON line per model: parameters, ms per batch of 8 served
   with the knobs off and on, ms per bf16 train step, peak memory, every
   launch count, the model's seconds and the card.

9. The audio classifier and the BatchNorm models at full width, each freed
   before the next:
   (1) ``Wav2Vec2Classifier(Wav2Vec2Spec.base(), output_dim=7)`` with
       weights from ``init_variables``, through ``BatchModel`` and phase
       10's legs: served by
       ``Predictor(batch_size=8)`` in bf16 on 8, 5 and 11 utterances of
       96 000 samples with ragged keep-masks (``synthetic_audio_dataset``)
       against ``MME_FLASH=0`` (12 K1 per chunk), then with both knobs on
       against both off (12 K5a, 26 K4a per chunk); fp32 loss and gradient
       norm of a batch of 8 with K1/K2 against ``MME_FLASH=0``; four bf16
       steps on one batch with ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and
       both knobs (12 K1, K2, K5a, K5b, 26 K4a, K4b and one K3 per step),
       the eval loss after them below the one before; ``run_classifier``
       for one epoch of 4 steps with ``MME_EXPORT_BUNDLE``, the bundle
       against a live ``Predictor`` (12 K1 per chunk through the operator);
   (2) ``SlowR50(output_dim=7)`` at ``visual_nn``'s full size (stages
       (3, 4, 6, 3), batch 8 of 16x224x224 clips, fp32): one train step
       whose stem BatchNorm statistics are held against
       0.9 · init + 0.1 · (mean, ``var(unbiased=False)``) of the stem's
       output, three more steps with the eval loss falling, a checkpoint
       round trip restoring parameters and statistics bit for bit after a
       step moved them, a bundle against the live ``Predictor``;
   (3) ``ResnetClassifier(output_dim=2)`` at 224x224 through
       ``run_classifier`` for one epoch with ``images_nn``'s frozen-backbone
       mask: every backbone parameter but ``backbone.fc`` unchanged bit for
       bit, the running statistics moved, the head moved;
   (4) ``Conv3DClassifier`` and ``ConvNetClassifier`` at their CLIs' full
       sizes: a forward and two train steps each.
   Prints one JSON line per model: parameters, ms per served batch or train
   step, peak memory, launch counts, the model's seconds and the card.
10. The text and two-modality classifiers at full width, each with weights
   from ``init_variables`` behind ``cli/common.BatchModel`` and freed
   before the next: ``BertClassifier`` (DistilRoBERTa, 70 tokens),
   ``BertAudioClassifier`` (+ wav2vec2-base over 160 000 samples with
   ragged keep-masks), ``BertVideoMAELateFusion`` and
   ``BertVideoMAEMTLShared`` (+ VideoMAE over 16x224x224 clips),
   ``VBertClassifier`` (70 tokens and one 1 024-d visual vector, 2
   classes) and ``VideoMAEClassifier``:
   (1) served by ``Predictor(batch_size=8)`` in bf16 on 8, 5 and 11 rows
       drawn as their CLIs draw them (the MTL with a per-row task) against
       ``MME_FLASH=0`` (K1 per chunk: 6, 18, 18, 18, 12, 12), then with
       both knobs on against both off (K5a as many, K4a from
       ``time_layer_norm.classifier_ln_sites``: 0, 26, 24, 24, 0, 24);
       ``VBertClassifier``'s decoder is the word table's own tensor;
   (2) but ``VideoMAEClassifier``: fp32, no dropout, batch 8, loss and
       gradient norm with K1/K2 against ``MME_FLASH=0``; the MTL once with
       task 0 and once with task 1, the other tower's gradients exactly
       zero and the chosen tower's, ``shared_layer``'s and the head's not;
   (3) ``BertClassifier``, ``BertAudioClassifier``, the late fusion and
       ``VBertClassifier``: four bf16 steps on one batch of 8 with
       ``MME_OPT_STATE=bf16 MME_FUSED_ADAM=1`` and both knobs, every
       step's launches as served plus K2, K5b, K4b and one K3, the eval
       loss after them below the one before;
   (4) ``BertAudioClassifier`` through ``run_classifier`` for one epoch of
       4 steps with ``MME_EXPORT_BUNDLE``, the bundle against a live
       ``Predictor`` (18 K1 per chunk through the operator);
   (5) ``LSTMClassifier`` at ``text_nn``'s size (vocabulary 5 000,
       300-wide, one layer) over 8 x 70 tokens: a forward and two steps
       launching no kernel of the port;
   (6) ``text_nn`` (BERT and LSTM), ``text_audio_nn``, ``text_video_nn -m
       1MTL`` and ``visual_bert_nn`` for one synthetic epoch at batch 8 on
       the card, at their tiny specs.
   Prints one JSON line per model: parameters, ms per served batch of 8
   with the knobs off and on, ms per bf16 step, peak memory serving and
   training, launches per chunk and per step, the largest probability gap
   against ``MME_FLASH=0``, the model's seconds and the card.

Then one JSON line of per-kernel results (seven kernels;
``launches_<model>`` gives phases 8, 9 and 10's counts: a served chunk
with both knobs on for a forward kernel, a bf16 train step for the
others, the MTL's fp32 step, 0 for a model without a train leg), the
card's name and power limit, and last the line
``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mme_tpu_torch.cli import (images_nn, text_audio_nn, text_nn,
                               text_video_nn, visual_bert_nn, visual_nn)
from mme_tpu_torch.cli.common import BatchModel, run_classifier
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import from_flax, init_params, init_variables
from mme_tpu_torch.data.dataset import batches
from mme_tpu_torch.data.synthetic import (synthetic_audio_dataset,
                                          synthetic_image_dataset,
                                          synthetic_tav_dataset,
                                          synthetic_text_dataset)
from mme_tpu_torch.device import PEAK_BF16_FLOPS, PEAK_BYTES, card_line
from mme_tpu_torch.models.audio import Wav2Vec2Classifier, Wav2Vec2Spec
from mme_tpu_torch.models.fusion import (FUSION_MODELS, TAVModel,
                                         TAVMoEFormer, TAVSpec)
from mme_tpu_torch.models.image import ConvNetClassifier, ResnetClassifier
from mme_tpu_torch.models.moe import MoEMlp, router_gates
from mme_tpu_torch.models.text import (BertClassifier, LSTMClassifier,
                                       TextEncoderSpec)
from mme_tpu_torch.models.text_audio import BertAudioClassifier, TextAudioSpec
from mme_tpu_torch.models.text_video import (BertVideoMAELateFusion,
                                             BertVideoMAEMTLShared,
                                             TextVideoSpec)
from mme_tpu_torch.models.video import (Conv3DClassifier, SlowR50,
                                        VideoMAEClassifier, VideoMAESpec)
from mme_tpu_torch.models.visualbert import VBertClassifier, VisualBertSpec
from mme_tpu_torch import time_adam
from mme_tpu_torch.ops import adam_update, kernels
from mme_tpu_torch.ops.adam_update import (adam_update_leaf,
                                           adam_update_leaf_plain,
                                           adam_update_leaves,
                                           adam_update_leaves_plain)
from mme_tpu_torch.ops.attention import additive_mask
from mme_tpu_torch.ops.fused_mlp import (ACTS, fused_mlp_bwd,
                                         fused_mlp_bwd_plain, fused_mlp_fwd,
                                         fused_mlp_fwd_plain, gemm_bf16,
                                         gemm_operand_major, kernel_supports)
from mme_tpu_torch.ops.fused_mlp import bounds as mlp_bounds
from mme_tpu_torch.ops.layer_norm import bounds as ln_bounds
from mme_tpu_torch.ops.layer_norm import (fused_layer_norm_bwd,
                                          fused_layer_norm_bwd_plain,
                                          fused_layer_norm_fwd,
                                          fused_layer_norm_fwd_plain,
                                          launch_geometry, smem_bytes)
from mme_tpu_torch.ops.flash_attention import (bounds as flash_bounds,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain)
from mme_tpu_torch.ops.video import normalize_uint8_video
from mme_tpu_torch.serve import Predictor, export_bundle, load_bundle
from mme_tpu_torch.serve_http import PredictionService, make_server
from mme_tpu_torch.time_layer_norm import (classifier_ln_sites,
                                           fused_ln_shapes, fused_ln_sites)
from mme_tpu_torch.train.build_tav import (build_tav, example_tav_batch,
                                           make_video_keep_transform)
from mme_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.optim import AdamWState, global_norm_f32
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step,
                                       model_buffers, to_device)

SEED = 0
# tolerances of the flash kernel against its plain version, elementwise
# |O - O_plain| <= atol + rtol |O_plain| and relative on LSE:
# fp32 — both sum fp32 products, in other orders: a few fp32 ulps of |O|;
# bf16 — the kernel rounds the unnormalised P to bf16 and the plain version
# the normalised probabilities, and O itself is rounded to bf16 (one ulp is
# 2^-8 relative): a bf16 ulp or two of |O|; LSE is summed in fp32 on both
# sides.
TOL = {torch.float32: {"atol": 1e-5, "rtol": 1e-5, "lse": 1e-5},
       torch.bfloat16: {"atol": 2e-2, "rtol": 1e-2, "lse": 1e-3}}
# served probabilities, flash against MME_FLASH=0 on the same weights and
# requests: fp32 agrees to fp32 rounding carried through 54 attention
# layers; bf16 carries the per-layer bf16 differences above through the
# towers' depth (24 audio layers)
SERVE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# gradients of the flash backward against its plain version, as a share of
# each gradient's largest element (a gradient that is zero but for
# cancellation is held to a twentieth of the largest of the three): fp32 —
# sums of up to 1568 fp32 products in another order; bf16 — P and dS are
# rounded to bf16 on both sides at fp32 values that differ in the last
# place, and the result is rounded to bf16 once more. The kernel has no
# atomics: two runs give the same bits.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# fused Adam: the update `out` may differ from the plain version's by this
# many fp32 units in the last place (division and square root round to
# nearest on both sides; measured 0); the moments must be equal
ADAM_OUT_ULPS = 2
# training, kernels against MME_FLASH=0 from the same state, fp32 compute:
# fp32 rounding carried through 54 layers, forward and backward
TRAIN_LOSS_RTOL = 1e-5
TRAIN_NORM_RTOL = 1e-3
# fused LayerNorm against its plain version, elementwise |y - y_plain| <=
# atol + rtol |y_plain| on y and dx: both sides compute in fp32 and differ by
# an ulp or so (rsqrt, fused multiply-adds) before the cast, so a few fp32
# ulps, or one bf16 step after a bf16 cast; dscale and dbias are fp32 sums
# over up to 153 592 rows in another order, held to 1e-4 of their largest
# element. No atomics: two runs give the same bits.
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
LN_SUM_RTOL = 1e-4
# fused MLP against its plain version, as a share of each tensor's largest
# element: fp32 — sums of up to 4096 (dW: N) fp32 products in another order;
# bf16 — `a` and `dh` are rounded to bf16 on both sides at fp32 values that
# differ in the last place and each result is rounded to bf16 once more.
# db1 and db2 are fp32 sums on both sides (1e-4 in bf16, where db1 sums the
# unrounded dh). No atomics: two runs give the same bits.
MLP_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLP_BIAS_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}
# both knobs on against both off, same weights and inputs: served
# probabilities as SERVE_TOL; training in fp32 as TRAIN_*_RTOL (LayerNorm
# and the MLP products summed in other orders through 54 layers)
KNOBS = {"MME_FUSED_LN": "1", "MME_FUSED_MLP": "1"}
# (name, batch, seq, heads) of the attention calls of one served chunk:
# 6 text, 24 audio, 12 video and 12 fusion layers, head_dim 64
SERVED = (("text", 8, 70, 12, 6), ("audio", 8, 299, 16, 24),
          ("video", 8, 1464, 12, 12), ("fusion", 8, 473, 12, 12))
LAUNCHES_PER_CHUNK = sum(n for *_, n in SERVED)   # 54
# (name, seq, key mask) of phase 10's attention calls beyond SERVED's, batch
# 8, 12 heads of 64: wav2vec2-base over 160 000 samples, VideoMAE over
# 16x224x224 clips (no key mask), VisualBERT's 70 tokens and 1 visual
SLICE_ATTENTION = (("audio_base_160k", 499, True), ("videomae", 1568, False),
                   ("visualbert", 71, True))


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spills of every kernel in one
    source's ``-Xptxas -v`` output (the fused MLP's shared memory is
    dynamic, sized per launch)."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
    return {"kernels": len(regs), "registers": sorted(regs),
            "max_registers": max(regs), "spill_bytes": sum(spills),
            "static_smem_bytes": sorted(set(smem))}


def kernel_ptxas(log: str) -> list:
    """Registers, spill bytes and static shared memory of every kernel in
    one source's ``-Xptxas -v`` output, by kernel and template arguments
    (D and element type; for LayerNorm x and y or g in bf16 (1) or fp32 (0)
    and the chunks per thread)."""
    out = []
    # ptxas names each kernel whose wgmma it serialised (C7512, C7515, ...)
    serialized = set(re.findall(r"are serialized[^\n]*'([^'\n]+)'", log))
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"'([^'\n]+)'", block).group(1)
        # _ZN..._<source>_cu_<8 hex digits><length><kernel name>I...
        at = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
        base = (name[at.end():at.end() + int(at.group(1))] if at
                else name)
        args = re.findall(r"Li(\d+)E", name)
        if "bfloat16" in name:
            args.append("bf16")
        elif re.search(r"IfLi", name):
            args.append("fp32")
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", block)
        out.append({"kernel": base + "<" + ",".join(args) + ">",
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": (int(spills.group(1)) + int(spills.group(2))
                                    if spills else None),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "serialized_wgmma": name in serialized})
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, Sq, Sk, H, D, dtype, masked_rows, seed):
    """q, k, v as strided views of fused QKV tensors (the layout the model
    hands the kernel) and a key-mask bias with ragged lengths; the first
    ``masked_rows`` batch rows have every key masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, Sk, 3, H, D, generator=g, device="cuda").to(dtype)
    q = qkv[:, :, 0] if Sq == Sk else torch.randn(
        B, Sq, 3, H, D, generator=g, device="cuda").to(dtype)[:, :, 0]
    lengths = torch.randint(1, Sk + 1, (B,), generator=g, device="cuda")
    lengths[:masked_rows] = 0
    keep = torch.arange(Sk, device="cuda")[None, :] < lengths[:, None]
    bias = additive_mask(keep)[:, 0, 0, :]
    return q, qkv[:, :, 1], qkv[:, :, 2], bias


def check_flash(card: str):
    """Phase 3. Returns (max |O - O_plain| over all cases, per-shape
    results at the served bf16 shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video"))
        cases.append(("audio_base", 8, 299, 299, 12, 64, dtype, 1, True))
        cases += [(name, 8, s, s, 12, 64, dtype, int(bias), bias)
                  for name, s, bias in SLICE_ATTENTION]
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True))
    max_err = 0.0
    for i, (name, B, Sq, Sk, H, D, dtype, masked, has_bias) in enumerate(
            cases):
        q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, i)
        bias = bias if has_bias else None
        o, lse = flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
        tol = TOL[dtype]
        d = (o.float() - o_ref.float()).abs()
        err = d.max().item()
        excess = (d - tol["rtol"] * o_ref.float().abs()).max().item()
        lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)
                   ).max().item()
        finite = bool(torch.isfinite(o.float()).all())
        print(f"flash_fwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
              f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
              f"max|dO|={err:.3e}, max(|dO| - rtol|O|)={excess:.3e} "
              f"(atol {tol['atol']}, rtol {tol['rtol']}); "
              f"max rel dLSE={lse_err:.3e} (tol {tol['lse']})", flush=True)
        if not (finite and excess <= tol["atol"] and lse_err <= tol["lse"]):
            raise SystemExit(f"flash_fwd disagrees with its plain version "
                             f"on case {name} {dtype}")
        max_err = max(max_err, err)

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 100 + i)
        bias = None if name == "video" else bias
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, bias))
        plain = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, bias),
                        iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        (flops, nbytes, bound, by), _ = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_chunk": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_fwd_shape": row}), flush=True)
        shapes.append(row)
    return max_err, shapes


def grads_close(got, want, dtype):
    """(ok, largest error as a share of its tolerance, largest |error|)."""
    floor = 0.05 * max(b.float().abs().max().item() for b in want)
    worst, worst_abs, finite = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        finite = finite and bool(torch.isfinite(a).all())
        err = (a - b).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst = max(worst, err / (BWD_TOL[dtype]
                                  * max(b.abs().max().item(), floor)))
    return finite and worst <= 1.0, worst, worst_abs


def check_flash_bwd(card: str):
    """Phase 3, K2. Returns (max |error| over all cases, per-shape results
    at the bf16 model shapes)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, H, _ in SERVED:
            masked = 0 if name == "video" else 1
            cases.append((name, B, S, S, H, 64, dtype, masked,
                          name != "video", False))
        cases.append(("audio_base", 8, 299, 299, 12, 64, dtype, 1, True,
                      False))
        cases += [(name, 8, s, s, 12, 64, dtype, int(bias), bias, False)
                  for name, s, bias in SLICE_ATTENTION]
        cases.append(("ragged_d128", 3, 100, 333, 4, 128, dtype, 1, True,
                      False))
        cases.append(("sentinel", 3, 130, 130, 4, 64, dtype, 1, True, True))
    max_err = 0.0
    for i, (name, B, Sq, Sk, H, D, dtype, masked, has_bias,
            sentinel) in enumerate(cases):
        q, k, v, bias = attention_inputs(B, Sq, Sk, H, D, dtype, masked, i)
        bias = bias if has_bias else None
        if sentinel:
            bias = bias.clone()
            bias[-1] = float("-inf")       # every score -inf in this row
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        out, lse = flash_attention_fwd(q, k, v, bias)
        got = flash_attention_bwd(q, k, v, bias, out, lse, do)
        again = flash_attention_bwd(q, k, v, bias, out, lse, do)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, bias, out, lse, do)
        ok, share, err = grads_close(got, want, dtype)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # a row masked by bias keeps the uniform P (dV not zero); a
        # sentinel row gets no gradient at all
        masked_dv = got[2][0].float().abs().max().item() if masked else None
        dead = (all(bool((x[-1] == 0).all()) for x in got) if sentinel
                else None)
        print(f"flash_bwd {name:12s} {str(dtype)[6:]:8s} B={B} Sq={Sq} "
              f"Sk={Sk} H={H} D={D} bias={has_bias} masked_rows={masked}: "
              f"max|dgrad|={err:.3e} = {share:.3f} of tolerance "
              f"({BWD_TOL[dtype]} of max|grad|); two runs equal {same}; "
              f"max|dV| of the masked row {masked_dv}; sentinel row zero "
              f"{dead}", flush=True)
        if not (ok and same and (masked_dv is None or sentinel
                                 or masked_dv > 0)
                and dead is not False):
            raise SystemExit(f"flash_bwd disagrees with its plain version "
                             f"on case {name} {dtype}")
        max_err = max(max_err, err)

    shapes = []
    for i, (name, B, S, H, n) in enumerate(SERVED):
        q, k, v, bias = attention_inputs(B, S, S, H, 64, torch.bfloat16,
                                         0, 200 + i)
        bias = None if name == "video" else bias
        do = torch.randn(B, S, H, 64, device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, bias)
        ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, bias, out, lse, do))
        plain = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, bias, out, lse, do), iters=3, warmup=1)
        mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        do_t = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do_t,
                                                  retain_graph=True))
        _, (flops, nbytes, bound, by) = flash_bounds(B, S, S, H, 64, 2,
                                                     bias is not None)
        row = {"shape": name, "B": B, "S": S, "H": H, "D": 64,
               "dtype": "bf16", "launches_per_step": n, "ms": ms,
               "tflops": flops / ms / 1e9, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_by": by, "card": card}
        print(json.dumps({"flash_bwd_shape": row}), flush=True)
        shapes.append(row)
        del o_lib, leaves
    return max_err, shapes


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in fp32 units in the last place."""
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max().item())


def adam_leaf(shape, seed, gdtype=torch.float32, offset=0):
    """A leaf's gradient and moments on the card; with ``offset`` each is a
    view that many elements into its storage (1: not 16-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))

    def at(x, dtype):
        buf = torch.empty(n + offset, dtype=dtype, device="cuda")
        buf[offset:] = x
        return buf[offset:].view(shape)

    return (at(torch.randn(n, generator=g, device="cuda") * 1e-3, gdtype),
            at(torch.randn(n, generator=g, device="cuda") * 1e-3,
               torch.bfloat16),
            at(torch.rand(n, generator=g, device="cuda") * 1e-6,
               torch.bfloat16))


def adam_same_bits(got, want) -> Tuple[bool, int]:
    """(every moment bit-equal, largest ulp distance of out) of two
    (outs, mu's, nu's) lists."""
    exact = all(torch.equal(a, b) for xs, ys in zip(got[1:], want[1:])
                for a, b in zip(xs, ys))
    return exact, max(ulps(a, b) for a, b in zip(got[0], want[0]))


def check_adam(spec: TAVSpec, card: str):
    """Phase 3, K3. Returns (max |out - out_plain|, times and bound of one
    call over the step's trainable leaves and over its 235 big ones)."""
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    max_err = 0.0
    # embedding, an MLP weight (port layout), an audio MLP weight, a conv
    for i, shape in enumerate(((50265, 768), (3072, 768), (1024, 4096),
                               (512, 512, 3))):
        grad, mu, nu = adam_leaf(shape, 300 + i)
        out, mu2, nu2 = adam_update_leaf(grad, mu, nu, bc1, bc2, 7,
                                         zero_noise=True, **kw)
        torch.cuda.synchronize()
        o_ref, mu_ref, nu_ref = adam_update_leaf_plain(
            grad, mu, nu, bc1, bc2, zero_noise=True, **kw)
        exact = torch.equal(mu2, mu_ref) and torch.equal(nu2, nu_ref)
        d_ulp = ulps(out, o_ref)
        err = (out - o_ref).abs().max().item()
        max_err = max(max_err, err)

        # with noise: each moment is one of its fp32 value's two bf16
        # neighbours, the mean error is within 5 standard errors (the
        # truncated value's is far outside), and the dither differs
        # between leaves (seed) and between steps (seed)
        m32 = 0.9 * mu.float() + (1.0 - 0.9) * grad
        bits = m32.view(torch.int32) & -65536
        lo, hi = bits.view(torch.float32), (bits + 65536).view(torch.float32)
        noisy = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)
        a = noisy[1].float()
        b = adam_update_leaf(grad, mu, nu, bc1, bc2, 11, **kw)[1].float()
        c = adam_update_leaf(grad, mu, nu, bc1, bc2, 12, **kw)[1].float()
        bracket = bool(((a == lo) | (a == hi)).all())
        e = (a - m32).double()
        n = e.numel()
        se = e.std().item() / n ** 0.5
        mean_err, trunc = e.mean().item(), (lo.abs() - m32.abs()).double(
            ).mean().item()
        seeded = torch.equal(a, b) and not torch.equal(a, c)
        # noise on, the same Philox words: the plain version's bits
        same, n_ulp = adam_same_bits(
            [[x] for x in noisy],
            adam_update_leaves_plain([grad], [mu], [nu], bc1, bc2, [11],
                                     **kw))
        print(f"adam_update {str(shape):14s}: zero_noise moments equal "
              f"{exact}, out within {d_ulp} ulp (tol {ADAM_OUT_ULPS}); "
              f"noise: neighbours {bracket}, mean error {mean_err:.3e} = "
              f"{abs(mean_err) / se:.2f} standard errors (tol 5; "
              f"truncation {trunc / se:.1f}), same seed same bits and "
              f"other seed other bits {seeded}; same words as the plain "
              f"version: moments equal {same}, out within {n_ulp} ulp",
              flush=True)
        if not (exact and d_ulp <= ADAM_OUT_ULPS and bracket and seeded
                and abs(mean_err) <= 5 * se and trunc < -20 * se
                and same and n_ulp <= ADAM_OUT_ULPS):
            raise SystemExit(f"adam_update check failed on leaf {shape}")
        del grad, mu, nu, noisy, a, b, c, e, m32

    # one launch over a mixed list, fresh and in place, noise on
    specs = [((1,), torch.float32, 0), ((7,), torch.bfloat16, 0),
             ((768,), torch.float32, 0), ((70001,), torch.bfloat16, 0),
             ((3072, 768), torch.float32, 0), ((4099,), torch.float32, 1),
             ((50265, 768), torch.bfloat16, 0)]
    leaves = [adam_leaf(shape, 400 + k, dt, off)
              for k, (shape, dt, off) in enumerate(specs)]
    gs, mus, nus = (list(x) for x in zip(*leaves))
    seeds = [(5 << 20) + k for k in range(len(specs))]
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    fresh = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    torch.cuda.synchronize()
    counted = (kernels.LAUNCHES["adam_update"] - before[0],
               adam_update.LEAVES_FUSED - before[1])
    want = adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds, **kw)
    same, n_ulp = adam_same_bits(fresh, want)
    max_err = max(max_err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(fresh[0], want[0])))
    inplace = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, outs=gs,
                                 mu_outs=mus, nu_outs=nus, **kw)
    torch.cuda.synchronize()
    aliased = all(torch.equal(a, b) for xs, ys in zip(inplace, fresh)
                  for a, b in zip(xs, ys)) and all(
        x is y for xs, ys in zip(inplace, (gs, mus, nus))
        for x, y in zip(xs, ys))
    print(json.dumps({"adam_update_mixed": {
        "leaves": [[list(sh), str(dt), off] for sh, dt, off in specs],
        "launches": counted[0], "leaves_covered": counted[1],
        "moments_equal_plain": same, "out_ulps": n_ulp,
        "in_place_equals_fresh": aliased, "card": card}}), flush=True)
    if not (counted == (1, len(specs)) and same and n_ulp <= ADAM_OUT_ULPS
            and aliased):
        raise SystemExit("adam_update check failed on the mixed list")
    del leaves, gs, mus, nus, fresh, want, inplace
    torch.cuda.empty_cache()

    # one call over the step's trainable leaves (and its 235 big ones):
    # wrapper, kernel alone, host
    timed = time_adam.with_bounds(time_adam.time_tree())
    # the step's launch (past 32 leaves warp 0 searches in rounds) against
    # the plain version on the same inputs and words, which is timed too
    sizes = time_adam.step_leaf_sizes(spec)
    gs, mus, nus = time_adam.leaf_state(sizes, 1)
    seeds = [(9 << 20) + k for k in range(len(sizes))]
    got = adam_update_leaves(gs, mus, nus, bc1, bc2, seeds, **kw)
    want = []

    def plain():
        want[:] = [adam_update_leaves_plain(gs, mus, nus, bc1, bc2, seeds,
                                            **kw)]

    timed["all"]["plain_ms"] = cuda_ms(plain, iters=1, warmup=1)
    same, n_ulp = adam_same_bits(got, want[0])
    max_err = max(max_err, max((a - b).abs().max().item()
                               for a, b in zip(got[0], want[0][0])))
    timed["all"].update(moments_equal_plain=same, out_ulps=n_ulp)
    del gs, mus, nus, got, want
    torch.cuda.empty_cache()
    print(json.dumps({"adam_update_step": timed, "card": card}), flush=True)
    if not (same and n_ulp <= ADAM_OUT_ULPS):
        raise SystemExit("adam_update check failed over the step's "
                         f"{len(sizes)} leaves")
    return max_err, timed


@contextlib.contextmanager
def knobs_on():
    """MME_FUSED_LN=1 and MME_FUSED_MLP=1 for the enclosed calls."""
    os.environ.update(KNOBS)
    try:
        yield
    finally:
        for k in KNOBS:
            del os.environ[k]


def mlp_shapes(spec: TAVSpec, batch: int, text_len: int = 70,
               samples: int = 96000):
    """(name, rows, hidden, intermediate, layers) of the four towers' MLPs."""
    frames = samples
    for k, st in zip(spec.audio.conv_kernels, spec.audio.conv_strides):
        frames = (frames - k) // st + 1
    towers = (("text", spec.text.encoder, batch * text_len),
              ("audio", spec.audio.encoder, batch * frames),
              ("video", spec.video.encoder,
               batch * (spec.video.num_patches - spec.video_keep_k)),
              ("fusion", spec.fusion,
               batch * (text_len + frames + spec.video_keep_k)))
    return [(name, n, e.hidden, e.intermediate, e.layers)
            for name, e, n in towers]


def ln_case(n, h, xdtype, ydtype, seed, offset=0):
    """With ``offset`` rows, x is a row-offset view: its base pointer is not
    the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n + offset, h, generator=g, device="cuda") * 2
         + 0.5).to(xdtype)[offset:]
    w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
    b = 0.2 * torch.randn(h, generator=g, device="cuda")
    gy = torch.randn(n, h, generator=g, device="cuda").to(ydtype)
    return x, w, b, gy


def check_layer_norm(spec: TAVSpec, card: str):
    """Phase 3, K4a and K4b. Returns the forward's and the backward's entry
    for the kernels line, times and bounds summed over the launches of one
    training step of the bf16 bench configuration."""
    eps = 1e-5
    shapes = [(2392, 1024), (11712, 768), (3784, 768), (153592, 512),
              (2392, 768), (2392, 512),                      # wav2vec2-base
              (3992, 768), (3992, 512),           # at 160 000 samples
              (12544, 768),                                  # VideoMAE
              (3001, 768),                                   # one ragged N
              (1024, 8192)]                                  # the widest row
    cases = [(n, h, dt, dt, 0) for dt in (torch.bfloat16, torch.float32)
             for n, h in shapes]
    cases.append((2392, 1024, torch.float32, torch.bfloat16, 0))  # fp32 → bf16
    cases.append((2392, 1024, torch.bfloat16, torch.bfloat16, 8))  # row view
    err_fwd = err_bwd = 0.0
    for i, (n, h, xdt, ydt, offset) in enumerate(cases):
        x, w, b, gy = ln_case(n, h, xdt, ydt, 400 + i, offset)
        y = fused_layer_norm_fwd(x, w, b, eps, ydt)
        got = fused_layer_norm_bwd(gy, x, w, eps)
        again = fused_layer_norm_bwd(gy, x, w, eps)
        torch.cuda.synchronize()
        y0 = fused_layer_norm_fwd_plain(x, w, b, eps, ydt)
        want = fused_layer_norm_bwd_plain(gy, x, w, eps)

        def excess(a, ref, dt):
            atol, rtol = LN_TOL[dt]
            d = (a.float() - ref.float()).abs()
            return d.max().item(), (d - rtol * ref.float().abs()
                                    ).max().item() - atol

        e_y, x_y = excess(y, y0, ydt)
        e_dx, x_dx = excess(got[0], want[0], xdt)
        sums = max(((a - r).abs().max() / r.abs().max().clamp(min=1e-12)
                    ).item() for a, r in zip(got[1:], want[1:]))
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (y,) + tuple(got))
        print(f"layer_norm N={n} H={h} x {str(xdt)[6:]} y {str(ydt)[6:]}"
              f"{' (row-offset view)' if offset else ''}: "
              f"max|dy|={e_y:.3e}, max|d(dx)|={e_dx:.3e} (atol, rtol "
              f"{LN_TOL[ydt]}, {LN_TOL[xdt]}); dscale, dbias within "
              f"{sums:.3e} of their largest element (tol {LN_SUM_RTOL}); "
              f"two runs equal {same}", flush=True)
        if not (finite and same and x_y <= 0 and x_dx <= 0
                and sums <= LN_SUM_RTOL and y.dtype == ydt
                and got[0].dtype == xdt):
            raise SystemExit(f"fused layer norm disagrees with its plain "
                             f"version at N={n} H={h} {xdt}")
        err_fwd, err_bwd = max(err_fwd, e_y), max(err_bwd, e_dx)

    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "nbytes": 0}
    rows = []
    dt = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (n, h), count in sorted(fused_ln_shapes(spec, 8).items()):
        x, w, b, gy = ln_case(n, h, dt, dt, n % 1000)
        # the library's weight and bias in the input's type, cast once
        lx, lw, lb = (t.detach().to(dt).requires_grad_() for t in (x, w, b))
        ly = F.layer_norm(lx, (h,), lw, lb, eps)
        t = {"fwd": cuda_ms(lambda: fused_layer_norm_fwd(x, w, b, eps, dt)),
             "fwd_plain": cuda_ms(lambda: fused_layer_norm_fwd_plain(
                 x, w, b, eps, dt), iters=5, warmup=1),
             "fwd_library": cuda_ms(lambda: F.layer_norm(
                 x, (h,), lw, lb, eps)),
             "bwd": cuda_ms(lambda: fused_layer_norm_bwd(gy, x, w, eps)),
             "bwd_plain": cuda_ms(lambda: fused_layer_norm_bwd_plain(
                 gy, x, w, eps), iters=5, warmup=1),
             "bwd_library": cuda_ms(lambda: torch.autograd.grad(
                 ly, (lx, lw, lb), gy, retain_graph=True))}
        # x in, y out, scale and bias; g and x in, dx out, scale in and the
        # two [H] sums out: the same work whatever implements it
        (_, fwd_bytes, fwd_bound, _), (_, bwd_bytes, bwd_bound, _) = \
            ln_bounds(n, h, 2)
        geom = launch_geometry(n, h, sms)
        rows.append({"N": n, "H": h, "dtype": "bf16",
                     "launches_per_step": count, **t,
                     "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
                     "grid": geom.grid, "rows_per_team": geom.rows_per_team,
                     "smem_fwd": smem_bytes(geom, h, 2),
                     "smem_bwd": smem_bytes(geom, h, 2, 2)})
        for tot, key, nb in ((fwd, "fwd", fwd_bytes), (bwd, "bwd", bwd_bytes)):
            tot["ms"] += t[key] * count
            tot["plain_ms"] += t[key + "_plain"] * count
            tot["library_ms"] += t[key + "_library"] * count
            tot["nbytes"] += nb * count
        del ly, lx
    print(json.dumps({"layer_norm_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in ((fwd, err_fwd), (bwd, err_bwd)):
        nbytes = tot.pop("nbytes")
        out.append({**tot, "max_abs_err": err, "bound_by": "bytes",
                    "bound_ms": nbytes / PEAK_BYTES * 1e3})
    return out


def mlp_case(n, h, f, dtype, seed):
    """x is a row-offset view, so its base pointer is not the allocation's."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = r(n + 8, h).to(dtype)[8:]
    w1 = (r(f, h) * h ** -0.5).to(dtype)
    w2 = (r(h, f) * f ** -0.5).to(dtype)
    return x, w1, r(f) * 0.1, w2, r(h) * 0.1, r(n, h).to(dtype)


def gemm_operand(rows, cols, mn, g):
    """A [rows, cols] bf16 operand contracted along `cols`, stored with
    `rows` contiguous when `mn`, else `cols`, in storage padded past the
    extent (the row stride is not the extent)."""
    inner, outer = (rows, cols) if mn else (cols, rows)
    store = torch.randn(outer, (inner + 7) // 8 * 8 + 8, generator=g,
                        device="cuda").to(torch.bfloat16)
    return store[:, :inner].t() if mn else store[:, :inner]


def check_gemm_core(card: str):
    """Phase 3, the wgmma/TMA product core of K5a and K5b alone: C = A B
    against an fp32 product of the same bf16 operands at the four operand
    orders, every extent ragged against the 128 x 128 x 64 tiles (the last
    extents on more tiles than the card has SMs), and at the orders and
    extents of the video tower's five products."""
    cases = [(m, n, k, a_mn, b_mn)
             for m, n, k in ((5, 3, 7), (200, 136, 328), (300, 520, 1000),
                             (4000, 1100, 136))
             for a_mn in (0, 1) for b_mn in (0, 1)]
    cases += [(11712, 3072, 768, 0, 0), (11712, 768, 3072, 0, 0),
              (3072, 768, 11712, 1, 1), (11712, 768, 3072, 0, 1)]
    worst = 0.0
    for i, (m, n, k, a_mn, b_mn) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(700 + i)
        a = gemm_operand(m, k, a_mn, g)
        b = gemm_operand(n, k, b_mn, g).t()
        assert (gemm_operand_major(a, 1), gemm_operand_major(b, 0)) \
            == (a_mn, b_mn)
        c = gemm_bf16(a, b)
        torch.cuda.synchronize()
        ref = torch.matmul(a.float(), b.float())
        share = ((c.float() - ref).abs().max().item()
                 / (MLP_TOL[torch.bfloat16] * ref.abs().max().item()))
        worst = max(worst, share)
        print(f"gemm core M={m} N={n} K={k} A {'MN' if a_mn else 'K'}-major"
              f" B {'MN' if b_mn else 'K'}-major: error {share:.3f} of "
              "tolerance", flush=True)
        if not (share <= 1.0 and bool(torch.isfinite(c.float()).all())):
            raise SystemExit(f"gemm core disagrees at M={m} N={n} K={k} "
                             f"orders ({a_mn}, {b_mn})")
    print(json.dumps({"gemm_core_cases": len(cases),
                      "worst_share_of_tolerance": worst, "card": card}),
          flush=True)


def check_fused_mlp(spec: TAVSpec, card: str):
    """Phase 3, K5a and K5b. Returns the forward's and the backward's entry
    for the kernels line, summed over the 54 launches of one step."""
    towers = mlp_shapes(spec, 8)
    if not all(kernel_supports(h, f, torch.bfloat16)
               for _, _, h, f, _ in towers):
        raise SystemExit("a full-width MLP is outside the kernels' shape rule")
    cases = [(name, n, h, f, torch.bfloat16, "gelu")
             for name, n, h, f, _ in towers]
    cases.append(("wav2vec2_base", 2392, 768, 3072, torch.bfloat16, "gelu"))
    # phase 10's: wav2vec2-base at 160 000 samples, VideoMAE, VisualBERT
    cases += [(name, n, 768, 3072, dt, "gelu")
              for dt in (torch.bfloat16, torch.float32)
              for name, n in (("w2v_base_160k", 3992), ("videomae", 12544),
                              ("visualbert", 568))]
    cases += [("small", 300, 256, 512, dt, act)
              for dt in (torch.float32, torch.bfloat16) for act in ACTS]
    cases += [("ragged", n, h, f, torch.bfloat16, act)
              for n, h, f, act in ((1, 256, 64, "gelu"),
                                   (17, 512, 192, "gelu_new"),
                                   (129, 768, 320, "relu"),
                                   (129, 1024, 256, "tanh"))]
    cases.append(("fp32_wide", 300, 768, 3072, torch.float32, "gelu"))
    err_fwd = err_bwd = 0.0
    for i, (name, n, h, f, dt, act) in enumerate(cases):
        x, w1, b1, w2, b2, do = mlp_case(n, h, f, dt, 500 + i)
        out = fused_mlp_fwd(x, w1, b1, w2, b2, act)
        got = fused_mlp_bwd(x, w1, b1, w2, do, act)
        again = fused_mlp_bwd(x, w1, b1, w2, do, act)
        torch.cuda.synchronize()
        out0 = fused_mlp_fwd_plain(x, w1, b1, w2, b2, act)
        want = fused_mlp_bwd_plain(x, w1, b1, w2, do, act)
        shares, worst = {}, 0.0
        names = ("out", "dx", "dw1", "db1", "dw2", "db2")
        for key, a, ref in zip(names, (out,) + got, (out0,) + want):
            tol = (MLP_BIAS_TOL if key.startswith("db") else MLP_TOL)[dt]
            d = (a.float() - ref.float()).abs().max().item()
            shares[key] = d / (tol * ref.float().abs().max().item())
            if key == "out":
                err_fwd = max(err_fwd, d)
            else:
                err_bwd = max(err_bwd, d)
            worst = max(worst, shares[key])
        same = all(torch.equal(a, r) for a, r in zip(got, again))
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (out,) + got)
        print(f"fused_mlp {name:9s} {str(dt)[6:]:8s} {act:8s} N={n} H={h} "
              f"F={f}: error as a share of tolerance "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
              + f" (tol {MLP_TOL[dt]} of max, biases {MLP_BIAS_TOL[dt]}); "
              f"two runs equal {same}", flush=True)
        if not (finite and same and worst <= 1.0):
            raise SystemExit(f"fused mlp disagrees with its plain version "
                             f"on case {name} {dt} {act}")

    totals = [dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, nbytes=0)
              for _ in range(2)]
    rows = []
    for i, (name, n, h, f, layers) in enumerate(towers):
        x, w1, b1, w2, b2, do = mlp_case(n, h, f, torch.bfloat16, 600 + i)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, w1, b1.bfloat16(), w2, b2.bfloat16())]

        def unfused():
            lx, lw1, lb1, lw2, lb2 = leaves
            return F.linear(F.gelu(F.linear(lx, lw1, lb1)), lw2, lb2)

        lib_out = unfused()
        t = {"fwd": cuda_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2)),
             "fwd_plain": cuda_ms(lambda: fused_mlp_fwd_plain(
                 x, w1, b1, w2, b2), iters=3, warmup=1),
             "fwd_library": cuda_ms(unfused),
             "bwd": cuda_ms(lambda: fused_mlp_bwd(x, w1, b1, w2, do),
                            iters=10),
             "bwd_plain": cuda_ms(lambda: fused_mlp_bwd_plain(
                 x, w1, b1, w2, do), iters=3, warmup=1),
             "bwd_library": cuda_ms(lambda: torch.autograd.grad(
                 lib_out, leaves, do, retain_graph=True))}
        bounds = mlp_bounds(n, h, f, 2)
        rows.append({"shape": name, "N": n, "H": h, "F": f, "dtype": "bf16",
                     "launches_per_step": layers, **t,
                     "fwd_bound_ms": bounds[0][2], "fwd_bound_by": bounds[0][3],
                     "bwd_bound_ms": bounds[1][2], "bwd_bound_by": bounds[1][3],
                     "fwd_tflops": bounds[0][0] / t["fwd"] / 1e9,
                     "bwd_tflops": bounds[1][0] / t["bwd"] / 1e9})
        for tot, key, (flops, nbytes, _, _) in zip(totals, ("fwd", "bwd"),
                                                   bounds):
            tot["ms"] += t[key] * layers
            tot["plain_ms"] += t[key + "_plain"] * layers
            tot["library_ms"] += t[key + "_library"] * layers
            tot["flops"] += flops * layers
            tot["nbytes"] += nbytes * layers
        del lib_out, leaves
    print(json.dumps({"fused_mlp_shapes": rows, "card": card}), flush=True)
    out = []
    for tot, err in zip(totals, (err_fwd, err_bwd)):
        flops, nbytes = tot.pop("flops"), tot.pop("nbytes")
        by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out.append({**tot, "max_abs_err": err,
                    "bound_ms": max(by_ops, by_bytes) * 1e3,
                    "bound_by": "operations" if by_ops >= by_bytes
                    else "bytes"})
    return out



def requests(spec: TAVSpec):
    """Ragged requests of 8, 5 and 11 utterances with uint8 video; some
    rows carry shorter text and audio."""
    out = []
    for i, n in enumerate((8, 5, 11)):
        r = example_tav_batch(spec, n, 70, 96000, seed=SEED + 1 + i)
        r["video"] = np.clip(r["video"] * 64 + 128, 0, 255).astype(np.uint8)
        r["text_mask"][1::3, 40:] = 0
        r["audio_mask"][1::2, 60000:] = 0
        out.append(r)
    return out


def serve(pred: Predictor, reqs):
    probs = [pred(r)[1] for r in reqs]
    torch.cuda.synchronize()
    return probs


def main_path(card: str):
    """Phase 4. Returns the flash launches of the bf16 (served) run and the
    launches of the bf16 run with both knobs on."""
    spec = TAVSpec(output_dim=7)
    ln_per_chunk = sum(fused_ln_shapes(spec, 8).values())
    t0 = time.perf_counter()
    state = from_flax(init_params(spec, SEED))
    n_params = sum(v.numel() for v in state.values())
    print(f"weights: {n_params / 1e6:.1f} M parameters drawn and converted "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    reqs = requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served_launches = served_fused = None
    for dtype in (torch.float32, torch.bfloat16):
        leg = "fp32" if dtype == torch.float32 else "bf16"
        model = TAVModel(spec.with_compute_dtype(dtype), device="cuda")
        model.load_state_dict(state, strict=True)
        pred = Predictor(model, batch_size=8, device="cuda")
        serve(pred, reqs[:1])                       # warm-up: cuDNN, build
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        got = serve(pred, reqs)
        launches = kernels.LAUNCHES["flash_fwd"]
        os.environ["MME_FLASH"] = "0"
        try:
            ref = serve(pred, reqs)
            plain_launches = kernels.LAUNCHES["flash_fwd"] - launches
        finally:
            del os.environ["MME_FLASH"]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
        sums = max(float(np.abs(p.sum(-1) - 1).max()) for p in got)
        shapes_ok = all(p.shape == (len(r["input_ids"]), 7)
                        for p, r in zip(got, reqs))
        finite = all(np.isfinite(p).all() for p in got + ref)
        print(f"serve {leg}: {chunks} chunks, flash launches {launches} "
              f"(expected {LAUNCHES_PER_CHUNK * chunks}), with MME_FLASH=0 "
              f"{plain_launches}; max|probs - probs(MME_FLASH=0)| = "
              f"{diff:.3e} (tol {SERVE_TOL[dtype]}); max|sum-1| = "
              f"{sums:.2e}; finite {finite}", flush=True)
        if not (finite and shapes_ok and sums < 1e-5
                and launches == LAUNCHES_PER_CHUNK * chunks
                and plain_launches == 0 and diff <= SERVE_TOL[dtype]):
            raise SystemExit(f"serving check failed in the {leg} leg")

        # the same requests with MME_FUSED_LN=1 and MME_FUSED_MLP=1
        with knobs_on():
            serve(pred, reqs[:1])                   # warm-up
            kernels.reset_launches()
            fused = serve(pred, reqs)
            count = dict(kernels.LAUNCHES)
        diff_f = max(float(np.abs(a - b).max()) for a, b in zip(fused, got))
        finite_f = all(np.isfinite(p).all() for p in fused)
        print(f"serve {leg}, both knobs on: launches {count} (expected "
              f"{LAUNCHES_PER_CHUNK * chunks} flash_fwd and fused_mlp_fwd, "
              f"{ln_per_chunk * chunks} layer_norm_fwd, no backward); "
              f"max|probs - probs(knobs off)| = {diff_f:.3e} (tol "
              f"{SERVE_TOL[dtype]}); finite {finite_f}", flush=True)
        if not (finite_f and diff_f <= SERVE_TOL[dtype]
                and count["flash_fwd"] == count["fused_mlp_fwd"]
                == LAUNCHES_PER_CHUNK * chunks
                and count["layer_norm_fwd"] == ln_per_chunk * chunks
                and count["flash_bwd"] == count["fused_mlp_bwd"]
                == count["layer_norm_bwd"] == 0):
            raise SystemExit(f"serving with both knobs on failed in the "
                             f"{leg} leg")
        if dtype == torch.bfloat16:
            served_launches = launches
            served_fused = {k: v // chunks for k, v in count.items()}
            one = reqs[0]
            times = []
            for _ in range(5):
                t = time.perf_counter()
                pred(one)
                times.append(time.perf_counter() - t)
            ms = float(np.median(times)) * 1e3
            with knobs_on():
                times_f = []
                for _ in range(5):
                    t = time.perf_counter()
                    pred(one)
                    times_f.append(time.perf_counter() - t)
            print(json.dumps({"serve_bf16": {
                "ms_per_batch_of_8": ms, "utt_per_s": 8e3 / ms,
                "times_ms": [x * 1e3 for x in times],
                "ms_per_batch_of_8_knobs_on":
                    float(np.median(times_f)) * 1e3,
                "times_ms_knobs_on": [x * 1e3 for x in times_f],
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "card": card}}), flush=True)
        del pred, model
        torch.cuda.empty_cache()
    return served_launches, served_fused


def train_inputs(spec: TAVSpec, batch_size: int, seed: int):
    batch = example_tav_batch(spec, batch_size, 70, 96000, seed=seed)
    batch["text_mask"][1::3, 40:] = 0
    batch["audio_mask"][1::2, 60000:] = 0
    labels = np.arange(batch_size) % 7
    return (batch, labels, np.ones(batch_size, np.int32),
            np.ones(7, np.float32))


def without_noise(spec: TAVSpec) -> TAVSpec:
    """Every dropout rate and SpecAugment probability 0."""
    def quiet(e):
        return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        spec, dropout=0.0,
        text=dataclasses.replace(spec.text, encoder=quiet(spec.text.encoder)),
        audio=dataclasses.replace(spec.audio, mask_time_prob=0.0,
                                  mask_feature_prob=0.0,
                                  encoder=quiet(spec.audio.encoder)),
        video=dataclasses.replace(spec.video,
                                  encoder=quiet(spec.video.encoder)),
        fusion=quiet(spec.fusion))


def tower_norms(model, grads):
    """Global gradient norm per top-level tower."""
    groups = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        parts = name.split(".")
        key = parts[0] if parts[0] != "model" else parts[1]
        groups.setdefault(key, []).append(g)
    return {k: global_norm_f32(v).item() for k, v in groups.items()}


def train_check_fp32(params, card: str):
    """Phase 5 (1): loss and gradients of one batch, kernels against
    MME_FLASH=0, fp32 compute, no dropout, full depth, batch 4."""
    spec = dataclasses.replace(without_noise(TAVSpec(output_dim=7)),
                               share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=4, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    model, state, _, _ = build_tav(spec, cfg, 1000, params=params,
                                   remat=False, use_accum=False,
                                   device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 4, SEED + 20)
    batch = to_device(batch, "cuda")
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    model.train()

    def loss_and_grads():
        kernels.reset_launches()
        loss = cross_entropy(model(batch), labels, cw, mask)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, state.params)]
        torch.cuda.synchronize()
        return (loss.item(), global_norm_f32(grads).item(),
                tower_norms(model, grads), dict(kernels.LAUNCHES))

    loss, norm, towers, count = loss_and_grads()
    os.environ["MME_FLASH"] = "0"
    try:
        loss0, norm0, towers0, count0 = loss_and_grads()
    finally:
        del os.environ["MME_FLASH"]
    with knobs_on():
        loss_f, norm_f, towers_f, count_f = loss_and_grads()
    rel = {k: abs(towers[k] - towers0[k]) / max(towers0[k], 1e-12)
           for k in towers0}
    rel_f = {k: abs(towers_f[k] - towers[k]) / max(towers[k], 1e-12)
             for k in towers}
    n_ln = sum(fused_ln_shapes(spec, 4).values())
    print(json.dumps({"train_check_fp32": {
        "batch": 4, "loss": loss, "loss_plain": loss0, "grad_norm": norm,
        "grad_norm_plain": norm0, "tower_norms": towers,
        "tower_norm_rel_diff": rel, "launches": count,
        "launches_plain": count0, "loss_knobs_on": loss_f,
        "grad_norm_knobs_on": norm_f,
        "tower_norm_rel_diff_knobs_on_vs_off": rel_f,
        "launches_knobs_on": count_f, "expected_layer_norm_launches": n_ln,
        "card": card}}), flush=True)
    ok_f = (np.isfinite(loss_f) and abs(loss_f - loss) <= TRAIN_LOSS_RTOL
            * abs(loss) and abs(norm_f - norm) <= TRAIN_NORM_RTOL * norm
            and max(rel_f.values()) <= TRAIN_NORM_RTOL
            and count_f["flash_fwd"] == count_f["flash_bwd"]
            == count_f["fused_mlp_fwd"] == count_f["fused_mlp_bwd"]
            == LAUNCHES_PER_CHUNK
            and count_f["layer_norm_fwd"] == count_f["layer_norm_bwd"] == n_ln
            and count["fused_mlp_fwd"] == count["layer_norm_fwd"] == 0)
    if not ok_f:
        raise SystemExit("training check with both knobs on against both "
                         "off failed")
    ok = (np.isfinite(loss) and abs(loss - loss0) <= TRAIN_LOSS_RTOL
          * abs(loss0) and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0
          and max(rel.values()) <= TRAIN_NORM_RTOL
          and count["flash_fwd"] == count["flash_bwd"] == LAUNCHES_PER_CHUNK
          and count0["flash_fwd"] == count0["flash_bwd"] == 0)
    if not ok:
        raise SystemExit("training check against MME_FLASH=0 failed")


def train_descends_bf16(params, card: str):
    """Phase 5 (2): a few steps on one fixed batch with dropout off. The
    model is deterministic, so the eval loss after the last update is the
    next point of the same series; it must lie below the first loss."""
    spec = dataclasses.replace(
        without_noise(TAVSpec(output_dim=7)).with_compute_dtype(
            torch.bfloat16), share_audio_frontend=True)
    lr = 5e-6
    cfg = ExperimentConfig(batch_size=8, learning_rate=lr, text_max_len=70,
                           audio_max_samples=96000)
    model, state, train_step, eval_step = build_tav(
        spec, cfg, 1000, params=params, remat=False, use_accum=False,
        device="cuda")
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 30)
    losses = []
    for _ in range(4):
        state, loss, cm, _ = train_step(state, batch, labels, mask, cw, 1.0,
                                        True, SEED)
        losses.append(loss.item())
    ev_loss, ev_cm, preds = eval_step(batch, labels, mask, cw)
    losses.append(ev_loss.item())
    print(json.dumps({"train_descends_bf16": {
        "lr": lr, "losses": losses, "cm_sum": int(cm.sum()),
        "card": card}}), flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and int(cm.sum()) == 8 and int(ev_cm.sum()) == 8
            and preds.shape == (8,)):
        raise SystemExit("the deterministic bf16 training leg did not "
                         "lower its loss")


def train_bench(params, card: str):
    """Phase 5 (3), (4) and (5): the benchmark configuration, the same
    state with MME_FUSED_ADAM=1, and the same state with MME_FUSED_LN=1 and
    MME_FUSED_MLP=1. Returns the launches of one timed step of each leg."""
    spec = dataclasses.replace(
        TAVSpec(output_dim=7).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    cfg = ExperimentConfig(batch_size=8, learning_rate=5e-6, text_max_len=70,
                           audio_max_samples=96000)
    os.environ["MME_OPT_STATE"] = "bf16"
    try:
        model, state, train_step, _ = build_tav(
            spec, cfg, 1000, params=params, remat=False, use_accum=False,
            device="cuda")
    finally:
        del os.environ["MME_OPT_STATE"]
    batch, labels, mask, cw = train_inputs(spec, 8, SEED + 40)
    batch = to_device(batch, "cuda")
    before = [p.detach().clone() for p in state.params[:8]]
    n_trainable = sum(m is not None for m in state.opt_state.mu)
    n_ln = sum(fused_ln_shapes(spec, 8).values())
    fused_names = ("fused_mlp_fwd", "fused_mlp_bwd", "layer_norm_fwd",
                   "layer_norm_bwd")

    def run(steps):
        out, times, counts = [], [], []
        for _ in range(steps):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss, cm, gnorm = train_step(state, batch, labels, mask, cw,
                                            1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            out.append((loss.item(), gnorm.item()))
            counts.append(dict(kernels.LAUNCHES))
        return out, times, counts

    # forward / backward / optimizer split of the same step, by hand with
    # the step's own pieces and CUDA events
    tx = make_optimizer(cosine_warm_restarts(5e-6, cfg.T_max, 1000),
                        cfg.weight_decay, cfg.clip, None, "bf16")
    labels_t, mask_t, cw_t = (torch.as_tensor(x, device="cuda")
                              for x in (labels, mask, cw))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def split_ms():
        split = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            model.train()
            ev[0].record()
            loss = cross_entropy(model(batch, rng=gen), labels_t, cw_t,
                                 mask_t)
            ev[1].record()
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, state.params)]
            ev[2].record()
            tx.update(state.params, grads, state.opt_state, gen)
            ev[3].record()
            torch.cuda.synchronize()
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        return [float(x) for x in np.median(np.array(split), axis=0)]

    def device_kernels():
        """Device kernels (and copies) per step, from a profiler window of
        two steps after a one-step window that warms the profiler."""
        for steps in (1, 2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                run(steps)
        return sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) // 2

    run(2)                                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    res, times, counts = run(4)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_kernels = device_kernels()
    moved = max((a - b.detach()).abs().max().item()
                for a, b in zip(before, state.params[:8]))
    moments_bf16 = all(m.dtype == torch.bfloat16
                       for m in state.opt_state.mu + state.opt_state.nu)
    ms = float(np.median(times))
    ok = (all(np.isfinite(x) for r in res for x in r) and moved > 0
          and moments_bf16 and all(
              c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
              and c["adam_update"] == 0
              and all(c[k] == 0 for k in fused_names) for c in counts))
    print(json.dumps({"train_bf16": {
        "ms_per_step": ms, "utt_per_s": 8e3 / ms, "times_ms": times,
        "losses": [r[0] for r in res], "grad_norms": [r[1] for r in res],
        "max_memory_allocated_gb": peak, "launches_per_step": counts[-1],
        "device_kernels_per_step": n_kernels, "params_moved": moved,
        "moments_bf16": moments_bf16, "card": card}}), flush=True)
    if not ok:
        raise SystemExit("the bf16 training leg failed its checks")
    (fwd, bwd, opt) = split_ms()
    print(json.dumps({"train_bf16_split_ms": {
        "forward": fwd, "backward": bwd, "optimizer_unfused": opt,
        "card": card}}), flush=True)

    # (4) one K3 launch per step over every trainable leaf, the moments
    # updated in place from the first fused step on
    os.environ["MME_FUSED_ADAM"] = "1"
    try:
        run(1)
        moments = [m for m in state.opt_state.mu + state.opt_state.nu
                   if m is not None]
        ptrs = [m.data_ptr() for m in moments]
        torch.cuda.reset_peak_memory_stats()
        leaves0 = adam_update.LEAVES_FUSED
        res_f, times_f, counts_f = run(3)
        covered = (adam_update.LEAVES_FUSED - leaves0) / 3
        peak_f = torch.cuda.max_memory_allocated() / 1e9
        kept = [m.data_ptr() for m in state.opt_state.mu
                + state.opt_state.nu if m is not None] == ptrs and all(
            m.dtype == torch.bfloat16 for m in moments)
        n_kernels_f = device_kernels()
        (fwd_f, bwd_f, opt_fused) = split_ms()
    finally:
        del os.environ["MME_FUSED_ADAM"]
    del moments
    ms_f = float(np.median(times_f))
    print(json.dumps({"train_bf16_fused_adam": {
        "ms_per_step": ms_f, "ms_per_step_unfused": ms, "times_ms": times_f,
        "losses": [r[0] for r in res_f], "trainable_leaves": n_trainable,
        "leaves_covered_per_step": covered,
        "moments_bf16_in_place": kept,
        "launches_per_step": counts_f[-1],
        "device_kernels_per_step": n_kernels_f,
        "device_kernels_per_step_unfused": n_kernels,
        "max_memory_allocated_gb": peak_f,
        "max_memory_allocated_gb_unfused": peak,
        "split_ms": {"forward": fwd_f, "backward": bwd_f,
                     "optimizer_fused": opt_fused},
        "optimizer_unfused_ms": opt, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_f for x in r) and all(
            c["adam_update"] == 1
            and c["flash_fwd"] == c["flash_bwd"] == LAUNCHES_PER_CHUNK
            for c in counts_f) and covered == n_trainable and kept
            and abs(peak_f - peak) <= 0.2):
        raise SystemExit("the MME_FUSED_ADAM=1 training leg failed")

    # (5) the same state and batch with both knobs on
    torch.cuda.empty_cache()
    with knobs_on():
        run(2)                                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        res_k, times_k, counts_k = run(4)
        peak_k = torch.cuda.max_memory_allocated() / 1e9
        (fwd_k, bwd_k, opt_k) = split_ms()
    ms_k = float(np.median(times_k))
    print(json.dumps({"train_bf16_knobs_on": {
        "knobs": KNOBS, "ms_per_step": ms_k, "ms_per_step_knobs_off": ms,
        "utt_per_s": 8e3 / ms_k, "times_ms": times_k,
        "losses": [r[0] for r in res_k], "grad_norms": [r[1] for r in res_k],
        "max_memory_allocated_gb": peak_k,
        "max_memory_allocated_gb_knobs_off": peak,
        "split_ms": {"forward": fwd_k, "backward": bwd_k,
                     "optimizer_unfused": opt_k},
        "split_ms_knobs_off": {"forward": fwd, "backward": bwd,
                               "optimizer_unfused": opt},
        "launches_per_step": counts_k[-1],
        "expected_layer_norm_launches": n_ln, "card": card}}), flush=True)
    if not (all(np.isfinite(x) for r in res_k for x in r) and all(
            c["flash_fwd"] == c["flash_bwd"] == c["fused_mlp_fwd"]
            == c["fused_mlp_bwd"] == LAUNCHES_PER_CHUNK
            and c["layer_norm_fwd"] == c["layer_norm_bwd"] == n_ln
            and c["adam_update"] == 0 for c in counts_k)):
        raise SystemExit("the training leg with both knobs on failed")
    return counts[-1], counts_f[-1], counts_k[-1], ms_f


def train_path(card: str):
    """Phase 5. Returns the flax tree, the launches of one step of the bf16
    leg, of the fused-Adam leg and of the leg with both knobs on, and the
    fused-Adam leg's ms per step."""
    t0 = time.perf_counter()
    params = init_params(dataclasses.replace(TAVSpec(output_dim=7),
                                             share_audio_frontend=True), SEED)
    print(f"train weights drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for leg in (train_check_fp32, train_descends_bf16):
        t0 = time.perf_counter()
        leg(params, card)
        torch.cuda.empty_cache()
        print(f"{leg.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return (params, *train_bench(params, card))


# phase 6: the loop at full width. Train, validation and test utterances
# with their seeds; the train split's dialogs hold 16 utterances, so epoch 1
# (dialog accumulation) applies one update per two batches of 8
LOOP_SIZES = ((32, 0), (8, 1), (8, 2))
LOOP_DIALOG = 16
LOOP_CFG = dict(batch_size=8, epoch=2, log_val=2, patience=10,
                learning_rate=5e-6, mask=True, output_dim=7,
                dataset="synthetic", seed=SEED)
LOOP_ENV = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1"}
# 8 train steps, 6 applied updates (4 in epoch 0, 2 in epoch 1), 4
# validations of one batch and one test batch
LOOP_STEPS, LOOP_UPDATES, LOOP_EVAL_BATCHES = 8, 6, 5
# eval-only against the trained run's test pass: the same weights, masks
# and kernels (no atomics); the loss is a mean of fp32 values
EVAL_ONLY_RTOL = 1e-6


class TimedCheckpoints(CheckpointManager):
    """The loop's checkpoint manager with host times: the blocking part of
    each ``save_best`` and each ``restore_best`` (the ``wait()`` they start
    with counted apart) and each ``wait()``; whether every saved state was
    stripped of its accumulation buffer; the target of the last restore,
    which is the state the loop returns."""

    def __init__(self, directory: str):
        super().__init__(directory)
        self.ms = {"save_best": [], "wait": [], "restore_best": []}
        self.stripped = []
        self.returned = None

    def _timed(self, key, fn, *args):
        n = len(self.ms["wait"])
        t = time.perf_counter()
        out = fn(*args)
        self.ms[key].append((time.perf_counter() - t) * 1e3
                            - sum(self.ms["wait"][n:]))
        return out

    def wait(self):
        t = time.perf_counter()
        super().wait()
        self.ms["wait"].append((time.perf_counter() - t) * 1e3)

    def save_best(self, state, meta):
        self.stripped.append(state.accum_grads is None)
        self._timed("save_best", super().save_best, state, meta)

    def restore_best(self, target_state):
        self.returned = target_state
        return self._timed("restore_best", super().restore_best,
                           target_state)


def empty_state_like(state: TrainState) -> TrainState:
    """A state of the same structure in new, uninitialised tensors."""
    def like(xs):
        return None if xs is None else [
            None if x is None else torch.empty_like(x) for x in xs]
    o = state.opt_state
    return TrainState(
        step=-1, params=like(state.params), accum_grads=None,
        opt_state=AdamWState(count=-1, mu=like(o.mu), nu=like(o.nu),
                             seed=-1, nu_row=like(o.nu_row),
                             nu_col=like(o.nu_col)),
        names=state.names)


def state_diff(a: TrainState, b: TrainState) -> list:
    """What differs between two states, bit for bit: counters by name,
    tensor groups by how many tensors differ."""
    out = [k for k, x, y in (("step", a.step, b.step),
                             ("count", a.opt_state.count, b.opt_state.count),
                             ("seed", a.opt_state.seed, b.opt_state.seed))
           if x != y]
    groups = (("params", a.params, b.params),
              *((k, getattr(a.opt_state, k), getattr(b.opt_state, k))
                for k in ("mu", "nu", "nu_row", "nu_col")))
    for key, xs, ys in groups:
        if xs is None or ys is None:
            if xs is not ys:
                out.append(key)
            continue
        bad = sum((x is None) != (y is None) or (
            x is not None and not torch.equal(x, y)) for x, y in zip(xs, ys))
        if bad or len(xs) != len(ys):
            out.append(f"{key}: {bad} of {len(xs)}")
    return out


def loop_inputs(params, spec: TAVSpec, device: str, text_len: int,
                audio_len: int):
    """A model with ``params`` and the synthetic train, validation and test
    splits of phase 6."""
    (n_train, s_train), *evals = LOOP_SIZES
    train_ds = synthetic_tav_dataset(spec, n_train, text_len, audio_len,
                                     seed=s_train, dialog_size=LOOP_DIALOG)
    val_ds, test_ds = (synthetic_tav_dataset(spec, n, text_len, audio_len,
                                             seed=s) for n, s in evals)
    model = TAVModel(spec, device=device)
    model.load_state_dict(from_flax(params), strict=True)
    return model, train_ds, val_ds, test_ds


def busy_share(prof, wall_s: float) -> float:
    """The share of ``wall_s`` in which the device ran anything: the union
    of the device events' spans in a profiler window."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6 / wall_s


def profiled_epoch(params, spec: TAVSpec) -> dict:
    """One epoch of ``run_classifier`` as phase 6 runs it (4 steps, 2
    validations and their saves, the best reload, then the test pass)
    under ``torch.profiler`` with device activity only: its wall time and
    the device's busy share of it."""
    directory = tempfile.mkdtemp(prefix="mme_loop_prof_")
    try:
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1),
                               checkpoint_dir=directory, text_max_len=70,
                               audio_max_samples=96000)
        model, *data = loop_inputs(params, spec, "cuda", 70, 96000)
        transform = make_video_keep_transform(spec, random_mask=True)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run_classifier(cfg, model, *data, batch_transform=transform,
                           device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return {"wall_s": wall, "device_busy_share": busy_share(prof, wall)}


def loop_run(params, spec: TAVSpec, device: str, directory: str,
             text_len: int = 70, audio_len: int = 96000,
             front_ends: Optional[str] = None) -> dict:
    """Phase 6's runs on ``device`` (the CPU runs them at a tiny size):
    ``run_classifier`` trains and tests; the best checkpoint is restored
    into fresh tensors; a save is followed by a train step before its
    ``wait()``; ``MME_EVAL_ONLY=1`` tests the checkpoint again, and with
    ``front_ends`` (a directory) writes the serving exports there too:
    ``MME_PREDICT_OUT`` rows and an ``MME_EXPORT_BUNDLE`` bundle (phase 7's
    first leg). Checks all but the kernel launches and returns what it
    measured."""
    cfg = ExperimentConfig(**LOOP_CFG, checkpoint_dir=directory,
                           text_max_len=text_len, audio_max_samples=audio_len)
    model, train_ds, val_ds, test_ds = loop_inputs(
        params, spec, device, text_len, audio_len)
    n_train = len(train_ds)
    transform = make_video_keep_transform(spec, random_mask=True)
    ckpts = TimedCheckpoints(directory)

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                             batch_transform=transform, checkpoints=ckpts,
                             device=device)
    loop_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    train_logs = [d for d in logs if "train/loss" in d]
    losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                           "test/loss") if k in d]
    state = ckpts.returned

    # the best checkpoint into fresh tensors
    fresh = empty_state_like(state)
    t = time.perf_counter()
    ckpts.restore_best(fresh)
    round_trip = state_diff(fresh, state)

    # the in-place trap: one more step rewrites parameters and moments
    # while the save is in flight
    ckpts.save_best(state, {"epoch": cfg.epoch, "step": state.step,
                            "val_loss": 0.0})
    tx = make_optimizer(cosine_warm_restarts(cfg.learning_rate, cfg.T_max,
                                             n_train // cfg.batch_size),
                        cfg.weight_decay, cfg.clip)
    batch, labels, mask, _ = next(batches(train_ds, np.arange(n_train),
                                          cfg.batch_size))
    batch = transform(torch.Generator(device=device).manual_seed(SEED),
                      to_device(batch, device))
    make_train_step(model, tx, num_classes=cfg.output_dim)(
        state, batch, labels, mask, np.ones(cfg.output_dim, np.float32),
        1.0, True, SEED)
    stepped = [k for k in state_diff(state, fresh)
               if k.startswith(("params", "mu", "nu"))]
    ckpts.wait()
    ckpts.restore_best(state)
    trap = state_diff(state, fresh)
    del fresh

    eval_env = {"MME_EVAL_ONLY": "1",
                "MME_RUN_DIR": os.path.join(directory, "eval_only")}
    if front_ends is not None:
        eval_env.update(MME_PREDICT_OUT=os.path.join(front_ends, ROWS_FILE),
                        MME_EXPORT_BUNDLE=os.path.join(front_ends, "bundle"))
    os.environ.update(eval_env)
    try:
        again = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                               batch_transform=transform, device=device)
    finally:
        for k in eval_env:
            del os.environ[k]
    exports = {}
    with open(os.path.join(eval_env["MME_RUN_DIR"], "metrics.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if "export_bundle" in d or "predict_out" in d:
                exports.update(d)
    eval_rel = (abs(again["test/loss"] - summary["test/loss"])
                / abs(summary["test/loss"]))
    out = {
        "loop_s": loop_s, "launches": launches,
        "utt_per_s_loop": [d["train/steps_per_sec"] * cfg.batch_size
                           for d in train_logs],
        "epochs": [d["epoch"] for d in train_logs],
        "losses": losses, "test_loss": summary["test/loss"],
        "saved_states_stripped": ckpts.stripped,
        "round_trip_diff": round_trip, "in_place_step_changed": stepped,
        "in_place_trap_diff": trap, "eval_only_loss_rel_diff": eval_rel,
        "eval_only_same_matrix": (again["test/confusion_matrix"]
                                  == summary["test/confusion_matrix"]),
        "checkpoint_gb": os.path.getsize(os.path.join(
            ckpts.best_path, STATE_FILE)) / 1e9,
        "save_best_ms": ckpts.ms["save_best"], "wait_ms": ckpts.ms["wait"],
        "restore_best_ms": ckpts.ms["restore_best"],
        "serving_exports": exports, "test_rows": len(test_ds)}
    ok = (all(np.isfinite(losses)) and sorted(set(out["epochs"])) == [0, 1]
          and len([d for d in logs if "val/loss" in d]) == 4
          and len(ckpts.stripped) >= 2 and all(ckpts.stripped)
          and not round_trip and stepped and not trap
          and out["eval_only_same_matrix"] and eval_rel <= EVAL_ONLY_RTOL)
    if not ok:
        print(json.dumps({"train_loop_failed": out}), flush=True)
        raise SystemExit("the training loop phase failed its checks")
    return out


def train_loop(params, card: str, step_ms: float, front_dir: str
               ) -> Tuple[dict, dict, TAVSpec]:
    """Phase 6 on the card; its eval-only run writes phase 7's prediction
    log and bundle into ``front_dir``. Returns the kernel launches of the
    loop's run, what the eval-only run's exports logged and the spec."""
    t0 = time.perf_counter()
    spec = dataclasses.replace(
        TAVSpec(output_dim=7, dropout=0.1).with_compute_dtype(torch.bfloat16),
        share_audio_frontend=True)
    directory = tempfile.mkdtemp(prefix="mme_loop_")
    free_gb = shutil.disk_usage(directory).free / 1e9
    os.environ.update(LOOP_ENV)
    try:
        torch.cuda.reset_peak_memory_stats()
        out = loop_run(params, spec, "cuda", directory,
                       front_ends=front_dir)
        peak = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
        epoch = profiled_epoch(params, spec)
    finally:
        for k in LOOP_ENV:
            del os.environ[k]
        shutil.rmtree(directory, ignore_errors=True)
    n = out["launches"]
    want = {"flash_fwd": LAUNCHES_PER_CHUNK * (LOOP_STEPS + LOOP_EVAL_BATCHES),
            "flash_bwd": LAUNCHES_PER_CHUNK * LOOP_STEPS,
            "adam_update": LOOP_UPDATES}
    print(json.dumps({"train_loop": {
        **out, "expected_launches": want,
        "bare_step_ms_fused_adam": step_ms,
        "utt_per_s_bare_step": 8e3 / step_ms,
        "profiled_epoch": epoch,
        "max_memory_allocated_gb": peak, "free_disk_gb_before": free_gb,
        "phase_s": time.perf_counter() - t0, "card": card}}), flush=True)
    if any(n.get(k, 0) != v for k, v in want.items()):
        raise SystemExit("the training loop did not launch K1, K2 and K3 "
                         "as its steps and updates need")
    return n, {**out["serving_exports"], "test_rows": out["test_rows"]}, spec


# phase 7: the serving front ends at full width, on phase 6's trained
# model. The prediction log's file name in the exports directory; the
# requests of phase 4 (8, 5 and 11 utterances) with their video normalised
# on the host and their own fixed keep-masks, the features a bundle of the
# TAV model takes
ROWS_FILE = "predictions.jsonl"
HTTP_TIMEOUT_S = 300


def bundle_requests(spec: TAVSpec) -> list:
    out = []
    for r in requests(spec):
        r = dict(r)
        r["video"] = normalize_uint8_video(torch.from_numpy(r["video"])).numpy()
        out.append(r)
    return out


def median_ms(fn, batch, n: int = 5) -> Tuple[float, list]:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn(batch)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), times


def served_diff(got, want, tol: float) -> Tuple[float, bool]:
    """max |Δprobs| over the requests, and whether the predictions agree
    wherever the reference's top-2 margin exceeds ``tol``."""
    diff, same = 0.0, True
    for (p, pr), (q, qr) in zip(got, want):
        diff = max(diff, float(np.abs(pr - qr).max()))
        top = np.sort(qr, -1)
        sure = top[:, -1] - top[:, -2] > tol
        same = same and bool((p[sure] == q[sure]).all())
    return diff, same


def http_json(url: str, payload: Optional[bytes] = None):
    req = urllib.request.Request(
        url, data=payload, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def instances(batch: dict, rows) -> bytes:
    return json.dumps({"instances": [{k: v[i].tolist()
                                      for k, v in batch.items()}
                                     for i in rows]}).encode()


def start_daemon(bundle: str) -> Tuple[subprocess.Popen, str]:
    """``python -m mme_tpu_torch.cli.serve`` on a free port, as a user
    starts it; returns the process and its URL once it listens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mme_tpu_torch.cli.serve", "--bundle",
         bundle, "--host", "127.0.0.1", "--port", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + HTTP_TIMEOUT_S
    lines = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"on (http://[\d.]+:\d+)", line)
        if m:
            return proc, m.group(1)
    stop_daemon(proc)
    raise SystemExit("the serving daemon did not start:\n" + "".join(lines))


def stop_daemon(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def front_ends(card: str, spec: TAVSpec, front_dir: str,
               exports: dict) -> dict:
    """Phase 7. ``front_dir`` holds phase 6's prediction log and bundle,
    ``exports`` what their run logged. Returns K1's launches per chunk
    through that bundle and the knobs-on bundle's launches per chunk."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tol = SERVE_TOL[torch.bfloat16]
    bundle = os.path.join(front_dir, "bundle")
    out = {"export_s": exports["export_s"], "save_s": exports["save_s"],
           "bundle_gb": exports["bytes"] / 1e9}

    # (1) the run's exports: one row per test utterance
    with open(os.path.join(front_dir, ROWS_FILE)) as f:
        rows = [json.loads(line) for line in f]
    sums = max(abs(sum(r["probs"]) - 1) for r in rows)
    out["rows"] = len(rows)
    out["rows_max_sum_err"] = sums
    served = load_bundle(bundle, device="cuda")
    out["load_s"] = served.load_s
    ok1 = (len(rows) == exports["test_rows"] == exports["rows"]
           and sums <= 1e-5 and served.ops == ("flash_fwd",)
           and served.platforms == ("cuda",))
    print(f"front ends (1): {len(rows)} rows (test split "
          f"{exports['test_rows']}), max|sum-1| {sums:.1e}; bundle "
          f"{out['bundle_gb']:.3f} GB, ops {served.ops}, export "
          f"{out['export_s']:.1f} s, save {out['save_s']:.1f} s, load "
          f"{out['load_s']:.1f} s", flush=True)
    if not ok1:
        raise SystemExit("the run's serving exports failed their checks")

    # (2) the bundle in this process against a live Predictor on its
    # weights
    model = TAVModel(spec, device="cuda")
    model.load_state_dict({k[len("model."):]: v for k, v in
                           served.module.state_dict().items()}, strict=True)
    live = Predictor(model, batch_size=8, device="cuda")
    reqs = bundle_requests(spec)
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    served(reqs[0])
    live(reqs[0])                                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = [served(r) for r in reqs]
    torch.cuda.synchronize()
    count = dict(kernels.LAUNCHES)
    want = [live(r) for r in reqs]
    diff, same = served_diff(got, want, tol)
    out["bundle_ms_per_batch_of_8"], out["bundle_times_ms"] = median_ms(
        served, reqs[0])
    out["live_ms_per_batch_of_8"], out["live_times_ms"] = median_ms(
        live, reqs[0])
    out["bundle_vs_live_max_abs"] = diff
    per_chunk = {k: v // chunks for k, v in count.items() if v}
    out["bundle_launches_per_chunk"] = per_chunk
    print(f"front ends (2): {chunks} chunks through the bundle, launches "
          f"{count} (expected {LAUNCHES_PER_CHUNK * chunks} flash_fwd); "
          f"max|probs - probs(live)| = {diff:.3e} (tol {tol}), predictions "
          f"agree {same}; ms per batch of 8: bundle "
          f"{out['bundle_ms_per_batch_of_8']:.1f}, live "
          f"{out['live_ms_per_batch_of_8']:.1f}", flush=True)
    if not (same and diff <= tol
            and count["flash_fwd"] == LAUNCHES_PER_CHUNK * chunks
            and sum(count.values()) == count["flash_fwd"]):
        raise SystemExit("the bundle did not serve as the live model")

    # (3) a second bundle exported with both knobs on: K1, K4a and K5a
    # through the operators
    knobs_bundle = os.path.join(front_dir, "bundle_knobs_on")
    with knobs_on():
        info = export_bundle(model, reqs[0], knobs_bundle, batch_size=8,
                             device="cuda")
    out["knobs_on"] = {"export_s": info["export_s"], "save_s": info["save_s"],
                       "bundle_gb": info["bytes"] / 1e9}
    served_on = load_bundle(knobs_bundle, device="cuda")
    out["knobs_on"]["load_s"] = served_on.load_s
    served_on(reqs[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    got_on = [served_on(r) for r in reqs]
    torch.cuda.synchronize()
    count_on = dict(kernels.LAUNCHES)
    diff_on, same_on = served_diff(got_on, want, tol)
    ln_per_chunk = sum(fused_ln_shapes(spec, 8).values())
    expect_on = {"flash_fwd": LAUNCHES_PER_CHUNK * chunks,
                 "fused_mlp_fwd": LAUNCHES_PER_CHUNK * chunks,
                 "layer_norm_fwd": ln_per_chunk * chunks}
    knobs_per_chunk = {k: v // chunks for k, v in count_on.items() if v}
    out["knobs_on"].update(launches_per_chunk=knobs_per_chunk,
                           max_abs_vs_live=diff_on, ops=list(served_on.ops))
    (out["knobs_on"]["ms_per_batch_of_8"],
     out["knobs_on"]["times_ms"]) = median_ms(served_on, reqs[0])
    print(f"front ends (3): knobs-on bundle launches {count_on} (expected "
          f"{expect_on}); max|probs - probs(live, knobs off)| = "
          f"{diff_on:.3e} (tol {tol}), predictions agree {same_on}",
          flush=True)
    del served_on
    if not (same_on and diff_on <= tol
            and {k: v for k, v in count_on.items() if v} == expect_on
            and out["knobs_on"]["ops"] == ["flash_fwd", "fused_mlp_fwd",
                                           "layer_norm_fwd"]):
        raise SystemExit("the knobs-on bundle did not serve through K1, K4a "
                         "and K5a")

    # (4) over HTTP: the bundle through the real entry point in a process
    # of its own, then a live Predictor behind the same service here
    one = {k: v[:1] for k, v in reqs[0].items()}
    body = instances(one, [0])
    proc, url = start_daemon(bundle)
    try:
        health = http_json(f"{url}/healthz")
        http_json(f"{url}/predict", body)               # warm-up
        times, answer = [], None
        for _ in range(3):
            t = time.perf_counter()
            answer = http_json(f"{url}/predict", body)["predictions"]
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        stop_daemon(proc)
    http_diff = float(np.abs(np.asarray(answer[0]["probs"])
                             - got[0][1][0]).max())
    http_ok = (health["status"] == "ok" and health["batch_size"] == 8
               and answer[0]["pred"] == int(got[0][0][0])
               and http_diff <= tol)
    out["http_bundle"] = {"ms_per_request": float(np.median(times)),
                          "times_ms": times, "request_bytes": len(body),
                          "utterances": 1, "max_abs_vs_bundle": http_diff}
    u8 = requests(spec)[0]
    rows3 = {k: v[:3] for k, v in u8.items()}
    body3 = instances(rows3, range(3))
    server = make_server(PredictionService(live, id2label=None))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url3 = "http://%s:%d" % server.server_address[:2]
        http_json(f"{url3}/predict", body3)             # warm-up
        times3, answer3 = [], None
        for _ in range(3):
            t = time.perf_counter()
            answer3 = http_json(f"{url3}/predict", body3)["predictions"]
            times3.append((time.perf_counter() - t) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
    direct = live(rows3)
    live_diff, live_same = served_diff(
        [(np.array([r["pred"] for r in answer3]),
          np.array([r["probs"] for r in answer3]))], [direct], tol)
    out["http_live_uint8"] = {"ms_per_request": float(np.median(times3)),
                              "times_ms": times3,
                              "request_bytes": len(body3), "utterances": 3,
                              "max_abs_vs_predictor": live_diff}
    print(f"front ends (4): daemon {url} healthz {health['status']}; one "
          f"float-video utterance ({len(body) / 1e6:.1f} MB) "
          f"{out['http_bundle']['ms_per_request']:.0f} ms, max|probs - "
          f"bundle| {http_diff:.1e}; live service, 3 uint8 utterances "
          f"({len(body3) / 1e6:.1f} MB) "
          f"{out['http_live_uint8']['ms_per_request']:.0f} ms, max|probs - "
          f"Predictor| {live_diff:.1e}", flush=True)
    del served, live, model
    torch.cuda.empty_cache()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"front_ends": {**out, "card": card}}), flush=True)
    if not (http_ok and live_same and live_diff <= tol):
        raise SystemExit("serving over HTTP failed its checks")
    return {"flash_fwd": per_chunk["flash_fwd"], "knobs_on": knobs_per_chunk}


# phase 8: the fusion family at full width. K1 launches per served chunk
# and per train step (one per attention layer: the 12-layer trunk, and for
# the two-tower model the 6-layer text tower), and K5a/K5b per chunk or
# step with MME_FUSED_MLP=1 (the dense blocks only: TAVMoE's MoE blocks
# run their experts as einsums, as in JAX)
FAMILY = ("TAVFormer", "TAVForMAE2Tower", "TAVForW2V2", "TAVMoE")
FAMILY_FLASH = {"TAVFormer": 12, "TAVForMAE2Tower": 18, "TAVForW2V2": 12,
                "TAVMoE": 12}
FAMILY_MLP = {"TAVFormer": 12, "TAVForMAE2Tower": 18, "TAVForW2V2": 12,
              "TAVMoE": 6}
# TAVMoE's loop: 4 train steps, one validation batch at the epoch's end and
# one test batch
FAMILY_LOOP_SIZES = ((32, 0), (8, 1), (8, 2))
FAMILY_LOOP_STEPS, FAMILY_LOOP_EVAL_BATCHES = 4, 2
# a token's expert set may flip between two numerically valid fp32 runs
# only where the reference's k-th and (k+1)-th router probabilities lie
# closer than this (the runs' router logits differ by ~1e-6); a run with
# such a flip is not held to the fp32 tolerances, and says so
ROUTE_TIE = 1e-4
# the bf16 legs' learning rate, the benchmark configuration's (phase 5):
# at 1e-4 the post-LN trunks overshoot from their random initialisation
FAMILY_LR = 5e-6


class RouteLog:
    """The expert set and the top-k margin (k-th minus (k+1)-th router
    probability) of every token in every MoE router call of ``model``,
    in call order, while ``on``."""

    def __init__(self, model):
        self.calls, self.on = [], False
        self.top_k = {}
        self.handles = []
        for m in model.modules():
            if isinstance(m, MoEMlp):
                self.top_k[id(m.router)] = m.moe.top_k
                self.handles.append(m.router.register_forward_hook(self._hook))

    def _hook(self, mod, args, out):
        if not self.on:
            return
        k = self.top_k[id(mod)]
        gates, _ = router_gates(out.detach(), k)
        top = torch.softmax(out.detach().float(), -1).topk(k + 1, -1).values
        self.calls.append((gates > 0, top[..., k - 1] - top[..., k]))

    @contextlib.contextmanager
    def record(self):
        self.calls, self.on = [], True
        try:
            yield self
        finally:
            self.on = False

    def close(self):
        for h in self.handles:
            h.remove()


def route_diff(got: list, ref: list) -> Tuple[int, int, int]:
    """(tokens routed, tokens routed differently, of those the ones whose
    reference margin is at least ROUTE_TIE) over two RouteLogs' calls."""
    n = flips = firm = 0
    for (a, _), (b, margin) in zip(got, ref):
        moved = (a != b).any(-1)
        n += moved.numel()
        flips += int(moved.sum())
        firm += int((moved & (margin >= ROUTE_TIE)).sum())
    return n, flips, firm


def family_serve(name: str, state, reqs, card: str) -> dict:
    """Serving: bf16 compute over fp32 weights, batch 8, against
    MME_FLASH=0 and with both knobs on against both off; TAVMoE holds its
    kernels against MME_FLASH=0 in an fp32 leg too, with its routes."""
    base = TAVSpec(output_dim=7)
    cls = FUSION_MODELS[name]
    chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
    n_ln = sum(fused_ln_shapes(base, 8, model=name).values())
    is_moe = name == "TAVMoE"
    out = {}
    for dtype in ((torch.float32, torch.bfloat16) if is_moe
                  else (torch.bfloat16,)):
        leg = "fp32" if dtype == torch.float32 else "bf16"
        tol = SERVE_TOL[dtype]
        model = cls(base.with_compute_dtype(dtype), device="cuda")
        model.load_state_dict(state, strict=True)
        routes = RouteLog(model)
        pred = Predictor(model, batch_size=8, device="cuda")
        pred(reqs[0])                                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with routes.record():
            got = [pred(r) for r in reqs]
        torch.cuda.synchronize()
        count = dict(kernels.LAUNCHES)
        got_routes = routes.calls
        os.environ["MME_FLASH"] = "0"
        try:
            kernels.reset_launches()
            with routes.record():
                ref = [pred(r) for r in reqs]
            plain_count = dict(kernels.LAUNCHES)
        finally:
            del os.environ["MME_FLASH"]
        ref_routes = routes.calls
        diff, same = served_diff(got, ref, tol)
        n_tok, flips, firm = route_diff(got_routes, ref_routes)
        finite = all(np.isfinite(p).all() for _, p in got + ref)
        shapes_ok = all(p.shape == (len(r["input_ids"]), 7)
                        for (_, p), r in zip(got, reqs))
        # a zero-padded partial chunk: the same rows as in a full chunk
        part = {k: v[:3] for k, v in reqs[0].items()}
        pad_diff = float(np.abs(pred(part)[1] - got[0][1][:3]).max())
        res = {"flash_launches_per_chunk": count["flash_fwd"] / chunks,
               "max_abs_vs_plain": diff, "predictions_agree": same,
               "padded_chunk_max_abs": pad_diff, "finite": finite,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if is_moe:
            res.update(router_tokens=n_tok, routed_differently=flips,
                       routed_differently_past_tie=firm)
        # fp32 legs (TAVMoE) hold probabilities to SERVE_TOL unless a token
        # flipped at a near-tie; bf16 legs of TAVMoE report their flips
        held = not (is_moe and (dtype == torch.bfloat16 or flips))
        ok = (finite and shapes_ok and pad_diff <= SERVE_TOL[torch.float32]
              and count["flash_fwd"] == FAMILY_FLASH[name] * chunks
              and plain_count["flash_fwd"] == 0
              and (not held or (diff <= tol and same))
              and not (is_moe and dtype == torch.float32 and firm))
        print(f"family {name} serve {leg}: {chunks} chunks, launches "
              f"{count['flash_fwd']} K1 (expected "
              f"{FAMILY_FLASH[name] * chunks}), {plain_count['flash_fwd']} "
              f"with MME_FLASH=0; max|probs - probs(MME_FLASH=0)| = "
              f"{diff:.3e} (tol {tol}{'' if held else ', reported only'}), "
              f"predictions agree {same}; padded chunk {pad_diff:.1e}"
              + (f"; tokens routed differently {flips} of {n_tok} "
                 f"({firm} past a near-tie)" if is_moe else ""), flush=True)
        if not ok:
            raise SystemExit(f"phase 8: serving {name} ({leg}) failed")

        # the same requests with MME_FUSED_LN=1 and MME_FUSED_MLP=1
        with knobs_on():
            pred(reqs[0])                                   # warm-up
            kernels.reset_launches()
            with routes.record():
                fused = [pred(r) for r in reqs]
            count_f = dict(kernels.LAUNCHES)
        diff_f, same_f = served_diff(fused, got, tol)
        _, flips_f, firm_f = route_diff(routes.calls, got_routes)
        expect = {"flash_fwd": FAMILY_FLASH[name] * chunks,
                  "fused_mlp_fwd": FAMILY_MLP[name] * chunks,
                  "layer_norm_fwd": n_ln * chunks}
        held_f = not (is_moe and (dtype == torch.bfloat16 or flips_f))
        finite_f = all(np.isfinite(p).all() for _, p in fused)
        print(f"family {name} serve {leg}, both knobs on: launches "
              f"{ {k: v for k, v in count_f.items() if v} } (expected "
              f"{expect}); max|probs - probs(knobs off)| = {diff_f:.3e}"
              + (f"; tokens routed differently {flips_f} ({firm_f} past a "
                 "near-tie)" if is_moe else ""), flush=True)
        if not (finite_f and {k: v for k, v in count_f.items() if v}
                == expect and (not held_f or (diff_f <= tol and same_f))
                and not (is_moe and dtype == torch.float32 and firm_f)):
            raise SystemExit(f"phase 8: serving {name} ({leg}) with both "
                             "knobs on failed")
        res.update(max_abs_knobs_on_vs_off=diff_f,
                   launches_per_chunk_knobs_on={
                       k: v // chunks for k, v in count_f.items() if v})
        if is_moe:
            res.update(routed_differently_knobs_on=flips_f)
        if dtype == torch.bfloat16:
            res["ms_per_batch_of_8"], res["times_ms"] = median_ms(
                pred, reqs[0])
            with knobs_on():
                (res["ms_per_batch_of_8_knobs_on"],
                 res["times_ms_knobs_on"]) = median_ms(pred, reqs[0])
        out[leg] = res
        routes.close()
        del pred, model, routes
        torch.cuda.empty_cache()
    return out


def family_train(name: str, params, card: str) -> dict:
    """Training: (1) fp32, no dropout, batch 4: loss and gradients with the
    kernels against MME_FLASH=0; (2) bf16, no dropout, four steps on one
    batch of 8 with MME_OPT_STATE=bf16 and every knob on: the eval loss
    after them below the one before, one K3 launch per step."""
    is_moe = name == "TAVMoE"
    cls = FUSION_MODELS[name]
    state = from_flax(params)
    out = {}

    # (1) fp32
    spec = without_noise(TAVSpec(output_dim=7))
    model = cls(spec, device="cuda")
    model.load_state_dict(state, strict=True)
    routes = RouteLog(model)
    batch, labels, mask, cw = train_inputs(spec, 4, SEED + 50)
    batch = to_device(batch, "cuda")
    labels, mask, cw = (torch.as_tensor(x, device="cuda")
                        for x in (labels, mask, cw))
    params_t = list(model.parameters())
    model.train()

    def loss_and_grads():
        kernels.reset_launches()
        with routes.record():
            logits = model(batch)
        aux = None
        if is_moe:
            logits, aux = logits
        ce = cross_entropy(logits, labels, cw, mask)
        loss = ce if aux is None else ce + aux
        grads = torch.autograd.grad(loss, params_t, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params_t)]
        torch.cuda.synchronize()
        extra = {}
        if is_moe:
            router = [g for (n, _), g in zip(model.named_parameters(), grads)
                      if n.endswith("moe_mlp.router.weight")]
            extra = {"aux": aux.item(), "ce": ce.item(),
                     "router_grad_norm": global_norm_f32(router).item()}
        return (loss.item(), global_norm_f32(grads).item(),
                tower_norms(model, grads), dict(kernels.LAUNCHES),
                routes.calls, extra)

    loss, norm, towers, count, r_got, extra = loss_and_grads()
    os.environ["MME_FLASH"] = "0"
    try:
        loss0, norm0, towers0, count0, r_ref, _ = loss_and_grads()
    finally:
        del os.environ["MME_FLASH"]
    routes.close()
    rel = {k: abs(towers[k] - towers0[k]) / max(towers0[k], 1e-12)
           for k in towers0}
    _, flips, firm = route_diff(r_got, r_ref)
    held = not flips
    ok = (np.isfinite(loss) and np.isfinite(norm)
          and count["flash_fwd"] == count["flash_bwd"] == FAMILY_FLASH[name]
          and count0["flash_fwd"] == count0["flash_bwd"] == 0 and not firm
          and (not held or (abs(loss - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
                            and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0
                            and max(rel.values()) <= TRAIN_NORM_RTOL)))
    if is_moe:
        ok = ok and (np.isfinite(extra["aux"]) and extra["aux"] > 0
                     and abs(loss - extra["ce"] - extra["aux"])
                     <= 1e-6 * abs(loss) and extra["router_grad_norm"] > 0)
    out["fp32"] = {"batch": 4, "loss": loss, "loss_plain": loss0,
                   "grad_norm": norm, "grad_norm_plain": norm0,
                   "tower_norm_rel_diff": rel, "launches": count,
                   "routed_differently": flips, **extra}
    print(f"family {name} train fp32: {json.dumps(out['fp32'])}", flush=True)
    if not ok:
        raise SystemExit(f"phase 8: the fp32 training check of {name} "
                         "failed")
    del model, params_t
    torch.cuda.empty_cache()

    # (2) bf16, four steps, every knob on
    spec = without_noise(TAVSpec(output_dim=7)).with_compute_dtype(
        torch.bfloat16)
    model = cls(spec, device="cuda")
    model.load_state_dict(state, strict=True)
    n_ln = sum(fused_ln_shapes(spec, 8, model=name).values())
    env = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1", **KNOBS}
    os.environ.update(env)
    try:
        tx = make_optimizer(cosine_warm_restarts(FAMILY_LR, 10, 1000), 0.01,
                            1.0)
        st = TrainState.create(model.parameters(), tx, use_accum=False,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED))
        step = make_train_step(model, tx, num_classes=7,
                               has_aux_loss=is_moe)
        ev = make_eval_step(model, num_classes=7, has_aux_loss=is_moe)
        batch, labels, mask, cw = train_inputs(spec, 8, SEED + 60)
        batch = to_device(batch, "cuda")
        before = ev(batch, labels, mask, cw)[0].item()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], []
        for _ in range(4):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(l.item())
            counts.append(dict(kernels.LAUNCHES))
        after = ev(batch, labels, mask, cw)[0].item()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for k in env:
            del os.environ[k]
    expect = {"flash_fwd": FAMILY_FLASH[name], "flash_bwd": FAMILY_FLASH[name],
              "fused_mlp_fwd": FAMILY_MLP[name],
              "fused_mlp_bwd": FAMILY_MLP[name], "layer_norm_fwd": n_ln,
              "layer_norm_bwd": n_ln, "adam_update": 1}
    per_step = [{k: v for k, v in c.items() if v} for c in counts]
    out["bf16"] = {"eval_loss_before": before, "eval_loss_after": after,
                   "losses": losses, "times_ms": times,
                   "ms_per_step": float(np.median(times[1:])),
                   "peak_gb": peak, "launches_per_step": per_step[-1],
                   "expected_launches_per_step": expect}
    print(f"family {name} train bf16: {json.dumps(out['bf16'])}",
          flush=True)
    if not (all(np.isfinite(losses)) and np.isfinite(after)
            and after < before and all(c == expect for c in per_step)):
        raise SystemExit(f"phase 8: the bf16 training leg of {name} failed")
    del model, st, step, ev
    torch.cuda.empty_cache()
    return out


def family_moe_loop(params, card: str) -> dict:
    """TAVMoE through ``run_classifier(has_aux_loss=True)`` (bf16 compute,
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1, one epoch of 4 steps, one
    validation) with MME_EXPORT_BUNDLE set; the bundle loaded with
    ``load_bundle(device="cuda")`` against a live Predictor on its
    weights."""
    spec = TAVSpec(output_dim=7, dropout=0.1).with_compute_dtype(
        torch.bfloat16)
    directory = tempfile.mkdtemp(prefix="mme_moe_loop_")
    bundle = os.path.join(directory, "bundle")
    env = dict(LOOP_ENV, MME_EXPORT_BUNDLE=bundle,
               MME_RUN_DIR=os.path.join(directory, "run"))
    try:
        (n_train, s_train), *evals = FAMILY_LOOP_SIZES
        train_ds = synthetic_tav_dataset(spec, n_train, 70, 96000,
                                         seed=s_train)
        val_ds, test_ds = (synthetic_tav_dataset(spec, n, 70, 96000, seed=s)
                           for n, s in evals)
        model = TAVMoEFormer(spec, device="cuda")
        model.load_state_dict(from_flax(params), strict=True)
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1, log_val=4),
                               checkpoint_dir=os.path.join(directory, "ck"),
                               text_max_len=70, audio_max_samples=96000)
        os.environ.update(env)
        try:
            kernels.reset_launches()
            t = time.perf_counter()
            summary = run_classifier(
                cfg, model, train_ds, val_ds, test_ds,
                batch_transform=make_video_keep_transform(spec),
                has_aux_loss=True, device="cuda")
            loop_s = time.perf_counter() - t
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        finally:
            for k in env:
                del os.environ[k]
        with open(os.path.join(env["MME_RUN_DIR"], "metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                               "test/loss") if k in d]
        exported = next(d for d in logs if "export_bundle" in d)
        del model
        torch.cuda.empty_cache()

        served = load_bundle(bundle, device="cuda")
        live_model = TAVMoEFormer(spec, device="cuda")
        live_model.load_state_dict(
            {k[len("model."):]: v for k, v in
             served.module.state_dict().items()}, strict=True)
        live = Predictor(live_model, batch_size=8, device="cuda")
        reqs = bundle_requests(spec)
        chunks = sum(-(-len(r["input_ids"]) // 8) for r in reqs)
        served(reqs[0])
        live(reqs[0])                                   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = [served(r) for r in reqs]
        torch.cuda.synchronize()
        count = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = [live(r) for r in reqs]
        tol = SERVE_TOL[torch.bfloat16]
        diff, same = served_diff(got, want, tol)
        with open(os.path.join(bundle, "meta.json")) as f:
            meta_model = json.load(f)["model"]
        out = {"loop_s": loop_s, "launches": launches, "losses": losses,
               "test_loss": summary["test/loss"],
               "export_s": exported["export_s"], "save_s": exported["save_s"],
               "bundle_gb": exported["bytes"] / 1e9, "load_s": served.load_s,
               "bundle_ops": list(served.ops), "bundle_model": meta_model,
               "bundle_launches_per_chunk": {
                   k: v // chunks for k, v in count.items()},
               "bundle_vs_live_max_abs": diff, "predictions_agree": same}
        (out["bundle_ms_per_batch_of_8"],
         out["bundle_times_ms"]) = median_ms(served, reqs[0])
        del served, live, live_model
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    want_loop = {"flash_fwd": 12 * (FAMILY_LOOP_STEPS
                                    + FAMILY_LOOP_EVAL_BATCHES),
                 "flash_bwd": 12 * FAMILY_LOOP_STEPS,
                 "adam_update": FAMILY_LOOP_STEPS}
    out["expected_launches"] = want_loop
    print(f"family TAVMoE loop and bundle: {json.dumps(out)}", flush=True)
    if not (all(np.isfinite(losses)) and launches == want_loop
            and count == {"flash_fwd": 12 * chunks}
            and out["bundle_ops"] == ["flash_fwd"]
            and meta_model == "TAVMoEFormer" and same and diff <= tol):
        raise SystemExit("phase 8: TAVMoE through run_classifier and its "
                         "bundle failed")
    return out


def fusion_family(card: str) -> dict:
    """Phase 8. Returns per model the launches of one served chunk with
    both knobs on and of one bf16 train step with every knob on."""
    t0 = time.perf_counter()
    reqs = requests(TAVSpec(output_dim=7))
    launches = {}
    for name in FAMILY:
        t = time.perf_counter()
        params = init_params(TAVSpec(output_dim=7), SEED, model=name)
        state = from_flax(params)
        n_params = sum(v.numel() for v in state.values())
        res = {"parameters": n_params,
               "weights_s": time.perf_counter() - t}
        res["serve"] = family_serve(name, state, reqs, card)
        res["train"] = family_train(name, params, card)
        if name == "TAVMoE":
            res["loop"] = family_moe_loop(params, card)
        del params, state
        torch.cuda.empty_cache()
        res["phase_s"] = time.perf_counter() - t
        bf16 = res["serve"]["bf16"]
        print(json.dumps({"fusion_family": {
            "model": name, "parameters": n_params,
            "serve_ms_per_batch_of_8": bf16["ms_per_batch_of_8"],
            "serve_ms_per_batch_of_8_knobs_on":
                bf16["ms_per_batch_of_8_knobs_on"],
            "train_bf16_ms_per_step": res["train"]["bf16"]["ms_per_step"],
            "peak_gb": max(bf16["peak_gb"],
                           res["train"]["bf16"]["peak_gb"]),
            "launches_serve_chunk_knobs_on":
                bf16["launches_per_chunk_knobs_on"],
            "launches_train_step": res["train"]["bf16"]["launches_per_step"],
            "model_s": res["phase_s"], "detail": res, "card": card}}),
            flush=True)
        launches[name] = {"serve": bf16["launches_per_chunk_knobs_on"],
                          "step": res["train"]["bf16"]["launches_per_step"]}
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 9: the audio classifier and the BatchNorm vision models at full
# width. wav2vec2-base's Wav2Vec2Classifier goes through phase 10's legs
# (`zoo_model_legs`) at batch 8 over 96 000-sample waveforms: 299 frames,
# 2 392 rows; per served chunk or train step K1 and K5a (K2 and K5b) once
# per encoder layer, K4a (K4b) on the feature projection's LayerNorm, the
# post-LN encoder's `ln` and two per layer
W2V_LEN = 96000
# SlowR50 at visual_nn's full size: stages (3, 4, 6, 3), 16x224x224 clips,
# batch 8, fp32; Adam's learning rate for its steps
SLOW_BATCH, SLOW_FRAMES, SLOW_SIZE, SLOW_LR = 8, 16, 224, 1e-4
# the first BatchNorm's running statistics after one step against their
# recomputation from the stem's output: both fp32 means over 1.6 M values
# per channel, summed in other orders (the module takes E[x²] - E[x]², the
# recomputation the two-pass variance)
BN_STAT_TOL = dict(rtol=1e-4, atol=1e-6)
# images_nn's ResnetClassifier at 224x224 through run_classifier: one epoch
# of 4 steps of 8 images, one validation and one test batch
RESNET_SIZES = ((32, 90), (8, 91), (8, 92))


def load_drawn(net):
    """``net`` with weights and statistics from ``init_variables`` (drawn
    on the host), and its parameter count."""
    net.load_state_dict(from_flax(**init_variables(net, SEED)), strict=True)
    return net, sum(p.numel() for p in net.parameters())


def steps_of(model, tx, batch, labels, mask, cw, n: int):
    """n train steps on one batch: losses and ms per step."""
    st = TrainState.create(model.parameters(), tx, use_accum=False,
                           buffers=model_buffers(model))
    step = make_train_step(model, tx, num_classes=cw.shape[0])
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(l.item())
    return st, step, losses, times


def slow_r50(card: str) -> dict:
    """SlowR50(output_dim=7) at visual_nn's full size in fp32: one train
    step whose stem statistics are held against a biased-variance
    recomputation, three more with a falling eval loss, a checkpoint round
    trip of parameters and statistics, a bundle against the live model."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(SlowR50(7, device="cuda"))
    model = BatchModel(net, ("video",))
    ds = visual_nn.synthetic_video(SLOW_BATCH, SLOW_FRAMES, SLOW_SIZE, 7,
                                   SEED + 100)
    batch = to_device(ds.features, "cuda")
    labels = torch.as_tensor(ds.labels, device="cuda")
    mask = torch.ones(SLOW_BATCH, dtype=torch.int32, device="cuda")
    cw = torch.ones(7, device="cuda")
    ev = make_eval_step(model, num_classes=7)
    before = ev(batch, labels, mask, cw)[0].item()

    stem = []
    hook = net.stem_conv.register_forward_hook(
        lambda m, a, out: stem.append(out.detach()))
    tx = make_optimizer(lambda s: SLOW_LR, 0.01, 1.0)
    mean0, var0 = net.stem_bn.mean.clone(), net.stem_bn.var.clone()
    st, step, losses, times = steps_of(model, tx, batch, labels, mask, cw, 1)
    hook.remove()
    y = stem[0]
    dims = (0, 2, 3, 4)
    want_mean = 0.9 * mean0 + 0.1 * y.mean(dims)
    want_var = 0.9 * var0 + 0.1 * y.var(dims, unbiased=False)
    unbiased = 0.9 * var0 + 0.1 * y.var(dims, unbiased=True)
    err_mean = (net.stem_bn.mean - want_mean).abs().max().item()
    err_var = (net.stem_bn.var - want_var).abs().max().item()
    stats_ok = (torch.allclose(net.stem_bn.mean, want_mean, **BN_STAT_TOL)
                and torch.allclose(net.stem_bn.var, want_var, **BN_STAT_TOL))
    unbiased_gap = (unbiased - want_var).abs().max().item()
    del stem, y

    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(l.item())
    after = ev(batch, labels, mask, cw)[0].item()

    directory = tempfile.mkdtemp(prefix="mme_slow_r50_")
    try:
        ck = CheckpointManager(os.path.join(directory, "ck"), use_async=False)
        ck.save_best(st, {"val_loss": after})
        saved_p = [p.detach().clone() for p in st.params]
        saved_b = {k: b.clone() for k, b in st.buffers.items()}
        step(st, batch, labels, mask, cw, 1.0, True, SEED)   # moves both
        moved = not all(torch.equal(a, b) for a, b in zip(st.params, saved_p))
        t = time.perf_counter()
        ck.restore_best(st)
        restore_s = time.perf_counter() - t
        restored = (all(torch.equal(a, b) for a, b in zip(st.params, saved_p))
                    and all(torch.equal(st.buffers[k], b)
                            for k, b in saved_b.items()))

        bundle = os.path.join(directory, "bundle")
        info = export_bundle(model, ds.features, bundle, batch_size=8,
                             device="cuda")
        served = load_bundle(bundle, device="cuda")
        live = Predictor(model, batch_size=8, device="cuda")
        reqs = [ds.features, {k: v[:5] for k, v in ds.features.items()}]
        want = [live(r) for r in reqs]
        got = [served(r) for r in reqs]
        diff, same = served_diff(got, want, SERVE_TOL[torch.float32])
        live_ms, _ = median_ms(live, reqs[0], n=3)
        bundle_ms, _ = median_ms(served, reqs[0], n=3)
        del served, live
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    res = {"parameters": n_params, "batch": SLOW_BATCH,
           "clip": [SLOW_FRAMES, SLOW_SIZE, SLOW_SIZE],
           "stem_stats_max_abs": [err_mean, err_var],
           "stem_var_unbiased_gap": unbiased_gap,
           "losses": losses, "eval_loss_before": before,
           "eval_loss_after": after, "times_ms": times,
           "ms_per_step": float(np.median(times[1:])),
           "checkpoint_moved_then_restored": [moved, restored],
           "restore_s": restore_s, "bundle_export_s": info["export_s"],
           "bundle_gb": info["bytes"] / 1e9, "bundle_vs_live_max_abs": diff,
           "predictions_agree": same, "live_ms_per_batch_of_8": live_ms,
           "bundle_ms_per_batch_of_8": bundle_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": {"model": "SlowR50", **res}}),
          flush=True)
    if not (stats_ok and all(np.isfinite(losses)) and after < before
            and moved and restored and same
            and diff <= SERVE_TOL[torch.float32]):
        raise SystemExit("phase 9: SlowR50 failed")
    del model, net, st, step, ev
    torch.cuda.empty_cache()
    return res


def resnet_frozen(card: str) -> dict:
    """ResnetClassifier(output_dim=2) at 224x224 through run_classifier for
    one epoch with images_nn's frozen-backbone mask: every backbone
    parameter but ``backbone.fc`` unchanged bit for bit, the running
    statistics moved, the head moved, ``backbone.fc``'s kernel moved by
    AdamW's weight decay."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(ResnetClassifier(2, device="cuda"))
    model = BatchModel(net, ("image",))
    mask = images_nn.fc_trainable_mask(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in model_buffers(model).items()}
    train_ds, val_ds, test_ds = (synthetic_image_dataset(n, 224, 2, s)
                                 for n, s in RESNET_SIZES)
    directory = tempfile.mkdtemp(prefix="mme_resnet_")
    env = {"MME_RUN_DIR": os.path.join(directory, "run")}
    os.environ.update(env)
    try:
        cfg = ExperimentConfig(batch_size=8, epoch=1, log_val=4,
                               patience=10, learning_rate=1e-3, output_dim=2,
                               dataset="synthetic", seed=SEED,
                               checkpoint_dir=os.path.join(directory, "ck"))
        t = time.perf_counter()
        summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                                 trainable_mask=mask, device="cuda")
        loop_s = time.perf_counter() - t
    finally:
        del os.environ["MME_RUN_DIR"]
        shutil.rmtree(directory, ignore_errors=True)
    moved = {n: not torch.equal(p, before[n])
             for n, p in model.named_parameters()}
    frozen_still = all(not moved[n] for (n, _), m in
                       zip(model.named_parameters(), mask) if not m)
    trainable = [n for (n, _), m in zip(model.named_parameters(), mask) if m]
    stats_moved = any(not torch.equal(b, stats[k])
                      for k, b in model_buffers(model).items())
    # the head trains; the backbone's unused fc moves by weight decay alone
    # (its zero bias stays zero)
    head_moved = all(moved[n] for n in trainable if n.startswith("net.fc."))
    res = {"parameters": n_params, "trainable": trainable,
           "trainable_moved": {n: moved[n] for n in trainable},
           "frozen_unchanged": frozen_still, "statistics_moved": stats_moved,
           "test_loss": summary["test/loss"], "loop_s": loop_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": {"model": "ResnetClassifier", **res}}),
          flush=True)
    if not (frozen_still and stats_moved and head_moved
            and moved["net.backbone.fc.weight"]
            and np.isfinite(summary["test/loss"])
            and len(trainable) == 4):
        raise SystemExit("phase 9: ResnetClassifier with the frozen "
                         "backbone failed")
    del model, net
    torch.cuda.empty_cache()
    return res


def conv_nets(card: str) -> list:
    """Conv3DClassifier at visual_nn's full size (16x224x224 clips) and
    ConvNetClassifier at images_nn's (224x224, hidden (32, 32), the binary
    sigmoid head): a forward and two train steps each, batch 8, fp32."""
    out = []
    for name, net, key, shape, classes in (
            ("Conv3DClassifier", Conv3DClassifier(7, device="cuda"), "video",
             (8, 16, 224, 224, 3), 7),
            ("ConvNetClassifier", ConvNetClassifier((32, 32), 1, 224,
                                                    device="cuda"),
             "image", (8, 224, 224, 3), 2)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        net, n_params = load_drawn(net)
        model = BatchModel(net, (key,))
        g = torch.Generator(device="cuda").manual_seed(SEED)
        batch = {key: torch.rand(shape, generator=g, device="cuda")}
        labels = torch.arange(8, device="cuda") % classes
        mask = torch.ones(8, dtype=torch.int32, device="cuda")
        cw = torch.ones(classes, device="cuda")
        model.eval()
        with torch.no_grad():
            logits = model(batch)
        tx = make_optimizer(lambda s: 1e-4, 0.01, 1.0)
        _, _, losses, times = steps_of(model, tx, batch, labels, mask, cw, 2)
        res = {"model": name, "parameters": n_params,
               "logits_shape": list(logits.shape), "losses": losses,
               "ms_per_step": times[-1], "times_ms": times,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "model_s": time.perf_counter() - t0, "card": card}
        print(json.dumps({"slice_model": res}), flush=True)
        if not (tuple(logits.shape) == (8, classes)
                and bool(torch.isfinite(logits).all())
                and all(np.isfinite(losses))):
            raise SystemExit(f"phase 9: {name} failed")
        out.append(res)
        del model, net
        torch.cuda.empty_cache()
    return out


def slice_models(card: str) -> dict:
    """Phase 9. Returns wav2vec2-base's launches of one served chunk with
    both knobs on and of one bf16 train step with every knob on."""
    t0 = time.perf_counter()
    launches = zoo_model_legs("Wav2Vec2Classifier", card)
    torch.cuda.empty_cache()
    slow_r50(card)
    resnet_frozen(card)
    conv_nets(card)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 10: the text and two-modality classifiers at full width, batch 8,
# 70 tokens, 160 000-sample waveforms (499 frames) and 16x224x224 clips
# (1 568 tokens), weights from init_variables, one model at a time. K1 per
# served chunk or train step once per attention layer (DistilRoBERTa 6,
# wav2vec2-base 12, VideoMAE 12, VisualBERT 12), K5a/K5b as many with
# MME_FUSED_MLP=1, K4a/K4b from `classifier_ln_sites` (the 1 024-row gate
# keeps the 560 text rows and VisualBERT's 568 off the kernels). Phase 9's
# Wav2Vec2Classifier takes the same legs at W2V_LEN samples.
ZOO_TEXT_LEN, ZOO_SAMPLES = 70, 160000
# text_nn's LSTM: vocabulary 5 000, 300-wide embedding and state, one layer
LSTM_VOCAB, LSTM_DIM = 5000, 300


def quiet_encoder(e):
    return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)


def with_encoder(spec, enc):
    return dataclasses.replace(spec, encoder=enc(spec.encoder))


def w2v_base(enc, quiet: bool) -> Wav2Vec2Spec:
    spec = with_encoder(Wav2Vec2Spec.base(), enc)
    if quiet:
        spec = dataclasses.replace(spec, mask_time_prob=0.0,
                                   mask_feature_prob=0.0)
    return spec


def text_audio_base(enc, quiet: bool) -> TextAudioSpec:
    return TextAudioSpec(text=with_encoder(TextEncoderSpec.distilroberta(),
                                           enc),
                         audio=w2v_base(enc, quiet), output_dim=7,
                         dropout=0.0 if quiet else 0.5)


def text_video_base(enc, quiet: bool) -> TextVideoSpec:
    return TextVideoSpec(text=with_encoder(TextEncoderSpec.distilroberta(),
                                           enc),
                         video=with_encoder(VideoMAESpec.base(), enc),
                         output_dim=7, dropout=0.0 if quiet else 0.5)


def text_video_data(n: int, seed: int, video_only: bool = False,
                    tasks: bool = False):
    """``synthetic_tv`` at full size; ``tasks``: a per-row ``task_id``
    alternating text and video."""
    ds = text_video_nn.synthetic_tv(text_video_base(lambda e: e, False), n,
                                    ZOO_TEXT_LEN, 7, seed)
    if video_only:
        ds.features = {"video": ds.features["video"]}
    if tasks:
        ds.features["task_id"] = (np.arange(n) % 2).astype(np.int32)
    return ds


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """One classifier of phases 9 and 10. ``spec(enc, quiet)``: its
    full-width spec with ``enc`` applied to every encoder spec (``quiet``:
    SpecAugment and the head's dropout off); ``build(spec, rate, device)``
    the module, ``rate`` the head's dropout where the spec has none;
    ``data(n, seed)`` n records drawn as its CLI draws them; ``flash`` its
    K1 launches per forward. Legs: ``train_fp32`` the fp32 gradients
    against MME_FLASH=0, ``train_bf16`` four bf16 steps, ``looped``
    ``run_classifier`` and a bundle. Seeds: the served requests
    ((rows, seed)), the fp32 and the bf16 batch, the loop's splits."""
    spec: Callable
    build: Callable
    inputs: tuple
    data: Callable
    flash: int
    classes: int = 7
    samples: int = ZOO_SAMPLES
    train_fp32: bool = True
    train_bf16: bool = True
    looped: bool = False
    requests: tuple = ((8, 110), (5, 111), (11, 112))
    train_seeds: tuple = (130, 131)
    loop_sizes: tuple = ((32, 120), (8, 121), (8, 122))


# phase 10's models, then phase 9's wav2vec2-base with its own seeds
ZOO_MODELS = {
    "BertClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(TextEncoderSpec.distilroberta(),
                                             enc),
        build=lambda s, rate, device: BertClassifier(s, 7, rate,
                                                     device=device),
        inputs=("input_ids", "text_mask"),
        data=lambda n, seed: synthetic_text_dataset(50265, n, ZOO_TEXT_LEN,
                                                    7, seed),
        flash=6),
    "BertAudioClassifier": ZooModel(
        spec=text_audio_base,
        build=lambda s, rate, device: BertAudioClassifier(s, device=device),
        inputs=text_audio_nn.INPUTS,
        data=lambda n, seed: text_audio_nn.synthetic_ta(
            text_audio_base(lambda e: e, False), n, ZOO_TEXT_LEN,
            ZOO_SAMPLES, 7, seed),
        flash=18, looped=True),
    "BertVideoMAELateFusion": ZooModel(
        spec=text_video_base,
        build=lambda s, rate, device: BertVideoMAELateFusion(s,
                                                             device=device),
        inputs=text_video_nn.INPUTS, data=text_video_data, flash=18),
    "BertVideoMAEMTLShared": ZooModel(
        spec=text_video_base,
        build=lambda s, rate, device: BertVideoMAEMTLShared(s, device=device),
        inputs=text_video_nn.INPUTS + ("task_id",),
        data=lambda n, seed: text_video_data(n, seed, tasks=True),
        flash=18, train_bf16=False),
    "VBertClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(VisualBertSpec(), enc),
        build=lambda s, rate, device: VBertClassifier(s, 2, rate,
                                                      device=device),
        inputs=visual_bert_nn.INPUTS,
        data=lambda n, seed: visual_bert_nn.synthetic_vbert(
            n, ZOO_TEXT_LEN, 1024, 30522, 2, seed),
        flash=12, classes=2),
    "VideoMAEClassifier": ZooModel(
        spec=lambda enc, quiet: with_encoder(VideoMAESpec.base(), enc),
        build=lambda s, rate, device: VideoMAEClassifier(s, 7, rate,
                                                         device=device),
        inputs=("video",),
        data=lambda n, seed: text_video_data(n, seed, video_only=True),
        flash=12, train_fp32=False, train_bf16=False),
    "Wav2Vec2Classifier": ZooModel(
        spec=w2v_base,
        build=lambda s, rate, device: Wav2Vec2Classifier(s, 7, rate,
                                                         device=device),
        inputs=("waveform", "audio_mask"),
        data=lambda n, seed: synthetic_audio_dataset(n, W2V_LEN, 7, seed),
        flash=12, samples=W2V_LEN, looped=True,
        requests=((8, 70), (5, 71), (11, 72)), train_seeds=(73, 74),
        loop_sizes=((32, 80), (8, 81), (8, 82))),
}
ZOO = tuple(name for name in ZOO_MODELS if name != "Wav2Vec2Classifier")


def zoo_spec(name: str, dtype: torch.dtype, quiet: bool = False):
    """The full-width spec of ``name`` computing in ``dtype``; ``quiet``:
    every dropout rate and SpecAugment probability 0 (the classifier's
    own dropout is ``zoo_net``'s)."""
    def enc(e):
        e = dataclasses.replace(e, dtype=dtype)
        return quiet_encoder(e) if quiet else e
    return ZOO_MODELS[name].spec(enc, quiet)


def zoo_net(name: str, dtype: torch.dtype, quiet: bool = False,
            device: str = "cuda"):
    """(the classifier, the batch keys it takes)."""
    m = ZOO_MODELS[name]
    return (m.build(zoo_spec(name, dtype, quiet), 0.0 if quiet else 0.5,
                    device), m.inputs)


def zoo_model(name: str, params, dtype: torch.dtype,
              quiet: bool = False) -> BatchModel:
    net, inputs = zoo_net(name, dtype, quiet)
    net.load_state_dict(from_flax(params), strict=True)
    return BatchModel(net, inputs)


def zoo_requests(name: str) -> Tuple[list, int]:
    """The served requests' features and their chunks of 8."""
    reqs = ZOO_MODELS[name].requests
    return ([ZOO_MODELS[name].data(n, seed).features for n, seed in reqs],
            sum(-(-n // 8) for n, _ in reqs))


def zoo_ln(name: str, batch: int = 8) -> int:
    """K4a (K4b) launches per chunk (step) of ``batch`` from the spec."""
    return sum(fused_ln_sites(classifier_ln_sites(
        zoo_spec(name, torch.bfloat16), batch, ZOO_TEXT_LEN,
        ZOO_MODELS[name].samples)).values())


def zoo_batch(name: str, n: int, seed: int, task=None):
    """n records on the card with their labels, an all-ones sample mask
    and unit class weights; ``task`` sets the MTL's 0-d task."""
    ds = ZOO_MODELS[name].data(n, seed)
    feats = dict(ds.features)
    if task is not None:
        feats["task_id"] = np.asarray(task, np.int32)
    return (to_device(feats, "cuda"), torch.as_tensor(ds.labels,
                                                      device="cuda"),
            torch.ones(n, dtype=torch.int32, device="cuda"),
            torch.ones(ZOO_MODELS[name].classes, device="cuda"))


def zoo_serve(name: str, params, card: str) -> dict:
    """bf16 compute over fp32 weights, batch 8, ragged requests of 8, 5
    and 11 rows: K1 against MME_FLASH=0, then both knobs on against both
    off."""
    m = ZOO_MODELS[name]
    reqs, chunks = zoo_requests(name)
    flash, n_ln = m.flash, zoo_ln(name)
    tol = SERVE_TOL[torch.bfloat16]
    model = zoo_model(name, params, torch.bfloat16)
    pred = Predictor(model, batch_size=8, device="cuda")
    pred(reqs[0])                                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    got = [pred(r) for r in reqs]
    torch.cuda.synchronize()
    count = {k: v for k, v in kernels.LAUNCHES.items() if v}
    os.environ["MME_FLASH"] = "0"
    try:
        kernels.reset_launches()
        ref = [pred(r) for r in reqs]
        plain = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        del os.environ["MME_FLASH"]
    diff, same = served_diff(got, ref, tol)
    part = {k: v[:3] for k, v in reqs[0].items()}
    pad_diff = float(np.abs(pred(part)[1] - got[0][1][:3]).max())
    finite = all(np.isfinite(p).all() for _, p in got + ref)
    shapes_ok = all(p.shape == (n, m.classes)
                    for (_, p), (n, _) in zip(got, m.requests))
    peak = torch.cuda.max_memory_allocated() / 1e9
    with knobs_on():
        pred(reqs[0])                                   # warm-up
        kernels.reset_launches()
        fused = [pred(r) for r in reqs]
        count_f = {k: v for k, v in kernels.LAUNCHES.items() if v}
    diff_f, same_f = served_diff(fused, got, tol)
    expect = {"flash_fwd": flash * chunks}
    expect_f = {"flash_fwd": flash * chunks,
                "fused_mlp_fwd": flash * chunks}
    if n_ln:
        expect_f["layer_norm_fwd"] = n_ln * chunks
    res = {"chunks": chunks, "launches": count, "launches_plain": plain,
           "max_abs_vs_plain": diff, "predictions_agree": same,
           "padded_chunk_max_abs": pad_diff, "peak_gb": peak,
           "launches_knobs_on": count_f, "expected_knobs_on": expect_f,
           "max_abs_knobs_on_vs_off": diff_f,
           "predictions_agree_knobs_on": same_f,
           "launches_per_chunk_knobs_on": {k: v // chunks
                                           for k, v in count_f.items()}}
    if name == "VBertClassifier":
        vbert = model.net.vbert
        word = vbert.visual_bert.embeddings.word.weight
        res["tied_decoder"] = (
            vbert.decoder_weight.data_ptr() == word.data_ptr()
            and sum(p.data_ptr() == word.data_ptr()
                    for p in model.parameters()) == 1)
    res["ms_per_batch_of_8"], res["times_ms"] = median_ms(pred, reqs[0])
    with knobs_on():
        (res["ms_per_batch_of_8_knobs_on"],
         res["times_ms_knobs_on"]) = median_ms(pred, reqs[0])
    print(f"zoo {name} serve bf16: {json.dumps(res)}", flush=True)
    if not (finite and shapes_ok and count == expect and not plain
            and diff <= tol and same and pad_diff <= SERVE_TOL[torch.float32]
            and count_f == expect_f and diff_f <= tol and same_f
            and res.get("tied_decoder", True)):
        raise SystemExit(f"serving {name} failed")
    del pred, model
    torch.cuda.empty_cache()
    return res


def zoo_grads(model, batch, labels, mask, cw):
    """fp32 loss, gradient norm and launches of one training-mode pass;
    the named gradients (zero where the forward did not reach a
    parameter)."""
    params = list(model.parameters())
    kernels.reset_launches()
    loss = cross_entropy(model(batch), labels, cw, mask)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    torch.cuda.synchronize()
    return (loss.item(), global_norm_f32(grads).item(),
            {k: v for k, v in kernels.LAUNCHES.items() if v},
            dict(zip([n for n, _ in model.named_parameters()], grads)))


def zoo_train_fp32(name: str, params, card: str) -> dict:
    """fp32, no dropout or SpecAugment, batch 8: loss and gradient norm
    with K1/K2 against MME_FLASH=0. The MTL runs one step with task 0 and
    one with task 1: the other tower's gradients exactly zero, the chosen
    tower's, ``shared_layer``'s and the head's not."""
    m = ZOO_MODELS[name]
    model = zoo_model(name, params, torch.float32, quiet=True)
    model.train()
    flash = m.flash
    tasks = (0, 1) if name == "BertVideoMAEMTLShared" else (None,)
    out = {}
    for task in tasks:
        batch, labels, mask, cw = zoo_batch(name, 8, SEED + m.train_seeds[0],
                                            task)
        loss, norm, count, grads = zoo_grads(model, batch, labels, mask, cw)
        os.environ["MME_FLASH"] = "0"
        try:
            loss0, norm0, count0, _ = zoo_grads(model, batch, labels, mask,
                                                cw)
        finally:
            del os.environ["MME_FLASH"]
        res = {"batch": 8, "loss": loss, "loss_plain": loss0,
               "grad_norm": norm, "grad_norm_plain": norm0,
               "launches": count, "launches_plain": count0}
        ok = (np.isfinite(loss) and np.isfinite(norm)
              and count == {"flash_fwd": flash, "flash_bwd": flash}
              and not count0
              and abs(loss - loss0) <= TRAIN_LOSS_RTOL * abs(loss0)
              and abs(norm - norm0) <= TRAIN_NORM_RTOL * norm0)
        if task is not None:
            idle = ("net.videomae.", "net.fc_norm.") if task == 0 else \
                ("net.bert.",)
            busy = ("net.bert.",) if task == 0 else ("net.videomae.",
                                                     "net.fc_norm.")
            zero = [n for n, g in grads.items()
                    if n.startswith(idle) and g.any()]
            dead = [n for n, g in grads.items()
                    if n.startswith(busy) and "pooler" not in n
                    and not g.any()]
            shared = float(grads["net.shared_layer.weight"].norm())
            head = float(grads["net.classifier.weight"].norm())
            res.update(task=task, idle_nonzero=zero, busy_zero=dead,
                       shared_layer_grad_norm=shared,
                       classifier_grad_norm=head)
            ok = ok and not zero and not dead and shared > 0 and head > 0
        leg = "fp32" if task is None else f"fp32_task{task}"
        out[leg] = res
        print(f"zoo {name} train {leg}: {json.dumps(res)}", flush=True)
        if not ok:
            raise SystemExit(f"the fp32 training check of {name} "
                             f"({leg}) failed")
        del grads
    del model
    torch.cuda.empty_cache()
    return out


def zoo_train_bf16(name: str, params, card: str) -> dict:
    """bf16, no dropout, four steps on one batch of 8 with
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1 and both knobs on: the eval loss
    after them below the one before, every step's launches."""
    m = ZOO_MODELS[name]
    model = zoo_model(name, params, torch.bfloat16, quiet=True)
    flash, n_ln = m.flash, zoo_ln(name)
    env = {"MME_OPT_STATE": "bf16", "MME_FUSED_ADAM": "1", **KNOBS}
    os.environ.update(env)
    try:
        tx = make_optimizer(cosine_warm_restarts(FAMILY_LR, 10, 1000), 0.01,
                            1.0)
        st = TrainState.create(model.parameters(), tx, use_accum=False,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED))
        step = make_train_step(model, tx, num_classes=m.classes)
        ev = make_eval_step(model, num_classes=m.classes)
        batch, labels, mask, cw = zoo_batch(name, 8,
                                            SEED + m.train_seeds[1])
        before = ev(batch, labels, mask, cw)[0].item()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], []
        for _ in range(4):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, l, _, _ = step(st, batch, labels, mask, cw, 1.0, True, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(l.item())
            counts.append({k: v for k, v in kernels.LAUNCHES.items() if v})
        after = ev(batch, labels, mask, cw)[0].item()
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        for key in env:
            del os.environ[key]
    expect = {"flash_fwd": flash, "flash_bwd": flash,
              "fused_mlp_fwd": flash, "fused_mlp_bwd": flash,
              "adam_update": 1}
    if n_ln:
        expect.update(layer_norm_fwd=n_ln, layer_norm_bwd=n_ln)
    res = {"eval_loss_before": before, "eval_loss_after": after,
           "losses": losses, "times_ms": times,
           "ms_per_step": float(np.median(times[1:])), "peak_gb": peak,
           "launches_per_step": counts[-1],
           "expected_launches_per_step": expect}
    print(f"zoo {name} train bf16: {json.dumps(res)}", flush=True)
    if not (all(np.isfinite(losses)) and np.isfinite(after)
            and after < before and all(c == expect for c in counts)):
        raise SystemExit(f"the bf16 training leg of {name} failed")
    del model, st, step, ev
    torch.cuda.empty_cache()
    return res


def zoo_loop(name: str, params, card: str) -> dict:
    """``run_classifier`` for one epoch of 4 steps (bf16 compute,
    MME_OPT_STATE=bf16 MME_FUSED_ADAM=1, dropout and SpecAugment on) with
    MME_EXPORT_BUNDLE set; the bundle loaded with ``load_bundle`` against a
    live Predictor on its weights."""
    directory = tempfile.mkdtemp(prefix="mme_zoo_loop_")
    bundle = os.path.join(directory, "bundle")
    env = dict(LOOP_ENV, MME_EXPORT_BUNDLE=bundle,
               MME_RUN_DIR=os.path.join(directory, "run"))
    m = ZOO_MODELS[name]
    try:
        train_ds, val_ds, test_ds = (m.data(n, s) for n, s in m.loop_sizes)
        model = zoo_model(name, params, torch.bfloat16)
        cfg = ExperimentConfig(**dict(LOOP_CFG, epoch=1, log_val=4),
                               checkpoint_dir=os.path.join(directory, "ck"),
                               audio_max_samples=m.samples)
        os.environ.update(env)
        try:
            kernels.reset_launches()
            t = time.perf_counter()
            summary = run_classifier(cfg, model, train_ds, val_ds, test_ds,
                                     device="cuda")
            loop_s = time.perf_counter() - t
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        finally:
            for k in env:
                del os.environ[k]
        with open(os.path.join(env["MME_RUN_DIR"], "metrics.jsonl")) as f:
            logs = [json.loads(line) for line in f]
        losses = [d[k] for d in logs for k in ("train/loss", "val/loss",
                                               "test/loss") if k in d]
        exported = next(d for d in logs if "export_bundle" in d)
        del model
        torch.cuda.empty_cache()

        served = load_bundle(bundle, device="cuda")
        live_model = zoo_model(name, params, torch.bfloat16)
        live_model.load_state_dict(
            {k[len("model."):]: v for k, v in
             served.module.state_dict().items()}, strict=True)
        live = Predictor(live_model, batch_size=8, device="cuda")
        reqs, chunks = zoo_requests(name)
        served(reqs[0])
        live(reqs[0])                                   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = [served(r) for r in reqs]
        torch.cuda.synchronize()
        count = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = [live(r) for r in reqs]
        tol = SERVE_TOL[torch.bfloat16]
        diff, same = served_diff(got, want, tol)
        with open(os.path.join(bundle, "meta.json")) as f:
            meta_model = json.load(f)["model"]
        out = {"loop_s": loop_s, "launches": launches, "losses": losses,
               "test_loss": summary["test/loss"],
               "export_s": exported["export_s"], "save_s": exported["save_s"],
               "bundle_gb": exported["bytes"] / 1e9, "load_s": served.load_s,
               "bundle_ops": list(served.ops), "bundle_model": meta_model,
               "bundle_launches_per_chunk": {
                   k: v // chunks for k, v in count.items()},
               "bundle_vs_live_max_abs": diff, "predictions_agree": same}
        (out["bundle_ms_per_batch_of_8"],
         out["bundle_times_ms"]) = median_ms(served, reqs[0])
        del served, live, live_model
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        torch.cuda.empty_cache()
    steps = -(-m.loop_sizes[0][0] // 8)
    evals = sum(-(-n // 8) for n, _ in m.loop_sizes[1:])
    want_loop = {"flash_fwd": m.flash * (steps + evals),
                 "flash_bwd": m.flash * steps, "adam_update": steps}
    out["expected_launches"] = want_loop
    print(f"zoo {name} loop and bundle: {json.dumps(out)}", flush=True)
    if not (all(np.isfinite(losses)) and launches == want_loop
            and count == {"flash_fwd": m.flash * chunks}
            and out["bundle_ops"] == ["flash_fwd"]
            and meta_model == "BatchModel" and same and diff <= tol):
        raise SystemExit(f"{name} through run_classifier and its "
                         "bundle failed")
    return out


def zoo_model_legs(name: str, card: str) -> dict:
    """Every leg of one classifier; its JSON line; its launches of one
    served chunk with both knobs on and of one train step (the bf16 leg's
    with every knob on, or the MTL's fp32 step). Starts from what the
    earlier phases left on the card once cyclic garbage is collected
    (``baseline_gb``), so its peaks are its own."""
    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    meta, _ = zoo_net(name, torch.float32, device="meta")
    params = init_variables(meta, SEED)["params"]
    n_params = sum(p.numel() for p in meta.parameters())
    res = {"parameters": n_params, "weights_s": time.perf_counter() - t,
           "baseline_gb": torch.cuda.memory_allocated() / 1e9}
    m = ZOO_MODELS[name]
    res["serve"] = zoo_serve(name, params, card)
    res["train"] = {}
    if m.train_fp32:
        res["train"] = zoo_train_fp32(name, params, card)
    if m.train_bf16:
        res["train"]["bf16"] = zoo_train_bf16(name, params, card)
    if m.looped:
        res["loop"] = zoo_loop(name, params, card)
    del params
    torch.cuda.empty_cache()
    res["model_s"] = time.perf_counter() - t
    serve = res["serve"]
    train = res.get("train", {})
    bf16 = train.get("bf16", {})
    step = bf16.get("launches_per_step") or next(
        (leg["launches"] for leg in train.values()), {})
    print(json.dumps({"slice_model": {
        "model": name, "parameters": n_params,
        "serve_ms_per_batch_of_8": serve["ms_per_batch_of_8"],
        "serve_ms_per_batch_of_8_knobs_on":
            serve["ms_per_batch_of_8_knobs_on"],
        "train_bf16_ms_per_step": bf16.get("ms_per_step"),
        "peak_gb_serve": serve["peak_gb"],
        "peak_gb_train": bf16.get("peak_gb"),
        "launches_serve_chunk_knobs_on":
            serve["launches_per_chunk_knobs_on"],
        "launches_train_step": step,
        "max_abs_vs_plain": serve["max_abs_vs_plain"],
        "baseline_gb": res["baseline_gb"],
        "model_s": res["model_s"], "detail": res, "card": card}}),
        flush=True)
    return {"serve": serve["launches_per_chunk_knobs_on"], "step": step}


def zoo_lstm(card: str) -> dict:
    """``LSTMClassifier`` at text_nn's size (vocabulary 5 000, 300-wide
    embedding and state, one layer) over 8 x 70 tokens in fp32: a forward
    and two train steps, no kernel of the port launched."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    net, n_params = load_drawn(LSTMClassifier(LSTM_VOCAB, LSTM_DIM, LSTM_DIM,
                                              device="cuda"))
    model = BatchModel(net, ("input_ids",))
    ds = synthetic_text_dataset(LSTM_VOCAB, 8, ZOO_TEXT_LEN, 7, SEED + 140)
    batch = to_device(ds.features, "cuda")
    labels = torch.as_tensor(ds.labels, device="cuda")
    mask = torch.ones(8, dtype=torch.int32, device="cuda")
    cw = torch.ones(7, device="cuda")
    kernels.reset_launches()
    model.eval()
    with torch.no_grad():
        logits = model(batch)
    tx = make_optimizer(lambda s: 1e-3, 0.01, 1.0)
    _, _, losses, times = steps_of(model, tx, batch, labels, mask, cw, 2)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    res = {"model": "LSTMClassifier", "parameters": n_params,
           "logits_shape": list(logits.shape), "losses": losses,
           "times_ms": times, "launches": launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "model_s": time.perf_counter() - t0, "card": card}
    print(json.dumps({"slice_model": res}), flush=True)
    if not (tuple(logits.shape) == (8, 7) and not launches
            and bool(torch.isfinite(logits).all())
            and bool((logits <= 0).all()) and all(np.isfinite(losses))):
        raise SystemExit("phase 10: LSTMClassifier failed")
    del model, net
    torch.cuda.empty_cache()
    return res


def zoo_clis(card: str) -> dict:
    """text_nn (both models), text_audio_nn, text_video_nn -m 1MTL and
    visual_bert_nn on synthetic data, one epoch at batch 8 on the card, in
    a temporary directory."""
    out = {}
    cwd = os.getcwd()
    directory = tempfile.mkdtemp(prefix="mme_zoo_cli_")
    try:
        os.chdir(directory)
        for label, main_fn, extra in (
                ("text_nn", text_nn.main, []),
                ("text_nn_LSTM", text_nn.main, ["-m", "LSTM"]),
                ("text_audio_nn", text_audio_nn.main, []),
                ("text_video_nn_1MTL", text_video_nn.main, ["-m", "1MTL"]),
                ("visual_bert_nn", visual_bert_nn.main, [])):
            t = time.perf_counter()
            summary = main_fn(["--dataset", "synthetic", "-e", "1", "-b",
                               "8"] + extra)
            out[label] = {"test_loss": summary["test/loss"],
                          "s": time.perf_counter() - t}
            shutil.rmtree(os.path.join(directory, "checkpoints"),
                          ignore_errors=True)
            if not np.isfinite(summary["test/loss"]):
                raise SystemExit(f"phase 10: {label} on the card failed")
    finally:
        os.chdir(cwd)
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps({"zoo_clis": out, "card": card}), flush=True)
    return out


def zoo(card: str) -> dict:
    """Phase 10. Returns per model the launches of one served chunk with
    both knobs on and of one train step."""
    t0 = time.perf_counter()
    launches = {}
    for name in ZOO:
        launches[name] = zoo_model_legs(name, card)
        torch.cuda.empty_cache()
    zoo_lstm(card)
    zoo_clis(card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build(["flash_fwd", "flash_bwd", "fused_mlp",
                          "layer_norm", "adam_update"])
    print(f"build: {time.perf_counter() - t0:.1f} s\n{logs['flash_fwd']}\n"
          f"{logs['flash_bwd']}", flush=True)
    print(json.dumps({"fused_mlp_ptxas": ptxas_summary(logs["fused_mlp"])}),
          flush=True)
    print(json.dumps({"flash_ptxas": {name: kernel_ptxas(logs[name])
                                      for name in ("flash_fwd", "flash_bwd")}}),
          flush=True)
    print(json.dumps({"layer_norm_ptxas": kernel_ptxas(logs["layer_norm"])}),
          flush=True)
    print(json.dumps({"adam_update_ptxas": kernel_ptxas(logs["adam_update"])}),
          flush=True)

    spec = TAVSpec(output_dim=7)
    fwd_err, fwd_shapes = check_flash(card)
    bwd_err, bwd_shapes = check_flash_bwd(card)
    # the trained model shares its audio frontend: one conv stack's leaves
    train_spec = dataclasses.replace(spec, share_audio_frontend=True)
    adam_err, adam = check_adam(train_spec, card)
    ln_fwd, ln_bwd = check_layer_norm(train_spec, card)
    check_gemm_core(card)
    mlp_fwd, mlp_bwd = check_fused_mlp(train_spec, card)
    served, served_knobs = main_path(card)
    params, step, step_fused, step_knobs, step_ms = train_path(card)
    torch.cuda.empty_cache()
    front_dir = tempfile.mkdtemp(prefix="mme_front_")
    try:
        loop, exports, loop_spec = train_loop(params, card, step_ms,
                                              front_dir)
        del params
        torch.cuda.empty_cache()
        bundle = front_ends(card, loop_spec, front_dir, exports)
    finally:
        shutil.rmtree(front_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    family = fusion_family(card)
    torch.cuda.empty_cache()
    w2v = slice_models(card)
    torch.cuda.empty_cache()
    zoo_launches = zoo(card)

    def family_launches(name):
        """launches_<model> of phases 8, 9 and 10: one served chunk with
        both knobs on for a forward kernel, one bf16 train step with every
        knob on for the others (the MTL's fp32 step; 0 for a model without
        a train leg)."""
        leg = "serve" if name.endswith("_fwd") else "step"
        out = {f"launches_{m}": family[m][leg].get(name, 0) for m in FAMILY}
        out["launches_wav2vec2_base"] = w2v[leg].get(name, 0)
        out.update({f"launches_{m}": zoo_launches[m][leg].get(name, 0)
                    for m in ZOO})
        return out

    def entry(name, route, source, replaces, result):
        """A kernel of this slice: launches of one training step with both
        knobs on (and of one served chunk for a forward kernel); times and
        bound summed over those launches."""
        out = {"name": name, "route": route, "source": source,
               "replaces": replaces, "launches": step_knobs[name], **result}
        if name.endswith("_fwd"):
            out["launches_serve_chunk"] = served_knobs[name]
            out["launches_bundle_chunk"] = bundle["knobs_on"][name]
        return {**out, **family_launches(name)}

    def flash_entry(name, source, replaces, shapes, per, err, launches):
        total = {k: sum(r[k] * r[per] for r in shapes)
                 for k in ("ms", "plain_ms", "library_ms")}
        flops = sum(r["gflop"] * r[per] for r in shapes) * 1e9
        nbytes = sum(r["mbytes"] * r[per] for r in shapes) * 1e6
        # times and bound: the 54 launches of one chunk or step of 8
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, **launches,
                **total,
                "bound_ms": max(flops / PEAK_BF16_FLOPS,
                                nbytes / PEAK_BYTES) * 1e3,
                "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                             >= nbytes / PEAK_BYTES else "bytes"),
                **family_launches(name)}

    print(json.dumps({"kernels": [
        flash_entry("flash_fwd", "mme_tpu_torch/csrc/flash_fwd.cu",
                    "mme_tpu/ops/flash_attention.py:125", fwd_shapes,
                    "launches_per_chunk", fwd_err,
                    {"launches": served,
                     "launches_train_step": step["flash_fwd"],
                     "launches_train_loop": loop["flash_fwd"],
                     "launches_bundle_chunk": bundle["flash_fwd"]}),
        flash_entry("flash_bwd", "mme_tpu_torch/csrc/flash_bwd.cu",
                    "mme_tpu/ops/flash_attention.py:184", bwd_shapes,
                    "launches_per_step", bwd_err,
                    {"launches": step["flash_bwd"],
                     "launches_train_loop": loop["flash_bwd"]}),
        # times and bound: one call over every trainable leaf of one step
        {"name": "adam_update", "route": "cuda",
         "source": "mme_tpu_torch/csrc/adam_update.cu",
         "replaces": "mme_tpu/ops/adam_update.py:67",
         "launches": step_fused["adam_update"],
         "launches_train_loop": loop["adam_update"], "max_abs_err": adam_err,
         "ms": adam["all"]["ms"], "plain_ms": adam["all"]["plain_ms"],
         "library_ms": None, "bound_ms": adam["all"]["bound_ms"],
         "bound_by": adam["all"]["bound_by"],
         "kernel_ms": adam["all"]["kernels_ms"],
         "host_us": adam["all"]["host_us"], "leaves": adam["all"]["leaves"],
         "big_leaves_ms": adam["big"]["ms"],
         **family_launches("adam_update")},
        entry("layer_norm_fwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:63", ln_fwd),
        entry("layer_norm_bwd", "cuda", "mme_tpu_torch/csrc/layer_norm.cu",
              "mme_tpu/ops/layer_norm.py:73", ln_bwd),
        entry("fused_mlp_fwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:105", mlp_fwd),
        entry("fused_mlp_bwd", "cuda", "mme_tpu_torch/csrc/fused_mlp.cu",
              "mme_tpu/ops/fused_mlp.py:116", mlp_bwd)]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
