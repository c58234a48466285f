"""``BertVideoMAELateFusion``: the text+video late-fusion classifier, as
the benchmark measures and checks it.

- The plain float32 reference: the late-fusion BERT ⊕ VideoMAE classifier
  of github.com/g8a9/multi-modal-emotion (``DoubleModels``), over the
  shared DistilRoBERTa-base and VideoMAE-base towers of
  ``reference/towers.py``; the video tower runs every patch.
- Its FLOPs and attention calls (``flops.py``'s arithmetic).
- The program: ``cli/text_video_nn.py``'s model in ``cli/common.BatchModel``
  and the optimizer, state and step ``cli/common.run_classifier`` builds
  (``train/steps.py``). It computes in float32, as its CLI runs it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import flops
from harness import program
from reference.layers import LayerNorm, Linear
from reference.towers import TextEncoder, VideoMAE, normalize_video


class TextVideo(nn.Module):
    """Late fusion: the tanh-pooled text token ⊕ LayerNorm(eps 1e-6) of the
    mean of all VideoMAE tokens, then one classifier."""

    def __init__(self, c: dict, device=None):
        super().__init__()
        self.bert = TextEncoder(c["text"], device)
        self.videomae = VideoMAE(c["video"], device=device)
        h_v = c["video"]["encoder"]["hidden"]
        self.fc_norm = LayerNorm(h_v, 1e-6, device)
        self.classifier = Linear(c["text"]["encoder"]["hidden"] + h_v,
                                 c["output_dim"], device=device)

    def forward(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        pooled = self.bert(b["input_ids"].long(), b["text_mask"])
        vid = self.fc_norm(self.videomae(normalize_video(b["video"]))
                           .mean(dim=1))
        return self.classifier(torch.cat([pooled, vid], dim=1))



def reference(c: dict, device=None) -> nn.Module:
    return TextVideo(c, device=device)


# FLOPs


def forward_flops(c: dict, batch: int) -> int:
    v = c["video"]
    head = flops.linear(batch, c["text"]["encoder"]["hidden"]
                        + v["encoder"]["hidden"], c["output_dim"])
    return (flops.text_tower(c, batch, c["inputs"]["text_len"])
            + flops.video_tower(v, batch, flops.num_patches(v)) + head)


def attention_sites(c: dict, batch: int):
    return (flops.encoder_sites(c["text"]["encoder"], batch,
                                c["inputs"]["text_len"], True)
            + flops.encoder_sites(c["video"]["encoder"], batch,
                                  flops.num_patches(c["video"]), False))


# the program


def spec(c: dict):
    from mme_tpu_torch.models.text_video import TextVideoSpec
    if program.compute_dtype(c) != torch.float32:
        raise ValueError("the text+video model has no compute-dtype switch")
    return TextVideoSpec(text=program.text_spec(c["text"]),
                         video=program.video_spec(c["video"]),
                         hidden=c["hidden"], output_dim=c["output_dim"],
                         dropout=c["head_dropout"])


def transform(c: dict):
    """The CLI feeds the batch as it is."""
    return None


def port(c: dict, device, weights=None) -> nn.Module:
    """The program's model as the CLI wraps it (``BatchModel``: the batch
    dict in, its parameters under ``net.``), with ``weights`` (the
    reference's names) loaded where given."""
    from mme_tpu_torch.cli.common import BatchModel
    from mme_tpu_torch.cli.text_video_nn import INPUTS
    from mme_tpu_torch.models.text_video import BertVideoMAELateFusion
    net = BertVideoMAELateFusion(spec(c), device=device)
    if weights is not None:
        net.load_state_dict(weights, strict=True)
    return BatchModel(net, INPUTS)


def build_trainer(c: dict, weights, flat, seed: int, batch: int,
                  device) -> program.Trainer:
    program.clean_env(c)
    from mme_tpu_torch.train.losses import make_loss_fn
    from mme_tpu_torch.train.schedules import cosine_warm_restarts
    from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                           make_train_step, model_buffers)
    cfg = program.experiment(c, seed, batch)
    model = port(c, device, weights)
    tx = make_optimizer(
        cosine_warm_restarts(cfg.learning_rate, cfg.T_max,
                             c["optimizer"]["steps_per_epoch"]),
        cfg.weight_decay, cfg.clip, None, factored_views=None)
    state = TrainState.create(
        model.parameters(), tx, use_accum=False,
        generator=torch.Generator(device=device).manual_seed(seed),
        names=[n for n, _ in model.named_parameters()],
        buffers=model_buffers(model))
    step = make_train_step(model, tx, num_classes=cfg.output_dim,
                           loss_fn=make_loss_fn(cfg.loss, cfg.beta))
    names = program.checked_names(
        [n.removeprefix("net.") for n, _ in model.named_parameters()],
        weights)
    return program.Trainer(model, state, step, transform(c), names,
                           c["optimizer"]["b1"])
