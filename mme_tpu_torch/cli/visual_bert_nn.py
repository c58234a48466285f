"""VisualBERT entry point: Hateful-Memes text+image classification through
the MLM logits head (``VBertClassifier``).

Port of ``mme_tpu/cli/visual_bert_nn.py``. ``-y 7`` (the flag's default)
becomes 2 classes: Hateful Memes is binary. The visual features are one
``visual_embedding_dim`` vector per record (ResNet-50 fc→1024 features,
precomputed). ``--dataset synthetic`` shrinks the model (vocabulary 128,
16-wide visual vectors, a 2-layer 32-wide encoder) over 12 tokens and 64
training records; any other name runs the full VisualBERT at
``text_max_len`` tokens on 6 750 synthetic training records, as in JAX.
Runs on the card::

    python -m mme_tpu_torch.cli.visual_bert_nn --dataset synthetic -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import BatchModel, run_classifier
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.dataset import ArrayDataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.visualbert import VBertClassifier, VisualBertSpec

INPUTS = ("input_ids", "text_mask", "token_type_ids", "visual_embeds")


def synthetic_vbert(n: int, text_len: int, vdim: int, vocab: int,
                    num_classes: int, seed: int) -> ArrayDataset:
    """Token ids with the label planted at 1..2, all-ones masks, zero
    token types and one visual vector shifted by the label (JAX's
    ``_synthetic_vbert``, the same arrays)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    ids = rng.randint(5, vocab, size=(n, text_len))
    ids[:, 1:3] = labels[:, None] + 5
    feats = rng.randn(n, 1, vdim).astype(np.float32)
    feats += labels[:, None, None]
    return ArrayDataset({
        "input_ids": ids.astype(np.int32),
        "text_mask": np.ones((n, text_len), np.int32),
        "token_type_ids": np.zeros((n, text_len), np.int32),
        "visual_embeds": feats,
    }, labels.astype(np.int64))


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("visual_bert_nn", argv)
    cfg = config_from_args(args)
    if cfg.output_dim == 7:
        cfg = cfg.replace(output_dim=2)   # Hateful Memes is binary
    np.random.seed(cfg.seed)

    spec = VisualBertSpec()
    text_len = cfg.text_max_len
    synthetic = cfg.dataset == "synthetic"
    if synthetic:
        spec = dataclasses.replace(
            spec, vocab_size=128, visual_embedding_dim=16,
            encoder=dataclasses.replace(spec.encoder, hidden=32, heads=4,
                                        layers=2, intermediate=64))
        text_len = 12
    net = VBertClassifier(spec, cfg.output_dim, cfg.dropout, device=dev)
    net.load_state_dict(from_flax(**init_variables(net, cfg.seed)),
                        strict=True)
    n_train = 64 if synthetic else 6750
    mk = lambda n, s: synthetic_vbert(n, text_len, spec.visual_embedding_dim,
                                      spec.vocab_size, cfg.output_dim, s)
    train_ds, val_ds, test_ds = mk(n_train, 0), mk(16, 1), mk(16, 2)
    return run_classifier(cfg, BatchModel(net, INPUTS), train_ds, val_ds,
                          test_ds, device=dev)


if __name__ == "__main__":
    main()
