"""Text classifier entry point: ``-m LSTM`` → the GloVe-LSTM; any other
name → the DistilRoBERTa-architecture ``BertClassifier``.

Port of ``mme_tpu/cli/text_nn.py``. The LSTM has a 5 000-word vocabulary
and 300-wide embeddings, or, with ``MME_GLOVE`` naming a GloVe text file,
the file's vocabulary (``MME_GLOVE_MAX`` words, default 50 000) and vectors
loaded into its table. The BERT model is the full DistilRoBERTa unless
``--dataset synthetic`` or ``MME_TINY`` shrink it (vocabulary 512, a
2-layer 64-wide encoder). ``--dataset synthetic`` trains on 256 / 32 / 32
generated records of ``text_max_len`` tokens. Runs on the card::

    python -m mme_tpu_torch.cli.text_nn --dataset synthetic -e 1 -b 8
    python -m mme_tpu_torch.cli.text_nn --dataset synthetic -m LSTM -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``). What the port lacks raises
``NotImplementedError`` before any work: ``MME_PRETRAINED`` with the
full-size BERT model (JAX loads the pretrained text tower there; ROADMAP
Queue 1 item 6) and a pickle dataset (item 3). A missing pickle raises
``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import BatchModel, resolve_pickle, run_classifier
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.glove import load_glove_txt, set_embedding_table
from mme_tpu_torch.data.synthetic import synthetic_text_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.text import (BertClassifier, LSTMClassifier,
                                       TextEncoderSpec)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("text_nn", argv)
    cfg = config_from_args(args)
    np.random.seed(cfg.seed)

    lstm = cfg.model.lower() == "lstm"
    spec = TextEncoderSpec.distilroberta()
    if not lstm and (cfg.dataset == "synthetic" or os.environ.get("MME_TINY")):
        spec = dataclasses.replace(
            spec, vocab_size=512,
            encoder=dataclasses.replace(spec.encoder, hidden=64, heads=4,
                                        layers=2, intermediate=128))
    if (not lstm and os.environ.get("MME_PRETRAINED")
            and spec.vocab_size == 50265):
        raise NotImplementedError("MME_PRETRAINED needs the pretrained-weight "
                                  "import (ROADMAP Queue 1 item 6)")
    pkl = resolve_pickle(cfg.dataset)
    if pkl is not None:
        raise NotImplementedError(
            f"dataset pickle {pkl!r}: reading records (data/records.py) and "
            "tokenizing them are not ported yet (ROADMAP Queue 1 item 3); "
            "use --dataset synthetic")

    if lstm:
        vocab, embed_dim, table = 5000, 300, None
        glove_path = os.environ.get("MME_GLOVE")
        if glove_path and os.path.exists(glove_path):
            _, table = load_glove_txt(
                glove_path, int(os.environ.get("MME_GLOVE_MAX", "50000")))
            vocab, embed_dim = table.shape
        net = LSTMClassifier(vocab, embed_dim, num_layers=cfg.lstm_layers,
                             output_dim=cfg.output_dim, device=dev)
        inputs = ("input_ids",)
    else:
        vocab, table = spec.vocab_size, None
        net = BertClassifier(spec, cfg.output_dim, cfg.dropout, device=dev)
        inputs = ("input_ids", "text_mask")
    net.load_state_dict(from_flax(**init_variables(net, cfg.seed)),
                        strict=True)
    if table is not None:
        set_embedding_table(net, table)
        print(f"loaded GloVe vectors {table.shape} into LSTM embedding",
              flush=True)

    mk = lambda n, s: synthetic_text_dataset(
        vocab, n, text_len=cfg.text_max_len, num_classes=cfg.output_dim,
        seed=s)
    train_ds, val_ds, test_ds = mk(256, 0), mk(32, 1), mk(32, 2)
    return run_classifier(cfg, BatchModel(net, inputs), train_ds, val_ds,
                          test_ds, device=dev)


if __name__ == "__main__":
    main()
