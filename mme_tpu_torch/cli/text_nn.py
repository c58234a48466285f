"""Text classifier entry point: ``-m LSTM`` → the GloVe-LSTM; any other
name → the DistilRoBERTa-architecture ``BertClassifier``.

Port of ``mme_tpu/cli/text_nn.py``. The LSTM has a 5 000-word vocabulary
and 300-wide embeddings, or, with ``MME_GLOVE`` naming a GloVe text file,
the file's vocabulary (``MME_GLOVE_MAX`` words, default 50 000) and vectors
loaded into its table. The BERT model is the full DistilRoBERTa unless
``--dataset synthetic`` or ``MME_TINY`` shrink it (vocabulary 512, a
2-layer 64-wide encoder). ``--dataset synthetic`` trains on 256 / 32 / 32
generated records of ``text_max_len`` tokens; ``--dataset <name>.pkl`` on a
pickled frame of the records contract (``data/records.py``), tokenized by
the GloVe vocabulary with ``MME_GLOVE``, else by the hash tokenizer for a
vocabulary other than 50 265, else by a tokenizer from local files (the
hash tokenizer with a loud warning when none resolves). Runs on the
card::

    python -m mme_tpu_torch.cli.text_nn --dataset synthetic -e 1 -b 8
    python -m mme_tpu_torch.cli.text_nn --dataset synthetic -m LSTM -e 1 -b 8

and on the CPU only through ``main(argv, device="cpu")``. Weights are drawn
from ``--seed`` (``convert.init_variables``); for the BERT model with the
full 50 265-word vocabulary, ``MME_PRETRAINED`` naming a directory that
holds j-hartmann/emotion-english-distilroberta-base loads its encoder
into the ``bert`` tower (``models/pretrained.py::load_text_classifier``;
the head stays drawn), as JAX does. A missing pickle raises
``FileNotFoundError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mme_tpu_torch.cli.common import (BatchModel, pickle_splits,
                                      resolve_pickle, run_classifier)
from mme_tpu_torch.config import arg_parse, config_from_args
from mme_tpu_torch.convert import from_flax, init_variables
from mme_tpu_torch.data.glove import (load_glove_txt, set_embedding_table,
                                      tokenize_with_vocab)
from mme_tpu_torch.data.records import (PickleDatasetConfig,
                                        build_text_dataset, get_tokenizer)
from mme_tpu_torch.data.synthetic import synthetic_text_dataset
from mme_tpu_torch.device import DeviceLike, resolve_device
from mme_tpu_torch.models.pretrained import (TEXT_EMOTION,
                                             load_text_classifier,
                                             pretrained_root)
from mme_tpu_torch.models.text import (BertClassifier, LSTMClassifier,
                                       TextEncoderSpec)


def load_weights(net, spec: TextEncoderSpec, seed: int) -> None:
    """Load ``net`` with weights drawn from ``seed``; for a
    ``BertClassifier`` with the full vocabulary and ``MME_PRETRAINED``
    naming a directory, its ``bert`` tower from the checkpoint found there
    (JAX's gate, ``mme_tpu/cli/text_nn.py``)."""
    variables = init_variables(net, seed)
    root = pretrained_root()
    if root and isinstance(net, BertClassifier) and spec.vocab_size == 50265:
        variables["params"], ok = load_text_classifier(variables["params"],
                                                       spec, root)
        if ok:
            print(f"loaded pretrained text tower from {root} "
                  f"({TEXT_EMOTION})", flush=True)
    net.load_state_dict(from_flax(**variables), strict=True)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    args = arg_parse("text_nn", argv)
    cfg = config_from_args(args, device=device)
    np.random.seed(cfg.seed)

    lstm = cfg.model.lower() == "lstm"
    spec = TextEncoderSpec.distilroberta()
    if not lstm and (cfg.dataset == "synthetic" or os.environ.get("MME_TINY")):
        spec = dataclasses.replace(
            spec, vocab_size=512,
            encoder=dataclasses.replace(spec.encoder, hidden=64, heads=4,
                                        layers=2, intermediate=128))
    pkl = resolve_pickle(cfg.dataset)

    gvocab, table = None, None
    if lstm:
        vocab, embed_dim = 5000, 300
        glove_path = os.environ.get("MME_GLOVE")
        if glove_path and os.path.exists(glove_path):
            gvocab, table = load_glove_txt(
                glove_path, int(os.environ.get("MME_GLOVE_MAX", "50000")))
            vocab, embed_dim = table.shape
        net = LSTMClassifier(vocab, embed_dim, num_layers=cfg.lstm_layers,
                             output_dim=cfg.output_dim, device=dev)
        inputs = ("input_ids",)
    else:
        vocab = spec.vocab_size
        net = BertClassifier(spec, cfg.output_dim, cfg.dropout, device=dev)
        inputs = ("input_ids", "text_mask")
    load_weights(net, spec, cfg.seed)
    if table is not None:
        set_embedding_table(net, table)
        print(f"loaded GloVe vectors {table.shape} into LSTM embedding",
              flush=True)

    if pkl is not None:
        if gvocab is not None:
            def tok(text, max_length=70):
                ids = tokenize_with_vocab([text], gvocab, max_length)[0]
                return ids.tolist(), (ids != 0).astype(int).tolist()
        else:
            # the hash tokenizer must match the model's (maybe reduced) vocab
            tok = get_tokenizer(
                None if vocab != 50265 else
                "j-hartmann/emotion-english-distilroberta-base", vocab)
        rcfg = PickleDatasetConfig(label_col=cfg.label_task,
                                   text_max_len=cfg.text_max_len,
                                   seed=cfg.seed)
        train_ds, val_ds, test_ds, id2label = pickle_splits(
            pkl, rcfg, lambda x: build_text_dataset(x, rcfg, tok))
    else:
        id2label = None
        mk = lambda n, s: synthetic_text_dataset(
            vocab, n, text_len=cfg.text_max_len, num_classes=cfg.output_dim,
            seed=s)
        train_ds, val_ds, test_ds = mk(256, 0), mk(32, 1), mk(32, 2)
    return run_classifier(cfg, BatchModel(net, inputs), train_ds, val_ds,
                          test_ds, id2label=id2label, device=dev)


if __name__ == "__main__":
    main()
