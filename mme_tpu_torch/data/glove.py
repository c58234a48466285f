"""GloVe embedding loading without torchtext.

Port of ``mme_tpu/data/glove.py`` (the port keeps its own copy): a
plain-text ``.txt``/``.vec`` reader giving (vocab dict, [V, D] matrix),
whitespace tokenization against that vocab, and an initializer that drops
the vectors into ``LSTMClassifier``'s embedding table. Works with any
locally available GloVe release; with none, the LSTM trains from its drawn
weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

PAD, UNK = "<pad>", "<unk>"


def load_glove_txt(path: str, max_words: Optional[int] = None
                   ) -> Tuple[Dict[str, int], np.ndarray]:
    """Read 'word v1 v2 ...' lines → (word→id, [V, D] float32). Ids 0/1 are
    reserved for pad (zeros) and unk (mean vector)."""
    words: List[str] = []
    vecs: List[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 10:
                continue  # header line of .vec files
            words.append(parts[0])
            vecs.append(np.asarray(parts[1:], np.float32))
            if max_words and len(words) >= max_words:
                break
    mat = np.stack(vecs)
    vocab = {PAD: 0, UNK: 1}
    for w in words:
        vocab.setdefault(w, len(vocab))
    full = np.zeros((len(vocab), mat.shape[1]), np.float32)
    full[1] = mat.mean(axis=0)
    full[2:] = mat[: len(vocab) - 2]
    return vocab, full


def tokenize_with_vocab(texts: Sequence[str], vocab: Dict[str, int],
                        max_len: int) -> np.ndarray:
    """Whitespace tokenization against a GloVe vocab, padded/truncated."""
    out = np.zeros((len(texts), max_len), np.int32)
    unk = vocab[UNK]
    for i, t in enumerate(texts):
        ids = [vocab.get(w, unk) for w in str(t).lower().split()[:max_len]]
        out[i, :len(ids)] = ids
    return out


def set_embedding_table(model: nn.Module, table: np.ndarray,
                        name: str = "embedding.weight") -> nn.Module:
    """Copy the GloVe vectors into ``model``'s table ``name`` (in place;
    shape-checked: the vocab must match the model's ``vocab_size``) and
    return the model."""
    param = model.get_parameter(name)
    if tuple(param.shape) != tuple(table.shape):
        raise ValueError(f"{name}: table {table.shape} for a parameter of "
                         f"shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.asarray(table, np.float32)))
    return model
