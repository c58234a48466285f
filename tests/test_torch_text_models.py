"""The port's single-modality text and video classifiers
(mme_tpu_torch/models/text.py: ``BertClassifier`` with RoBERTa and BERT
positions, ``LSTMClassifier``; models/video.py: ``VideoMAEClassifier``),
``data/glove.py``, ``synthetic_text_dataset`` and the ``text_nn`` CLI
against mme_tpu on the same inputs.

Weights: flax-layout trees drawn once per file (module fixture) by
``convert.init_variables``, whose leaf sets and shapes are held to JAX's
``model.init`` traced by ``jax.eval_shape`` (never run). JAX applies under
``jax.jit``. The token batches carry ragged masks.

Tolerances: fp32 logits within 1e-5 absolute (fp32 sums in other orders
through 2 layers); in training mode with every dropout at 0, the loss
within 1e-5 relative and every gradient leaf within 1e-5 of its largest
element; with the fused LayerNorm and MLP engaged (their plain versions on
the CPU) the logits within 1e-5 of the knobs-off logits.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.data import glove as j_glove
from mme_tpu.data import synthetic as j_synthetic
from mme_tpu.models import text as j_text
from mme_tpu.models import video as j_video
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.cli import text_nn
from mme_tpu_torch.convert import (from_flax, grads_to_flax, init_variables,
                                   to_flax)
from mme_tpu_torch.data import glove
from mme_tpu_torch.data.synthetic import synthetic_text_dataset
from mme_tpu_torch.models import text, video
from mme_tpu_torch.train.losses import cross_entropy

torch.set_num_threads(2)

ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5
P = types.SimpleNamespace(text=text, video=video)
J = types.SimpleNamespace(text=j_text, video=j_video)
B, L = 3, 9


def _small(e, quiet):
    e = dataclasses.replace(e, hidden=32, heads=4, layers=2, intermediate=64)
    if quiet:
        e = dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)
    return e


def _bert(style):
    def build(ns, quiet):
        make = (ns.text.TextEncoderSpec.distilroberta if style == "roberta"
                else ns.text.TextEncoderSpec.bert_base_cased)
        spec = make()
        spec = dataclasses.replace(spec, vocab_size=60, max_positions=24,
                                   encoder=_small(spec.encoder, quiet))
        return _new(ns, ns.text.BertClassifier, spec, 5,
                    0.0 if quiet else 0.5)
    return build


def _lstm(ns, quiet):
    return _new(ns, ns.text.LSTMClassifier, 60, 12, 10, 2, 5)


def _videomae(ns, quiet):
    spec = ns.video.VideoMAESpec.base()
    spec = dataclasses.replace(spec, image_size=32, patch_size=8,
                               num_frames=4,
                               encoder=_small(spec.encoder, quiet))
    return _new(ns, ns.video.VideoMAEClassifier, spec, 5,
                0.0 if quiet else 0.5)


def _new(ns, cls, *args):
    return cls(*args, device="cpu") if ns is P else cls(*args)


def _tokens(seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 60, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 1          # RoBERTa's pad id
    return ids, mask


def _clips(seed=2):
    return (np.random.RandomState(seed).rand(B, 4, 32, 32, 3)
            .astype(np.float32),)


# name → (build(namespace, quiet), inputs)
CASES = {
    "bert_roberta": (_bert("roberta"), _tokens),
    "bert_bert": (_bert("bert"), _tokens),
    "lstm_2_layers": (_lstm, lambda: _tokens()[:1]),
    "videomae": (_videomae, _clips),
}


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree)}


def _traced(name):
    build, inputs = CASES[name]
    return jax.eval_shape(build(J, False).init, jax.random.PRNGKey(0),
                          *[jnp.asarray(a) for a in inputs()])["params"]


@pytest.fixture(scope="module")
def weights():
    """Per case: the classifier's params drawn by ``init_variables``."""
    return {name: init_variables(build(P, False), seed=i)["params"]
            for i, (name, (build, _)) in enumerate(CASES.items())}


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def _port_loss_and_grads(model, args, labels, smask, cw):
    logits = model(*_torch(args), rng=torch.Generator().manual_seed(0))
    loss = cross_entropy(logits, torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(smask))
    return loss, torch.autograd.grad(loss, list(model.parameters()),
                                     allow_unused=True)


LABELS, SMASK = np.array([0, 3, 4]), np.array([1, 1, 0], np.int32)
CW = np.linspace(0.5, 1.5, 5).astype(np.float32)


def _port(name, params, quiet=False):
    model = CASES[name][0](P, quiet)
    model.load_state_dict(from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("name", list(CASES))
def test_tree_matches_jax_and_round_trips(weights, name):
    """``init_variables``' leaves and shapes are JAX's (the LSTM's cells
    ``OptimizedLSTMCell_<i>`` with bias-free ``ii``/``if``/``ig``/``io``),
    and ``to_flax(from_flax(p))`` gives ``p`` back."""
    params = weights[name]
    assert _shapes(params) == _shapes(_traced(name))
    back = dict(_flat(to_flax(_port(name, params))))
    for k, v in _flat(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert set(back) == set(dict(_flat(params)))


_JAX = {}


def _jax_run(name, params, args):
    """JAX's eval logits (deterministic) and, in training mode with every
    dropout at 0, its loss and gradients: one program per model class and
    input shapes, compiled once."""
    if name not in _JAX:
        jm = CASES[name][0](J, True)

        def objective(p, a):
            logits = jm.apply({"params": p}, *a, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1)})
            return j_cross_entropy(logits, jnp.asarray(LABELS),
                                   jnp.asarray(CW), jnp.asarray(SMASK))

        _JAX[name] = jax.jit(lambda p, a: (jm.apply({"params": p}, *a),
                                          *jax.value_and_grad(objective)(
                                              p, a)))
    return _JAX[name](params, [jnp.asarray(a) for a in args])


@pytest.mark.parametrize("name", list(CASES))
def test_eval_matches_jax(weights, name):
    params, args = weights[name], CASES[name][1]()
    want = _jax_run(name, params, args)[0]
    model = _port(name, params).eval()
    with torch.no_grad():
        got = model(*_torch(args))
    assert got.shape == (B, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_jax(weights, name):
    """Training mode with every dropout rate 0: the class-weighted loss and
    every gradient leaf (the LSTM's stacked kernels back to their gates,
    the BERT pooler's)."""
    params, args = weights[name], CASES[name][1]()
    _, j_loss, j_grads = _jax_run(name, params, args)
    model = _port(name, params, quiet=True).train()
    loss, grads = _port_loss_and_grads(model, args, LABELS, SMASK, CW)
    assert abs(loss.item() - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    want = dict(_flat(j_grads))
    got = dict(_flat(grads_to_flax(model, grads)))
    assert set(got) == set(want)
    for k, g in got.items():
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("name", ["bert_roberta", "videomae"])
def test_fused_paths_match_plain(weights, name, monkeypatch):
    """``MME_FUSED_LN`` and ``MME_FUSED_MLP`` engaged (their plain versions
    on the CPU, ``interpret``) against the knobs off."""
    model = _port(name, weights[name]).eval()
    args = _torch(CASES[name][1]())
    with torch.no_grad():
        off = model(*args)
        monkeypatch.setenv("MME_FUSED_LN", "interpret")
        monkeypatch.setenv("MME_FUSED_MLP", "interpret")
        on = model(*args)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=ATOL)


def test_text_spec_defaults_match_jax():
    """``distilroberta()`` and ``bert_base_cased()`` hold JAX's values field
    by field (dtypes not compared; the port's encoder spec has no parallel
    or scan fields)."""
    for make in ("distilroberta", "bert_base_cased"):
        got = dataclasses.asdict(getattr(text.TextEncoderSpec, make)())
        want = dataclasses.asdict(getattr(j_text.TextEncoderSpec, make)())
        enc, want_enc = got.pop("encoder"), want.pop("encoder")
        assert got == want
        for k, v in enc.items():
            if k != "dtype":
                assert v == want_enc[k], k


def test_synthetic_text_dataset_matches_jax():
    for vocab, n, length, k, seed in ((512, 9, 70, 7, 0), (101, 4, 12, 3, 5)):
        a = synthetic_text_dataset(vocab, n, length, k, seed)
        b = j_synthetic.synthetic_text_dataset(vocab, n, length, k, seed)
        assert set(a.features) == set(b.features)
        for key in a.features:
            np.testing.assert_array_equal(a.features[key], b.features[key])
            assert a.features[key].dtype == b.features[key].dtype
        np.testing.assert_array_equal(a.labels, b.labels)


def _glove_file(path, words=12, dim=10):
    rng = np.random.RandomState(0)
    lines = ["header 3"]            # a .vec header line, skipped
    for i in range(words):
        lines.append(" ".join([f"w{i}"] + [f"{x:.5f}" for x in
                                           rng.randn(dim)]))
    lines.append(" ".join(["w3"] + ["0.5"] * dim))   # a repeated word
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def test_glove_loading_matches_jax(tmp_path):
    """``load_glove_txt`` (whole file and ``max_words``) and
    ``tokenize_with_vocab`` equal JAX's; ``set_embedding_table`` lands in
    the LSTM's table and refuses a table of another shape."""
    path = _glove_file(tmp_path / "glove.txt")
    for max_words in (None, 5):
        vocab, table = glove.load_glove_txt(path, max_words)
        j_vocab, j_table = j_glove.load_glove_txt(path, max_words)
        assert vocab == j_vocab
        np.testing.assert_array_equal(table, j_table)
    texts = ["W1 w2 nope w3", "", "w0 " * 20]
    np.testing.assert_array_equal(
        glove.tokenize_with_vocab(texts, vocab, 8),
        j_glove.tokenize_with_vocab(texts, j_vocab, 8))
    model = text.LSTMClassifier(table.shape[0], table.shape[1], 6,
                                device="cpu")
    assert glove.set_embedding_table(model, table) is model
    np.testing.assert_array_equal(model.embedding.weight.detach().numpy(),
                                  table)
    with pytest.raises(ValueError, match="shape"):
        glove.set_embedding_table(model, table[:-1])


def test_lstm_names_and_stacked_weights():
    """The cells are ``OptimizedLSTMCell_<i>`` with the eight flax gate
    modules (``if`` registered by name); the stacked [4H, in] weights take
    the gates in i, f, g, o order with a zero input bias."""
    model = text.LSTMClassifier(20, 6, 4, 2, 3, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    for i in range(2):
        cell = f"OptimizedLSTMCell_{i}"
        for g in "ifgo":
            assert f"{cell}.i{g}.weight" in names
            assert f"{cell}.i{g}.bias" not in names
            assert {f"{cell}.h{g}.weight", f"{cell}.h{g}.bias"} <= names
    cell = model.OptimizedLSTMCell_1
    w_ih, w_hh, b_ih, b_hh = cell.stacked()
    assert w_ih.shape == (16, 4) and w_hh.shape == (16, 4)
    assert torch.equal(w_ih[4:8], getattr(cell, "if").weight)
    assert torch.equal(b_hh[8:12], cell.hg.bias)
    assert not b_ih.any()


def test_text_cli_bert_runs_on_cpu(tmp_path, monkeypatch):
    """``text_nn.main`` with the tiny BERT model for one synthetic epoch:
    a finite test loss over the 32 test records."""
    monkeypatch.chdir(tmp_path)
    summary = text_nn.main(["--dataset", "synthetic", "-e", "1", "-b", "32",
                            "-l", "1e-4"], device="cpu")
    assert np.isfinite(summary["test/loss"])
    assert np.array(summary["test/confusion_matrix"]).sum() == 32
    assert (tmp_path / "checkpoints" / "best_meta.json").exists()


def test_text_cli_lstm_with_glove_runs_on_cpu(tmp_path, monkeypatch):
    """``text_nn.main(-m LSTM)`` with ``MME_GLOVE``: the file's vocabulary
    and vectors size the model, and one synthetic epoch trains."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MME_GLOVE", _glove_file(tmp_path / "g.txt",
                                                words=30, dim=12))
    monkeypatch.setenv("MME_GLOVE_MAX", "20")
    summary = text_nn.main(["--dataset", "synthetic", "-m", "LSTM", "-e",
                            "1", "-b", "64", "-l", "1e-3"], device="cpu")
    assert np.isfinite(summary["test/loss"])
    assert np.array(summary["test/confusion_matrix"]).sum() == 32


def test_text_cli_refusals(tmp_path, monkeypatch):
    """What the port lacks raises before any work: a pickle (ROADMAP
    Queue 1 item 3), and ``MME_PRETRAINED`` with the full-size BERT model
    (item 6); a missing pickle raises ``FileNotFoundError``. The LSTM loads
    no pretrained weights in JAX, and is not refused for them."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "meld.pkl").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 3"):
        text_nn.main(["--dataset", "meld.pkl"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        text_nn.main(["--dataset", "meld.pkl", "-m", "LSTM"], device="cpu")
    with pytest.raises(FileNotFoundError):
        text_nn.main(["--dataset", "missing"], device="cpu")
    monkeypatch.setenv("MME_PRETRAINED", str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 6"):
        text_nn.main(["--dataset", "meld.pkl"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        text_nn.main(["--dataset", "meld.pkl", "-m", "LSTM"], device="cpu")
    monkeypatch.setenv("MME_TINY", "1")
    with pytest.raises(NotImplementedError, match="item 3"):
        text_nn.main(["--dataset", "meld.pkl"], device="cpu")
