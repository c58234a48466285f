"""The port's two-modality classifiers (mme_tpu_torch/models/text_audio.py:
``BertAudioClassifier``; models/text_video.py: the shared-layer
``BertVideoMAEMTLShared`` and ``BertVideoMAELateFusion``;
models/visualbert.py: ``VBertClassifier``), their synthetic data, their
CLIs (``text_audio_nn``, ``text_video_nn``, ``visual_bert_nn``) and
``time_layer_norm.classifier_ln_sites`` against mme_tpu on the same
inputs.

Weights: flax-layout trees drawn once per file (module fixture) by
``convert.init_variables``, whose leaf sets and shapes are held to JAX's
``model.init`` traced by ``jax.eval_shape`` (never run). JAX applies under
``jax.jit``. The batches carry ragged text and audio masks; the MTL model
runs with a 0-d task 0, a 0-d task 1 and a per-row [B] task vector. JAX
takes the MTL's task as a [B] vector in all three cases (a 0-d task is
broadcast to every row, which is what JAX's select does with one), so one
program serves them. ``BertAudioClassifier`` runs with an audio tower
narrower than the text tower, so ``aud_proj`` is in the tree and on the
path; the equal-width tree (no ``aud_proj``) is held to JAX's leaf set.

Tolerances: fp32 logits within 1e-5 absolute (fp32 sums in other orders
through 2 layers); in training mode with every dropout at 0 and SpecAugment
off, the loss within 1e-5 relative and every gradient leaf within 1e-5 of
its largest element (the tied word table, ``shared_layer`` and the unused
VisualBERT pooler included); with the fused LayerNorm and MLP engaged
(their plain versions on the CPU) the logits within 1e-5 of the knobs-off
logits. The MTL's task select makes the other tower's gradients exactly
zero, which is held exactly.
"""

import dataclasses
import json
import types
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.cli import text_audio_nn as j_text_audio_nn
from mme_tpu.cli import text_video_nn as j_text_video_nn
from mme_tpu.cli import visual_bert_nn as j_visual_bert_nn
from mme_tpu.models import text_audio as j_text_audio
from mme_tpu.models import text_video as j_text_video
from mme_tpu.models import visualbert as j_visualbert
from mme_tpu.serve import Predictor as JPredictor
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.cli import text_audio_nn, text_video_nn, visual_bert_nn
from mme_tpu_torch.cli.common import BatchModel
from mme_tpu_torch.convert import (from_flax, grads_to_flax, init_variables,
                                   to_flax)
from mme_tpu_torch.models import (audio, text, text_audio, text_video,
                                   video, visualbert)
from mme_tpu_torch.ops import layer_norm
from mme_tpu_torch.time_layer_norm import classifier_ln_sites
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                       make_train_step)

torch.set_num_threads(2)

ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5
P = types.SimpleNamespace(text_audio=text_audio, text_video=text_video,
                          visualbert=visualbert)
J = types.SimpleNamespace(text_audio=j_text_audio, text_video=j_text_video,
                          visualbert=j_visualbert)
B, L, T = 3, 9, 2000


def _new(ns, cls, *args):
    return cls(*args, device="cpu") if ns is P else cls(*args)


def _quiet_enc(e):
    return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)


def _ta_spec(ns, quiet, audio_hidden=None):
    s = ns.text_audio.TextAudioSpec(output_dim=5,
                                    dropout=0.0 if quiet else 0.5).tiny()
    if audio_hidden:
        s = dataclasses.replace(s, audio=dataclasses.replace(
            s.audio, encoder=dataclasses.replace(s.audio.encoder,
                                                 hidden=audio_hidden)))
    if quiet:
        s = dataclasses.replace(
            s, text=dataclasses.replace(s.text,
                                        encoder=_quiet_enc(s.text.encoder)),
            audio=dataclasses.replace(s.audio, mask_time_prob=0.0,
                                      mask_feature_prob=0.0,
                                      encoder=_quiet_enc(s.audio.encoder)))
    return s


def _tv_spec(ns, quiet):
    s = ns.text_video.TextVideoSpec(output_dim=5,
                                    dropout=0.0 if quiet else 0.5).tiny()
    if quiet:
        s = dataclasses.replace(
            s, text=dataclasses.replace(s.text,
                                        encoder=_quiet_enc(s.text.encoder)),
            video=dataclasses.replace(s.video,
                                      encoder=_quiet_enc(s.video.encoder)))
    return s


def _vb_spec(ns):
    s = ns.visualbert.VisualBertSpec()
    return dataclasses.replace(
        s, vocab_size=128, visual_embedding_dim=16,
        encoder=dataclasses.replace(s.encoder, hidden=32, heads=4, layers=2,
                                    intermediate=64))


def _tokens(vocab=100, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 1          # RoBERTa's pad id
    return ids, mask


def _audio(seed=3):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 1500:] = 0
    mask[2, 700:] = 0
    return (rng.randn(B, T).astype(np.float32) * mask), mask


def _clips(seed=2):
    return np.random.RandomState(seed).rand(B, 4, 32, 32, 3).astype(
        np.float32)


def _ta_inputs():
    return _tokens() + _audio()


def _tv_inputs(task):
    return lambda: _tokens() + (_clips(), np.asarray(task, np.int32))


def _vb_inputs():
    ids, mask = _tokens(vocab=128)
    feats = np.random.RandomState(4).randn(B, 1, 16).astype(np.float32)
    return ids, mask, np.array([[0] * L, [1] * L, [0] * L], np.int32), feats


# name → (build(namespace, quiet), inputs)
CASES = {
    "bert_audio": (lambda ns, q: _new(ns, ns.text_audio.BertAudioClassifier,
                                      _ta_spec(ns, q, 16)), _ta_inputs),
    "mtl_task0": (lambda ns, q: _new(ns, ns.text_video.BertVideoMAEMTLShared,
                                     _tv_spec(ns, q)), _tv_inputs(0)),
    "mtl_task1": (lambda ns, q: _new(ns, ns.text_video.BertVideoMAEMTLShared,
                                     _tv_spec(ns, q)), _tv_inputs(1)),
    "mtl_rows": (lambda ns, q: _new(ns, ns.text_video.BertVideoMAEMTLShared,
                                    _tv_spec(ns, q)), _tv_inputs([1, 0, 1])),
    "late_fusion": (lambda ns, q: _new(
        ns, ns.text_video.BertVideoMAELateFusion, _tv_spec(ns, q)),
        lambda: _tv_inputs(0)()[:3]),
    "vbert": (lambda ns, q: _new(ns, ns.visualbert.VBertClassifier,
                                 _vb_spec(ns), 5, 0.0 if q else 0.5),
              _vb_inputs),
}
# one set of weights per model class
WEIGHTS = {"mtl_task1": "mtl_task0", "mtl_rows": "mtl_task0"}
# trees held to JAX's beside those of CASES: the towers of equal width
TREES = {"bert_audio_same_width": (
    lambda ns, q: _new(ns, ns.text_audio.BertAudioClassifier,
                       _ta_spec(ns, q)), _ta_inputs)}


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree)}


@pytest.fixture(scope="module")
def weights():
    """Per model: the classifier's params drawn by ``init_variables``."""
    return {name: init_variables(build(P, False), seed=i)["params"]
            for i, (name, (build, _)) in enumerate(CASES.items())
            if name not in WEIGHTS}


def _params(weights, name):
    return weights[WEIGHTS.get(name, name)]


def _port(name, params, quiet=False):
    model = CASES[name][0](P, quiet)
    model.load_state_dict(from_flax(params), strict=True)
    return model


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


@pytest.mark.parametrize("name", [n for n in CASES if n not in WEIGHTS]
                         + list(TREES))
def test_tree_matches_jax_and_round_trips(weights, name):
    """``init_variables``' leaves and shapes are JAX's: the tied word table
    and ``shared_layer`` once each, ``aud_proj`` only where the widths
    differ; ``to_flax(from_flax(p))`` gives ``p`` back."""
    build, inputs = {**CASES, **TREES}[name]
    port = build(P, False)
    params = weights[name] if name in weights else init_variables(
        port, seed=9)["params"]
    traced = jax.eval_shape(build(J, False).init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in inputs()])["params"]
    assert _shapes(params) == _shapes(traced)
    assert ("aud_proj" in params) == (name == "bert_audio")
    port.load_state_dict(from_flax(params), strict=True)
    back = dict(_flat(to_flax(port)))
    assert set(back) == set(dict(_flat(params)))
    for k, v in _flat(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


_JAX = {}


def _jax_args(name, args):
    """JAX's inputs: the MTL's task as a [B] vector."""
    if name.startswith("mtl"):
        args = tuple(args[:3]) + (np.broadcast_to(
            np.asarray(args[3], np.int32), (B,)),)
    return [jnp.asarray(a) for a in args]


def _jax_run(name, params, args):
    """JAX's eval logits (deterministic) and, in training mode with every
    dropout at 0, its loss and gradients: one program per model class,
    compiled once."""
    key = WEIGHTS.get(name, name)
    if key not in _JAX:
        jm = CASES[key][0](J, True)

        def objective(p, a):
            logits = jm.apply({"params": p}, *a, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1),
                                    "spec_augment": jax.random.PRNGKey(2)})
            return j_cross_entropy(logits, jnp.asarray(LABELS),
                                   jnp.asarray(CW), jnp.asarray(SMASK))

        _JAX[key] = jax.jit(lambda p, a: (
            jm.apply({"params": p}, *a),
            *jax.value_and_grad(objective)(p, a)))
    return _JAX[key](params, _jax_args(name, args))


@pytest.mark.parametrize("name", list(CASES))
def test_eval_matches_jax(weights, name):
    params, args = _params(weights, name), CASES[name][1]()
    want = _jax_run(name, params, args)[0]
    model = _port(name, params).eval()
    with torch.no_grad():
        got = model(*_torch(args))
    assert got.shape == (B, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_train_matches_jax(weights, name):
    """Training mode with every dropout rate 0 and SpecAugment off: the
    class-weighted loss and every gradient leaf."""
    params, args = _params(weights, name), CASES[name][1]()
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


@pytest.mark.parametrize("name", ["bert_audio", "mtl_rows", "late_fusion",
                                  "vbert"])
def test_fused_paths_match_plain(weights, name, monkeypatch):
    """``MME_FUSED_LN`` and ``MME_FUSED_MLP`` engaged (their plain versions
    on the CPU, ``interpret``) against the knobs off."""
    model = _port(name, _params(weights, name)).eval()
    args = _torch(CASES[name][1]())
    with torch.no_grad():
        off = model(*args)
        monkeypatch.setenv("MME_FUSED_LN", "interpret")
        monkeypatch.setenv("MME_FUSED_MLP", "interpret")
        on = model(*args)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("task", [0, 1])
def test_mtl_task_select_isolates_the_towers(weights, task):
    """One training step's gradients with a 0-d task: the other tower's
    (and for task 0 ``fc_norm``'s) are exactly zero; the chosen tower's and
    ``shared_layer``'s are not; and every gradient, ``shared_layer``'s
    included, is bit for bit the same when the other tower's input
    changes."""
    model = _port("mtl_task0", weights["mtl_task0"], quiet=True).train()
    ids, mask, clips, _ = _tv_inputs(task)()
    task_id = np.asarray(task, np.int32)
    _, grads = _port_loss_and_grads(model, (ids, mask, clips, task_id),
                                    LABELS, SMASK, CW)
    if task == 0:
        other = (ids, mask, clips + 0.25, task_id)
    else:
        other = ((ids + 3) % 100, mask, clips, task_id)
    _, grads2 = _port_loss_and_grads(model, other, LABELS, SMASK, CW)
    idle = ("videomae.", "fc_norm.") if task == 0 else ("bert.",)
    busy = ("bert.",) if task == 0 else ("videomae.", "fc_norm.")
    for (n, _), g, g2 in zip(model.named_parameters(), grads, grads2):
        assert g is not None, n
        if n.startswith(idle):
            assert not g.any(), n
        elif n.startswith(busy + ("shared_layer.", "classifier.")):
            assert g.abs().sum() > 0, n
        assert torch.equal(g, g2), n
    names = [n for n, _ in model.named_parameters()]
    assert names.count("shared_layer.weight") == 1
    assert not any(".shared_layer." in n for n in names)


def test_vbert_tied_table_and_unused_pooler(weights):
    """The decoder multiplies by ``embeddings.word``'s own parameter: one
    tensor, one leaf, no decoder entry in the state dict. The pooler is in
    the tree, its gradient None (unused by the loss); one AdamW step moves
    its kernel by weight decay alone and leaves its zero bias at zero."""
    model = _port("vbert", weights["vbert"], quiet=True).train()
    word = model.vbert.visual_bert.embeddings.word.weight
    assert model.vbert.decoder_weight is word
    assert sum(p is word for p in model.parameters()) == 1
    assert not any("decoder" in k and "bias" not in k
                   for k in model.state_dict())
    _, grads = _port_loss_and_grads(model, _vb_inputs(), LABELS, SMASK, CW)
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    assert by_name["vbert.visual_bert.pooler.weight"] is None
    assert by_name["vbert.visual_bert.embeddings.word.weight"].any()

    lr, wd = 1e-3, 0.1
    bm = BatchModel(model, visual_bert_nn.INPUTS)
    tx = make_optimizer(lambda s: lr, wd, 1.0, state_dtype="fp32")
    st = TrainState.create(bm.parameters(), tx, use_accum=False)
    pooler = model.vbert.visual_bert.pooler
    before = pooler.weight.detach().clone()
    ids, mask, types_, feats = _vb_inputs()
    batch = {"input_ids": ids, "text_mask": mask, "token_type_ids": types_,
             "visual_embeds": feats}
    make_train_step(bm, tx, num_classes=5)(st, batch, LABELS, SMASK, CW, 1.0,
                                           True, 0)
    torch.testing.assert_close(pooler.weight.detach(),
                               before * (1 - lr * wd), rtol=1e-6, atol=0)
    assert not pooler.bias.any()


def _ln_case(name):
    """(port model at a tiny width, its spec, its inputs)."""
    if name == "BertClassifier":
        spec = dataclasses.replace(
            text.TextEncoderSpec(), vocab_size=100, max_positions=24,
            encoder=dataclasses.replace(text.TextEncoderSpec().encoder,
                                        hidden=32, heads=4, layers=2,
                                        intermediate=64))
        return text.BertClassifier(spec, 5, device="cpu"), spec, _tokens()
    if name == "LSTMClassifier":
        return (text.LSTMClassifier(100, 8, 8, device="cpu"), None,
                _tokens()[:1])
    if name == "VideoMAEClassifier":
        spec = text_video.TextVideoSpec().tiny().video
        return video.VideoMAEClassifier(spec, 5, device="cpu"), spec, \
            (_clips(),)
    if name == "Wav2Vec2Classifier":
        spec = _ta_spec(P, False).audio
        return audio.Wav2Vec2Classifier(spec, 5, device="cpu"), spec, \
            _audio()
    if name == "BertAudioClassifier":
        spec = _ta_spec(P, False)
        return text_audio.BertAudioClassifier(spec, device="cpu"), spec, \
            _ta_inputs()
    if name == "VBertClassifier":
        spec = _vb_spec(P)
        return visualbert.VBertClassifier(spec, 5, device="cpu"), spec, \
            _vb_inputs()
    spec = _tv_spec(P, False)
    model = getattr(text_video, name)(spec, device="cpu")
    return model, spec, _tv_inputs([0, 1, 0])()


@pytest.mark.parametrize("name", [
    "BertClassifier", "LSTMClassifier", "VideoMAEClassifier",
    "BertAudioClassifier", "BertVideoMAEMTLShared", "BertVideoMAELateFusion",
    "VBertClassifier", "Wav2Vec2Classifier"])
def test_classifier_ln_sites_count_every_layer_norm_call(name, monkeypatch):
    """``time_layer_norm.classifier_ln_sites``, from which chip_smoke.py
    expects its K4a/K4b counts, lists exactly the (rows, features) of every
    FusedLayerNorm call of one forward (``MME_FUSED_LN=interpret`` sends
    each call through ``fused_layer_norm``)."""
    calls = []
    plain = layer_norm.fused_layer_norm

    def spy(x, *a, **k):
        calls.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, *a, **k)

    monkeypatch.setattr(layer_norm, "fused_layer_norm", spy)
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    model, spec, args = _ln_case(name)
    model.load_state_dict(from_flax(**init_variables(model, 0)))
    with torch.no_grad():
        model.eval()(*_torch(args))
    want = classifier_ln_sites(spec, B, text_len=L, samples=T)
    assert Counter(calls) == Counter(want) and len(calls) == len(want)


def test_synthetic_data_matches_jax():
    """``synthetic_ta``, ``synthetic_tv`` and ``synthetic_vbert`` give
    JAX's arrays bit for bit."""
    ta, j_ta = (text_audio.TextAudioSpec().tiny(),
                j_text_audio.TextAudioSpec().tiny())
    tv, j_tv = (text_video.TextVideoSpec().tiny(),
                j_text_video.TextVideoSpec().tiny())
    pairs = [
        (text_audio_nn.synthetic_ta(ta, 7, 12, 2000, 7, 3),
         j_text_audio_nn._synthetic_ta(j_ta, 7, 12, 2000, 7, 3)),
        (text_video_nn.synthetic_tv(tv, 5, 12, 7, 1),
         j_text_video_nn._synthetic_tv(j_tv, 5, 12, 7, 1)),
        (visual_bert_nn.synthetic_vbert(6, 12, 16, 128, 2, 2),
         j_visual_bert_nn._synthetic_vbert(6, 12, 16, 128, 2, 2)),
    ]
    for a, b in pairs:
        assert set(a.features) == set(b.features)
        for key in a.features:
            np.testing.assert_array_equal(a.features[key], b.features[key])
            assert a.features[key].dtype == b.features[key].dtype
        np.testing.assert_array_equal(a.labels, b.labels)


def test_task_transform_draws_a_0d_task():
    """``make_task_transform`` adds a 0-d int32 ``task_id``: 1 where the
    step generator's uniform draw exceeds 0.6, as JAX's transform does
    from its key; the features pass unchanged."""
    tf = text_video_nn.make_task_transform()
    batch = {"input_ids": torch.zeros(2, 3, dtype=torch.int32)}
    tasks = []
    for seed in range(64):
        g = torch.Generator().manual_seed(seed)
        want = int(torch.rand((), generator=torch.Generator().manual_seed(
            seed)) > 0.6)
        out = tf(g, batch)
        assert out["task_id"].shape == () and out["task_id"].dtype == \
            torch.int32
        assert int(out["task_id"]) == want
        assert out["input_ids"] is batch["input_ids"]
        tasks.append(want)
    assert 0 < sum(tasks) < 64


@pytest.mark.parametrize("cli,argv,records", [
    (text_audio_nn, ["-b", "16"], 16),
    (text_video_nn, ["-m", "1MTL", "-b", "16"], 16),
    (text_video_nn, ["-b", "16"], 16),
    (visual_bert_nn, ["-b", "16"], 16)],
    ids=["text_audio", "text_video_1MTL", "text_video_late", "visual_bert"])
def test_cli_runs_on_cpu(cli, argv, records, tmp_path, monkeypatch):
    """Each CLI's ``main`` for one synthetic epoch at its tiny spec: a
    finite test loss over the test records."""
    monkeypatch.chdir(tmp_path)
    summary = cli.main(["--dataset", "synthetic", "-e", "1", "-l", "1e-4"]
                       + argv, device="cpu")
    assert np.isfinite(summary["test/loss"])
    cm = np.array(summary["test/confusion_matrix"])
    assert cm.sum() == records
    if cli is visual_bert_nn:
        assert cm.shape == (2, 2)          # -y 7 becomes Hateful Memes' 2
    assert (tmp_path / "checkpoints" / "best_meta.json").exists()


def test_mtl_serving_knobs_refused_as_jax_cannot_serve_them(tmp_path,
                                                            monkeypatch):
    """JAX (unedited): ``Predictor.predict_dataset`` through the MTL's task
    transform, what ``MME_PREDICT_OUT`` runs after training, fails on the
    0-d ``task_id`` when it cuts the chunk by rows. The port refuses
    ``-m 1MTL`` with ``MME_PREDICT_OUT`` or ``MME_EXPORT_BUNDLE`` before
    any work, with a ``ValueError`` saying why; the late-fusion model
    serves its test split."""
    spec = j_text_video.TextVideoSpec().tiny()
    jm = j_text_video.BertVideoMAEMTLShared(spec)

    def apply_fn(variables, batch, deterministic=True, rngs=None,
                 mutable=None):
        return jm.apply(variables, batch["input_ids"], batch["text_mask"],
                        batch["video"], batch.get("task_id", jnp.asarray(0)),
                        deterministic=deterministic, rngs=rngs)

    params = init_variables(text_video.BertVideoMAEMTLShared(
        text_video.TextVideoSpec().tiny(), device="meta"))["params"]
    ds = j_text_video_nn._synthetic_tv(spec, 5, 12, 7, 2)
    rows = JPredictor(apply_fn, params, batch_size=4).predict_dataset(
        ds, batch_transform=j_text_video_nn.make_task_transform())
    with pytest.raises(IndexError):
        list(rows)

    monkeypatch.chdir(tmp_path)
    for knob in ("MME_PREDICT_OUT", "MME_EXPORT_BUNDLE"):
        monkeypatch.setenv(knob, str(tmp_path / "out"))
        with pytest.raises(ValueError, match="task_id"):
            text_video_nn.main(["--dataset", "synthetic", "-m", "1MTL",
                                "-e", "1", "-b", "16"], device="cpu")
        monkeypatch.delenv(knob)
    assert not (tmp_path / "checkpoints").exists()
    out = tmp_path / "pred.jsonl"
    monkeypatch.setenv("MME_PREDICT_OUT", str(out))
    text_video_nn.main(["--dataset", "synthetic", "-e", "1", "-b", "16"],
                       device="cpu")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 16 and all(len(r["probs"]) == 7 for r in rows)
