"""The port's audio classifier and the two audio repairs
(mme_tpu_torch/models/audio.py: ``Wav2Vec2Spec``'s base default, the
group-norm extractor, the post-LN encoder, ``Wav2Vec2Classifier``;
models/fusion.py: the text-free ``PreFormer``; ``synthetic_audio_dataset``
and the ``audio_nn_wav2vec`` CLI) against mme_tpu on the same inputs.

Weights: flax-layout trees drawn once per file (module fixture) by
``convert.init_variables``, whose leaf sets and shapes are held to JAX's
``model.init`` traced by ``jax.eval_shape`` (never run). JAX applies under
``jax.jit``. The batches carry ragged keep-masks.

Tolerances: fp32 logits and PreFormer outputs within 1e-5 absolute (fp32
sums in other orders through 2 layers); in training mode with every dropout
at 0 and SpecAugment off, the loss within 1e-5 relative and every gradient
leaf within 1e-5 of its largest element; with the fused LayerNorm and MLP
engaged (their plain versions on the CPU) the logits within 1e-5 of the
knobs-off logits (the same fp32 arithmetic in other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.data import synthetic as j_synthetic
from mme_tpu.models import audio as j_audio
from mme_tpu.models import fusion as j_fusion
from mme_tpu.ops.video import balanced_keep_mask
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.cli import audio_nn_wav2vec
from mme_tpu_torch.convert import from_flax, grads_to_flax, init_variables
from mme_tpu_torch.data.synthetic import synthetic_audio_dataset
from mme_tpu_torch.models import audio, fusion
from mme_tpu_torch.models.norm import GroupNorm
from mme_tpu_torch.train.losses import cross_entropy

torch.set_num_threads(2)

ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5
T = 4000


def _small(spec, conv, hidden, intermediate):
    """A tiny tower of ``spec``'s variant (the port's and JAX's specs have
    the same field names)."""
    return dataclasses.replace(
        spec, conv_dims=(conv,) * 3, conv_kernels=(10, 3, 3),
        conv_strides=(5, 2, 2),
        encoder=dataclasses.replace(spec.encoder, hidden=hidden, heads=4,
                                    layers=2, intermediate=intermediate))


# base: the audio CLI's tiny tower (a GroupNorm of 32 groups); large: the
# TAV tests' tiny layer-norm tower
SPECS = {"base": lambda m: _small(m.Wav2Vec2Spec.base(), 32, 64, 128),
         "large": lambda m: _small(m.Wav2Vec2Spec.large(), 8, 32, 64)}


def _quiet(spec):
    return dataclasses.replace(
        spec, mask_time_prob=0.0, mask_feature_prob=0.0,
        encoder=dataclasses.replace(spec.encoder, dropout=0.0,
                                    attention_dropout=0.0))


def _batch(n=3, seed=1):
    rng = np.random.RandomState(seed)
    wave = rng.randn(n, T).astype(np.float32)
    mask = np.ones((n, T), np.int32)
    mask[1, 2500:] = 0
    mask[2, 1200:] = 0
    return wave * mask, mask


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
    """Per variant: the classifier's variables, held to JAX's tree."""
    out = {}
    for i, name in enumerate(SPECS):
        jm = j_audio.Wav2Vec2Classifier(SPECS[name](j_audio), output_dim=5)
        wave, mask = _batch()
        traced = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(wave), jnp.asarray(mask))
        pm = audio.Wav2Vec2Classifier(SPECS[name](audio), 5, device="cpu")
        v = init_variables(pm, seed=i)
        assert _shapes(v["params"]) == _shapes(traced["params"])
        assert "batch_stats" not in v and "batch_stats" not in traced
        out[name] = v["params"]
    return out


def test_spec_defaults_match_jax():
    """The bare spec, ``.base()`` and ``.large()`` hold JAX's values field
    by field (the encoder's too). The port's encoder spec has no fields for
    the parallel axes, scan-over-layers or ``param_dtype``; dtypes are not
    compared."""
    for make in (lambda m: m.Wav2Vec2Spec(), lambda m: m.Wav2Vec2Spec.base(),
                 lambda m: m.Wav2Vec2Spec.large()):
        got = dataclasses.asdict(make(audio))
        want = dataclasses.asdict(make(j_audio))
        enc, want_enc = got.pop("encoder"), want.pop("encoder")
        assert got == want
        for k, v in enc.items():
            if k != "dtype":
                assert v == want_enc[k], k
    base = audio.Wav2Vec2Spec()
    assert (base.conv_bias, base.feat_extract_norm,
            base.do_stable_layer_norm, base.encoder.hidden) == (
                False, "group", False, 768)
    assert fusion.TAVSpec().audio == audio.Wav2Vec2Spec.large()


def test_extractor_variants():
    """The base extractor has bias-free convs and one ``group_norm`` (a
    group per channel) after ``conv_0``; the large one has conv biases and
    ``ln_{i}`` after every conv; the base encoder has its ``ln``."""
    base = audio.Wav2Vec2Model(SPECS["base"](audio), device="meta")
    names = {n for n, _ in base.named_parameters()}
    fe = base.feature_extractor
    assert isinstance(fe.group_norm, GroupNorm)
    assert fe.group_norm.num_groups == 32
    assert not any(n.startswith("feature_extractor.ln_") for n in names)
    assert all(getattr(fe, f"conv_{i}").bias is None for i in range(3))
    assert "encoder.ln.weight" in names
    large = audio.Wav2Vec2Model(SPECS["large"](audio), device="meta")
    names = {n for n, _ in large.named_parameters()}
    assert {f"feature_extractor.ln_{i}.weight" for i in range(3)} <= names
    assert "feature_extractor.conv_0.bias" in names
    assert "encoder.ln.weight" not in names
    assert "encoder.layers.final_ln.weight" in names


@pytest.mark.parametrize("name", list(SPECS))
def test_classifier_eval_matches_jax(weights, name):
    """Eval mode: the logits of ragged utterances (masked mean pool)."""
    params = weights[name]
    jm = j_audio.Wav2Vec2Classifier(SPECS[name](j_audio), output_dim=5)
    wave, mask = _batch()
    want = jax.jit(lambda p, w, m: jm.apply({"params": p}, w, m))(
        params, jnp.asarray(wave), jnp.asarray(mask))
    model = audio.Wav2Vec2Classifier(SPECS[name](audio), 5, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(wave), torch.from_numpy(mask))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", list(SPECS))
def test_classifier_train_matches_jax(weights, name):
    """Training mode with every dropout rate 0 and SpecAugment off: the
    class-weighted loss and every gradient."""
    params = weights[name]
    jm = j_audio.Wav2Vec2Classifier(_quiet(SPECS[name](j_audio)),
                                    output_dim=5, dropout=0.0)
    wave, mask = _batch()
    labels, smask = np.array([0, 3, 4]), np.array([1, 1, 0], np.int32)
    cw = np.linspace(0.5, 1.5, 5).astype(np.float32)

    def objective(p):
        logits = jm.apply({"params": p}, jnp.asarray(wave), jnp.asarray(mask),
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1),
                                "spec_augment": jax.random.PRNGKey(2)})
        return j_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(cw),
                               jnp.asarray(smask))

    j_loss, j_grads = jax.jit(jax.value_and_grad(objective))(params)
    model = audio.Wav2Vec2Classifier(_quiet(SPECS[name](audio)), 5, 0.0,
                                     device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    model.train()
    logits = model(torch.from_numpy(wave), torch.from_numpy(mask))
    loss = cross_entropy(logits, torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(smask))
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    assert abs(loss.item() - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    want = dict(_flat(j_grads))
    for k, g in _flat(grads_to_flax(model, grads)):
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def test_classifier_fused_paths_match_plain(weights, monkeypatch):
    """The base classifier with ``MME_FUSED_LN`` and ``MME_FUSED_MLP``
    engaged (their plain versions on the CPU, ``interpret``) against the
    knobs off: the path the card runs through K4a and K5a."""
    model = audio.Wav2Vec2Classifier(SPECS["base"](audio), 5, device="cpu")
    model.load_state_dict(from_flax(weights["base"]), strict=True)
    model.eval()
    wave, mask = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        off = model(wave, mask)
        monkeypatch.setenv("MME_FUSED_LN", "interpret")
        monkeypatch.setenv("MME_FUSED_MLP", "interpret")
        on = model(wave, mask)
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=ATOL)


def test_preformer_audio_video_only_matches_jax():
    """``PreFormer(input_ids=None)`` fuses audio and video only, as JAX's
    does (``tests/test_misc_ops.py::test_preformer_audio_video_only``'s
    shapes): the same fused sequence, type ids (no 0) and keep-mask."""
    spec, j_spec = fusion.TAVSpec(output_dim=7).tiny(), \
        j_fusion.TAVSpec(output_dim=7).tiny()
    rng = np.random.RandomState(0)
    B, n = 2, 400
    kw = dict(
        input_ids=None, text_mask=None,
        waveform=rng.randn(B, n).astype(np.float32),
        audio_mask=np.ones((B, n), np.int32),
        video=rng.randn(B, spec.video.num_frames, spec.video.image_size,
                        spec.video.image_size, 3).astype(np.float32),
        video_keep=np.asarray(balanced_keep_mask(
            jax.random.PRNGKey(0), B, spec.video.num_patches,
            spec.video_keep_k)))
    kw["audio_mask"][1, 300:] = 0
    jm = j_fusion.PreFormer(j_spec)
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    traced = jax.eval_shape(lambda k: jm.init(k, **jkw),
                            jax.random.PRNGKey(0))["params"]
    pm = fusion.PreFormer(spec, device="cpu")
    params = init_variables(pm, seed=3)["params"]
    # the text embeddings are not reached without text, so JAX's tree has
    # none
    params = {k: v for k, v in params.items() if k in traced}
    assert _shapes(params) == _shapes(traced)
    want = jax.jit(lambda p, kw: jm.apply({"params": p}, **kw))(params, jkw)
    state = from_flax(params)
    state.update({k: v for k, v in pm.state_dict().items()
                  if k.startswith("text_embeddings.")})
    pm.load_state_dict(state, strict=True)
    pm.eval()
    with torch.no_grad():
        got = pm(**{k: None if v is None else torch.from_numpy(v)
                    for k, v in kw.items()})
    fused, type_ids, keep = got
    assert (type_ids >= 1).all()
    assert fused.shape[1] == keep.shape[1] == type_ids.shape[1]
    np.testing.assert_allclose(fused.numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(type_ids.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want[2]))


def test_synthetic_audio_dataset_matches_jax():
    for n, length, k, seed in ((9, 3000, 7, 0), (4, 1001, 3, 5)):
        a = synthetic_audio_dataset(n, audio_len=length, num_classes=k,
                                    seed=seed)
        b = j_synthetic.synthetic_audio_dataset(n, audio_len=length,
                                                num_classes=k, seed=seed)
        for key in ("waveform", "audio_mask"):
            np.testing.assert_array_equal(a.features[key], b.features[key])
        np.testing.assert_array_equal(a.labels, b.labels)


def test_audio_cli_runs_on_cpu(tmp_path, monkeypatch):
    """``audio_nn_wav2vec.main`` on synthetic data, one epoch on the CPU
    with length buckets: a finite test loss over the 32 test utterances."""
    monkeypatch.chdir(tmp_path)
    summary = audio_nn_wav2vec.main(
        ["--dataset", "synthetic", "-e", "1", "-b", "16", "-l", "1e-4"],
        device="cpu")
    assert np.isfinite(summary["test/loss"])
    assert np.array(summary["test/confusion_matrix"]).sum() == 32
    assert (tmp_path / "checkpoints" / "best_meta.json").exists()


def test_audio_cli_refusals(tmp_path, monkeypatch):
    """A missing pickle raises ``FileNotFoundError`` before any work, with
    or without ``MME_PRETRAINED`` (which the full-size tower now loads
    from, as in JAX: tests/test_torch_pretrained.py) and with the tiny
    tower. (A pickle is read: tests/test_torch_pickle_cli.py.)"""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        audio_nn_wav2vec.main(["--dataset", "missing"], device="cpu")
    monkeypatch.setenv("MME_PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        audio_nn_wav2vec.main(["--dataset", "missing"], device="cpu")
    monkeypatch.setenv("MME_TINY", "1")
    with pytest.raises(FileNotFoundError):
        audio_nn_wav2vec.main(["--dataset", "missing"], device="cpu")
