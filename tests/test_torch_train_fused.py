"""One tiny TAV train step with MME_FUSED_LN=interpret and
MME_FUSED_MLP=interpret in both packages: mme_tpu runs its Pallas kernels in
interpret mode, the port the plain versions of its fused functions (their
explicit backward formulas included), on the same flax parameter tree and
numpy-seeded batch.

Every dropout rate and SpecAugment probability is 0, compute and optimizer
state are fp32. Tolerances are those of tests/test_torch_train.py: loss
1e-5, gradient norm 1e-4 relative, each gradient leaf 1e-4 of its largest
element, parameters after the step 1e-5 absolute at lr 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.core.config import ExperimentConfig as JConfig
from mme_tpu.models import fusion as j_fusion
from mme_tpu.train import build_tav as j_build
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import grads_to_flax, init_params, to_flax
from mme_tpu_torch.models import layers as t_layers
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.ops import layer_norm as t_ln
from mme_tpu_torch.train.build_tav import build_tav, example_tav_batch
from mme_tpu_torch.train.losses import cross_entropy

torch.set_num_threads(2)

CFG = dict(batch_size=3, learning_rate=1e-3, text_max_len=12,
           audio_max_samples=4000)


def _quiet(spec):
    def q(e):
        return dataclasses.replace(e, dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        spec, dropout=0.0,
        text=dataclasses.replace(spec.text, encoder=q(spec.text.encoder)),
        audio=dataclasses.replace(spec.audio, mask_time_prob=0.0,
                                  mask_feature_prob=0.0,
                                  encoder=q(spec.audio.encoder)),
        video=dataclasses.replace(spec.video, encoder=q(spec.video.encoder)),
        fusion=q(spec.fusion))


SPEC = _quiet(TAVSpec().tiny())
J_SPEC = _quiet(j_fusion.TAVSpec().tiny())


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def ref():
    batch = example_tav_batch(SPEC, 3, 12, 4000, seed=1)
    batch["text_mask"][1, 7:] = 0
    batch["audio_mask"][1, 2500:] = 0
    labels = np.array([0, 3, 6], np.int32)
    mask = np.array([1, 1, 0], np.int32)
    cw = np.linspace(0.5, 1.5, 7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # numpy draws at flax's scales (convert.init_params): jit-compiling
    # JAX's init would cost every pytest worker that takes a test of this
    # file ~10 s; test_torch_model.py holds the drawn tree against JAX's
    return batch, jb, init_params(SPEC, 0), labels, mask, cw


@pytest.fixture
def knobs(monkeypatch):
    """Both knobs at ``interpret``, and a count of the port's calls into its
    fused functions."""
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    monkeypatch.setenv("MME_OPT_STATE", "fp32")
    calls = {"ln": 0, "mlp": 0}
    real_ln, real_mlp = t_ln.fused_layer_norm, t_layers.fused_mlp

    def ln(*a, **k):
        calls["ln"] += 1
        return real_ln(*a, **k)

    def mlp(*a):
        calls["mlp"] += 1
        return real_mlp(*a)

    monkeypatch.setattr(t_ln, "fused_layer_norm", ln)
    monkeypatch.setattr(t_layers, "fused_mlp", mlp)
    return calls


def _port(params):
    return build_tav(SPEC, ExperimentConfig(**CFG), 10, params=params,
                     remat=False, use_accum=False, device="cpu")


def test_loss_and_gradients_match_jax_with_both_knobs(ref, knobs):
    batch, jb, params, labels, mask, cw = ref
    j_model = j_fusion.TAVModel(J_SPEC)

    def objective(p):
        logits = j_model.apply({"params": p}, jb, deterministic=False)
        return j_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(cw),
                               jnp.asarray(mask))

    want_loss, want = jax.jit(jax.value_and_grad(objective))(params)
    model, _, _, _ = _port(params)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = cross_entropy(model(tb), torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(mask))
    loss.backward()
    layers = sum(e.layers for e in (SPEC.text.encoder, SPEC.audio.encoder,
                                    SPEC.video.encoder, SPEC.fusion))
    n_ln = sum(isinstance(m, t_ln.FusedLayerNorm) for m in model.modules())
    assert knobs["mlp"] == layers and knobs["ln"] == n_ln
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    got = dict(_flat(grads_to_flax(model)))
    for path, b in _flat(want):
        np.testing.assert_allclose(got[path], b, rtol=0, err_msg=str(path),
                                   atol=1e-4 * max(np.abs(b).max(), 1e-6))


def test_one_train_step_tracks_jax_with_both_knobs(ref, knobs):
    batch, jb, params, labels, mask, cw = ref
    _, j_state, j_step, _ = j_build.build_tav(
        J_SPEC, JConfig(**CFG), 10, example_batch=jb, remat=False,
        use_accum=False)
    j_state = j_state.replace(params=jax.tree.map(jnp.asarray, params))
    j_state, j_loss, j_cm, j_norm = j_step(
        j_state, jb, jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(cw),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(True),
        jax.random.PRNGKey(0))
    model, state, step, _ = _port(params)
    _, loss, cm, norm = step(state, batch, labels, mask, cw, 1.0, True, 0)
    assert knobs["mlp"] > 0 and knobs["ln"] > 0
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
    got = dict(_flat(to_flax(model)))
    for path, b in _flat(jax.tree.map(np.asarray, j_state.params)):
        a = got[path]
        if path[-1] == "qkv_bias":
            # the key bias's gradient is rounding noise (softmax ignores a
            # shift of every score), which Adam turns into a full step
            assert np.abs(a[1] - b[1]).max() <= 2.5e-3
            a, b = a[[0, 2]], b[[0, 2]]
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                   err_msg=str(path))
    moved = max(np.abs(got[p] - b).max() for p, b in _flat(params))
    assert moved > 1e-4


def test_knobs_on_equal_knobs_off_in_the_port(ref, monkeypatch):
    """The fused functions' plain versions against the unfused modules on
    the whole model: same loss to 1e-6, gradients to 1e-4 of each leaf."""
    batch, _, params, labels, mask, cw = ref
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run():
        model, _, _, _ = _port(params)
        model.train()
        loss = cross_entropy(model(tb), torch.from_numpy(labels),
                             torch.from_numpy(cw), torch.from_numpy(mask))
        return loss.item(), torch.autograd.grad(
            loss, list(model.parameters()), allow_unused=True)

    monkeypatch.setenv("MME_OPT_STATE", "fp32")
    loss0, g0 = run()
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    loss1, g1 = run()
    assert abs(loss0 - loss1) <= 1e-6
    for a, b in zip(g1, g0):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-4 * max(b.abs().max().item(), 1e-6))
