"""The port's train and eval steps (mme_tpu_torch/train) against mme_tpu's on
one tiny-spec flax parameter tree and the same numpy-seeded batch.

Parity legs run with every dropout rate and SpecAugment probability 0, fp32
compute and fp32 optimizer state, so both sides are deterministic: the loss
and every gradient leaf against ``jax.value_and_grad``, then three steps of
``train_step`` (with and without the accumulation buffer) and ``eval_step``
against the JAX steps. The stochastic parts (dropout, SpecAugment, remat
under dropout) draw from a ``torch.Generator`` and are held to their
contracts, since the two frameworks' generators give other bits.

Tolerances: loss 1e-5; each gradient leaf 1e-4 of its largest element (fp32
sums in other orders through every layer, forward and backward); parameters
after each step 1e-5 absolute at lr 1e-3 (Adam's normalised update turns a
relative gradient error into at most lr times it).
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
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.models.layers import dropout
from mme_tpu_torch.ops.audio import spec_augment_mask
from mme_tpu_torch.train.build_tav import (build_tav, example_tav_batch,
                                           make_video_keep_transform)
from mme_tpu_torch.train.losses import cross_entropy

torch.set_num_threads(2)

CFG = dict(batch_size=3, learning_rate=1e-3, text_max_len=12,
           audio_max_samples=4000)


def _quiet(spec):
    """Every dropout rate and SpecAugment probability 0; works on the
    port's and on JAX's spec (same field names)."""
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


SPEC = TAVSpec().tiny()
J_SPEC = j_fusion.TAVSpec().tiny()


def _batch():
    b = example_tav_batch(SPEC, 3, 12, 4000, seed=1)
    b["text_mask"][1, 7:] = 0
    b["audio_mask"][1, 2500:] = 0
    labels = np.array([0, 3, 6], np.int32)
    mask = np.array([1, 1, 0], np.int32)        # a padded batch row
    cw = np.linspace(0.5, 1.5, 7).astype(np.float32)
    return b, labels, mask, cw


@pytest.fixture(scope="module")
def ref():
    batch, labels, mask, cw = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # numpy draws at flax's scales (convert.init_params): jit-compiling
    # JAX's init would cost every pytest worker that takes a test of this
    # file ~10 s; test_torch_model.py holds the drawn tree against JAX's
    return batch, jb, init_params(SPEC, 0), labels, mask, cw


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _port(params, monkeypatch, spec=None, state_dtype="fp32", **kw):
    monkeypatch.setenv("MME_OPT_STATE", state_dtype)
    kw.setdefault("remat", False)
    kw.setdefault("use_accum", False)
    return build_tav(_quiet(SPEC) if spec is None else spec,
                     ExperimentConfig(**CFG), 10, params=params,
                     device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_grads(ref):
    """JAX's loss and every gradient leaf of the quiet model on the batch,
    one compiled program for the two tests below that read them."""
    batch, jb, params, labels, mask, cw = ref
    j_model = j_fusion.TAVModel(_quiet(J_SPEC))

    def objective(p):
        logits = j_model.apply({"params": p}, jb, deterministic=False)
        return j_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(cw),
                               jnp.asarray(mask))

    loss, grads = jax.jit(jax.value_and_grad(objective))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def test_loss_and_every_gradient_leaf_match_jax(ref, jax_grads, monkeypatch):
    batch, jb, params, labels, mask, cw = ref
    want_loss, want = jax_grads
    model, state, _, _ = _port(params, monkeypatch)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = cross_entropy(model(tb), torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    got = dict(_flat(grads_to_flax(model)))
    leaves = dict(_flat(want))
    assert got.keys() == leaves.keys() and len(leaves) == 169
    for path, b in leaves.items():
        a = got[path]
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, err_msg=str(path),
                                   atol=1e-4 * max(np.abs(b).max(), 1e-6))
    # the same through an explicit gradient list
    grads = [p.grad for p in model.parameters()]
    again = dict(_flat(grads_to_flax(model, grads)))
    assert all(np.array_equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("use_accum", [False, True])
def test_three_train_steps_track_jax(ref, monkeypatch, use_accum):
    """loss, grad_norm, confusion matrix and every parameter after each of
    three steps; with the accumulation buffer the update is applied on the
    second micro-step of each pair, at loss_scale 0.5."""
    batch, jb, params, labels, mask, cw = ref
    monkeypatch.setenv("MME_OPT_STATE", "fp32")
    cfg = JConfig(**CFG)
    _, j_state, j_step, _ = j_build.build_tav(
        _quiet(J_SPEC), cfg, 10, example_batch=jb, remat=False,
        use_accum=use_accum)
    j_state = j_state.replace(params=jax.tree.map(jnp.asarray, params))
    if use_accum:
        j_state = j_state.replace(accum_grads=jax.tree.map(
            jnp.zeros_like, j_state.params))
    model, state, step, _ = _port(params, monkeypatch, use_accum=use_accum)
    assert (state.accum_grads is not None) == use_accum
    scale = 0.5 if use_accum else 1.0
    for i in range(3):
        apply = (i % 2 == 1) if use_accum else True
        j_state, j_loss, j_cm, j_norm = j_step(
            j_state, jb, jnp.asarray(labels), jnp.asarray(mask),
            jnp.asarray(cw), jnp.asarray(scale, jnp.float32),
            jnp.asarray(apply), jax.random.PRNGKey(0))
        out, loss, cm, norm = step(state, batch, labels, mask, cw, scale,
                                   apply, 0)
        assert out is state and state.step == i + 1
        np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
        np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-4)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
        assert state.accum_count == int(j_state.accum_count)
        got = dict(_flat(to_flax(model)))
        for path, b in _flat(jax.tree.map(np.asarray, j_state.params)):
            a = got[path]
            if path[-1] == "qkv_bias":
                # a key bias shifts every score of a query alike and the
                # softmax ignores it: its gradient is rounding noise, which
                # Adam normalises to a full step of either sign
                assert np.abs(a[1] - b[1]).max() <= 2.5 * (i + 1) * 1e-3
                a, b = a[[0, 2]], b[[0, 2]]
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                       err_msg=f"step {i} {path}")
    moved = max(np.abs(got[p] - b).max() for p, b in _flat(params))
    assert moved > 1e-4                     # the steps did move the weights


def test_eval_step_matches_jax(ref, monkeypatch):
    batch, jb, params, labels, mask, cw = ref
    _, j_state, _, j_eval = j_build.build_tav(
        J_SPEC, JConfig(**CFG), 10, example_batch=jb, remat=False,
        use_accum=False)
    want_loss, want_cm, want_preds = j_eval(
        jax.tree.map(jnp.asarray, params), None, jb, jnp.asarray(labels),
        jnp.asarray(mask), jnp.asarray(cw))
    # dropout rates left at their defaults: eval is deterministic anyway
    model, _, _, eval_step = _port(params, monkeypatch, spec=SPEC)
    loss, cm, preds = eval_step(batch, labels, mask, cw)
    assert not model.training
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want_cm))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))
    loss_unweighted, _, _ = eval_step(batch, labels, mask)
    assert loss_unweighted.item() != loss.item()


def _loss_and_grads(model, batch, labels, mask, cw, seed):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(seed)
    loss = cross_entropy(model(tb, rng=gen), torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    return loss.item(), grads, gen.get_state()


@pytest.mark.parametrize("remat", [True, "av"])
def test_remat_gives_the_same_loss_and_gradients_with_dropout_on(
        ref, monkeypatch, remat):
    """The recomputed blocks draw the masks of the first pass: loss and
    gradients equal the unremat'd model's bit for bit, and the generator
    ends where it would have."""
    batch, _, params, labels, mask, cw = ref
    plain, _, _, _ = _port(params, monkeypatch, spec=SPEC)
    rematted, _, _, _ = _port(params, monkeypatch, spec=SPEC, remat=remat)
    assert rematted.spec.audio.encoder.remat
    assert rematted.spec.fusion.remat == (remat is True)
    plain.train()
    rematted.train()
    want_loss, want, want_state = _loss_and_grads(plain, batch, labels, mask,
                                                  cw, 5)
    loss, got, state = _loss_and_grads(rematted, batch, labels, mask, cw, 5)
    assert loss == want_loss and torch.equal(state, want_state)
    for (name, _), a, b in zip(plain.named_parameters(), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=name)


def test_training_mode_is_seeded_and_eval_mode_is_deterministic(
        ref, monkeypatch):
    batch, _, params, labels, mask, cw = ref
    model, _, _, _ = _port(params, monkeypatch, spec=SPEC)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.train()
    with torch.no_grad():
        a = model(tb, rng=torch.Generator().manual_seed(1))
        b = model(tb, rng=torch.Generator().manual_seed(1))
        c = model(tb, rng=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            model(tb)                      # never the global RNG
        model.eval()
        d, e = model(tb), model(tb, rng=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e) and not torch.equal(a, d)


def test_train_step_folds_the_seed_with_the_step_count(ref, monkeypatch):
    """The same seed gives each step its own masks, and two runs from the
    same state the same losses."""
    batch, _, params, labels, mask, cw = ref

    def losses():
        _, state, step, _ = _port(params, monkeypatch, spec=SPEC)
        return [step(state, batch, labels, mask, cw, 1.0, False, 7)[1].item()
                for _ in range(2)]

    # accumulation off applies every step; keep the weights fixed instead
    monkeypatch.setattr("mme_tpu_torch.train.optim.Optimizer.update",
                        lambda self, *a, **k: None)
    first, second = losses(), losses()
    assert first == second and first[0] != first[1]


def test_dropout_keeps_and_scales():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert dropout(x, 0.3, False, None) is x and dropout(x, 0.0, True,
                                                         None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.3, True, None)


def _spans(row):
    """Lengths of the runs of True in a 1-D bool array."""
    padded = np.concatenate([[False], row, [False]]).astype(np.int8)
    edges = np.flatnonzero(np.diff(padded))
    return edges[1::2] - edges[::2]


def test_spec_augment_mask_contract():
    """Masked fraction near mask_prob, spans of mask_length (longer where
    they overlap), none past a row's length, at least min_masks spans."""
    gen = torch.Generator().manual_seed(0)
    B, S, L = 64, 400, 10
    lengths = np.r_[np.full(32, 400), np.full(31, 150), [7]]
    keep = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None]
                             ).astype(np.int32))
    mask = spec_augment_mask(gen, B, S, 0.2, L, keep, min_masks=2).numpy()
    assert mask.shape == (B, S) and mask.dtype == bool
    assert not mask[np.arange(S)[None, :] >= lengths[:, None]].any()
    assert not mask[-1].any()                       # shorter than one span
    frac = mask[:32].mean()
    # 0.2 of the row in spans drawn with replacement: overlaps cost a little
    assert 0.14 < frac < 0.21
    for row in mask[:-1]:
        runs = _spans(row)
        assert (runs >= L).all()
        assert runs.sum() >= L * 2 or len(runs) >= 1
    # min_masks holds where mask_prob alone would give no span at all
    sparse = spec_augment_mask(gen, 16, 100, 0.001, L, None, min_masks=2
                               ).numpy()
    assert all(10 <= row.sum() <= 20 for row in sparse)
    none = spec_augment_mask(gen, 16, 100, 0.001, L, None, min_masks=0)
    assert none.sum() <= 16 * L


def test_grads_bf16_run_and_clip_norm_accumulates_in_fp32(ref, monkeypatch):
    batch, _, params, labels, mask, cw = ref
    _, s32, step32, _ = _port(params, monkeypatch, state_dtype="bf16")
    _, _, _, n32 = step32(s32, batch, labels, mask, cw, 1.0, True, 0)
    monkeypatch.setenv("MME_GRADS", "bf16")
    model, state, step, _ = _port(params, monkeypatch, state_dtype="bf16")
    before = [p.detach().clone() for p in model.parameters()]
    _, loss, _, norm = step(state, batch, labels, mask, cw, 1.0, True, 0)
    assert norm.dtype == torch.float32 and np.isfinite(loss.item())
    # bf16 storage moves each element by 2^-9 relative at most
    np.testing.assert_allclose(norm.item(), n32.item(), rtol=5e-3)
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))


def test_factored_step_matches_jax(ref, monkeypatch):
    """``MME_OPT_STATE=factored``: the factored optimizer's step against
    JAX. The first moment starts at zero, so the first update is
    deterministic on both sides (only the stored moment is rounded
    stochastically): loss, gradient norm and every parameter after one step
    against JAX, with the rows and columns of each leaf taken in the flax
    layout (``convert.factored_views``)."""
    from mme_tpu.train import optim as j_optim
    from mme_tpu_torch.train import optim as t_optim
    batch, jb, params, labels, mask, cw = ref
    monkeypatch.setenv("MME_OPT_STATE", "factored")
    # the tiny model has no leaf of 16 384 elements: lower both floors
    monkeypatch.setattr(j_optim, "_FACTOR_MIN_SIZE", 512)
    monkeypatch.setattr(t_optim, "FACTOR_MIN_SIZE", 512)
    _, j_state, j_step, _ = j_build.build_tav(
        _quiet(J_SPEC), JConfig(**CFG), 10, example_batch=jb, remat=False,
        use_accum=False)
    j_state = j_state.replace(params=jax.tree.map(jnp.asarray, params))
    j_state, j_loss, _, j_norm = j_step(
        j_state, jb, jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(cw),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(True),
        jax.random.PRNGKey(0))
    model, state, step, _ = _port(params, monkeypatch,
                                  state_dtype="factored")
    opt = state.opt_state
    assert sum(r is not None for r in opt.nu_row) > 40
    assert all((n is None) != (r is None)
               for n, r in zip(opt.nu, opt.nu_row))
    _, loss, _, norm = step(state, batch, labels, mask, cw, 1.0, True, 0)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-4)
    got = dict(_flat(to_flax(model)))
    for path, b in _flat(jax.tree.map(np.asarray, j_state.params)):
        a = got[path]
        if path[-1] == "qkv_bias":
            assert np.abs(a[1] - b[1]).max() <= 2.5e-3   # see the step test
            a, b = a[[0, 2]], b[[0, 2]]
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                   err_msg=str(path))
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)


def test_module_norms_and_histograms_match_jax(ref, jax_grads, monkeypatch):
    """``log_histograms=True`` turns grad_norm into the dictionary of the
    JAX step: total, per-top-level-module gradient and parameter norms
    (1e-4 relative) and magnitude histograms (parameters exactly; gradient
    buckets may trade the few elements that sit within rounding of a bucket
    edge)."""
    from mme_tpu.train import optim as j_optim
    from mme_tpu.train import steps as j_steps
    from mme_tpu_torch.train.steps import make_train_step
    batch, jb, params, labels, mask, cw = ref
    j_grads = jax_grads[1]
    model, state, _, _ = _port(params, monkeypatch)
    # lr 0: the step leaves the weights alone
    from mme_tpu_torch.train.steps import make_optimizer
    tx = make_optimizer(lambda step: 0.0, 0.0, 1.0, None, "fp32")
    state.opt_state = tx.init(state.params)
    step = make_train_step(model, tx, 7, log_histograms=True)
    _, _, _, norms = step(state, batch, labels, mask, cw, 1.0, True, 0)
    keys = set(params)
    assert set(norms) == {"total"} | {
        f"{kind}/{k}" for k in keys
        for kind in ("grad", "param", "hist/grad", "hist/param")}
    np.testing.assert_allclose(
        norms["total"].item(), float(j_optim.global_norm_f32(j_grads)),
        rtol=1e-4)
    for k in keys:
        np.testing.assert_allclose(
            norms[f"grad/{k}"].item(),
            float(j_optim.global_norm_f32(j_grads[k])), rtol=1e-4)
        np.testing.assert_allclose(
            norms[f"param/{k}"].item(),
            float(j_optim.global_norm_f32(params[k])), rtol=1e-6)
        np.testing.assert_array_equal(
            norms[f"hist/param/{k}"].numpy(),
            np.asarray(j_steps.magnitude_histogram(params[k])))
        want = np.asarray(j_steps.magnitude_histogram(j_grads[k]))
        got = norms[f"hist/grad/{k}"].numpy()
        assert got.sum() == want.sum()
        assert np.abs(got - want).max() <= max(3, want.sum() // 1000)
    only_norms = make_train_step(model, tx, 7, log_module_norms=True)
    _, _, _, d = only_norms(state, batch, labels, mask, cw, 1.0, True, 0)
    assert set(d) == {"total"} | {f"{kind}/{k}" for k in keys
                                  for kind in ("grad", "param")}


def test_video_keep_transform():
    spec = SPEC
    video = torch.zeros(3, 4, 32, 32, 3, dtype=torch.uint8)
    video[:, :2] = 200
    gen = torch.Generator().manual_seed(0)
    out = make_video_keep_transform(spec)(gen, {"video": video})
    assert out["video"].dtype == torch.float32
    assert torch.all(out["video"][:, 2:] == 0)          # padding frames
    keep = out["video_keep"]
    assert keep.shape == (3, spec.video.num_patches)
    assert torch.all(keep.sum(-1) == spec.video_keep_k)
    again = make_video_keep_transform(spec)(gen, {"video": video})
    assert not torch.equal(keep, again["video_keep"])
    with pytest.raises(ValueError, match="Generator"):
        make_video_keep_transform(spec)(None, {"video": video})
    fixed = make_video_keep_transform(spec, random_mask=False)
    a, b = fixed(None, {"video": video}), fixed(None, {"video": video})
    assert torch.equal(a["video_keep"], b["video_keep"])
    assert torch.all(a["video_keep"].sum(-1) == spec.video_keep_k)
