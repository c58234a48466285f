"""The port's losses, schedules, confusion matrix and optimizers
(mme_tpu_torch/train, mme_tpu_torch/evals, mme_tpu_torch/ops/adam_update.py)
against mme_tpu's on the same numpy-seeded inputs.

Tolerances: scalar losses, schedules and norms agree to 1e-6 (fp32 sums in
other orders); integer results exactly; the fp32 AdamW trajectory to 1e-6
over 20 steps; the stochastic-rounding bit trick bit for bit on the same
dither words; the fused update's plain version against the interpreted
Pallas kernel bit for bit on the moments in ``zero_noise`` mode and within
a few fp32 units in the last place on ``out``, where the fp32 arithmetic
of the two CPU backends can agree at all (see the test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.evals import metrics as j_metrics
from mme_tpu.ops import adam_update as j_adam
from mme_tpu.train import losses as j_losses
from mme_tpu.train import optim as j_optim
from mme_tpu.train import schedules as j_sched
from mme_tpu.train import steps as j_steps

from mme_tpu_torch.evals.metrics import confusion_matrix
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.ops import adam_update, kernels
from mme_tpu_torch.train import losses, optim, schedules
from mme_tpu_torch.train.build_tav import modality_embedding_trainable_mask
from mme_tpu_torch.train.steps import make_optimizer

torch.set_num_threads(2)


def _logits(seed=0, n=11, c=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32) * 3
    labels = rng.integers(0, c, n).astype(np.int32)
    weights = rng.random(c).astype(np.float32) + 0.1
    mask = (rng.random(n) > 0.3).astype(np.int32)
    return logits, labels, weights, mask


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True, "all_out"])
def test_cross_entropy_matches_jax(weighted, masked):
    logits, labels, weights, mask = _logits()
    if masked == "all_out":
        mask = np.zeros_like(mask)       # the 1e-9 floor: 0 / 1e-9 = 0
    w = weights if weighted else None
    m = mask if masked else None
    want = j_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if w is None else jnp.asarray(w),
        None if m is None else jnp.asarray(m))
    got = losses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w),
        None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    if masked == "all_out":
        assert got.item() == 0.0


@pytest.mark.parametrize("name,beta", [("FBeta", 1.0), ("FBeta", 0.5),
                                       ("Precision", 1.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_soft_losses_match_jax(name, beta, masked):
    logits, labels, weights, mask = _logits(1)
    m = mask if masked else None
    want = j_losses.make_loss_fn(name, beta)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights),
        None if m is None else jnp.asarray(m))
    got = losses.make_loss_fn(name, beta)(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(weights), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    assert 0.0 <= got.item() <= 1.0


def test_loss_plumbing_matches_jax():
    counts = np.array([10, 3, 0, 25, 7, 1, 4])
    np.testing.assert_array_equal(losses.class_weights_from_counts(counts),
                                  j_losses.class_weights_from_counts(counts))
    w = np.linspace(0.1, 0.9, 7).astype(np.float32)
    for epoch in range(5):
        want = j_losses.epoch_parity_weights(jnp.asarray(w), epoch, 2)
        got = losses.epoch_parity_weights(torch.from_numpy(w), epoch, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert losses.make_loss_fn("CrossEntropy") is losses.cross_entropy
    assert losses.make_loss_fn("NewCrossEntropy") is losses.cross_entropy
    with pytest.raises(ValueError):
        losses.make_loss_fn("Hinge")


@pytest.mark.parametrize("kind", ["warm_restarts", "annealing"])
def test_schedules_match_jax(kind):
    if kind == "warm_restarts":
        ours = schedules.cosine_warm_restarts(5e-6, 2, 37)
        ref = j_sched.cosine_warm_restarts(5e-6, 2, 37)
    else:
        ours = schedules.cosine_annealing(1e-3, 3, 37, eta_min=1e-5)
        ref = j_sched.cosine_annealing(1e-3, 3, 37, eta_min=1e-5)
    steps = np.arange(300)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.float32)))
    got = np.array([ours(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * got.max())
    assert got[0] == pytest.approx(got.max())


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(2)
    preds, target = rng.integers(0, 7, (2, 40)).astype(np.int32)
    mask = (rng.random(40) > 0.25).astype(np.int32)
    for m in (None, mask):
        want = j_metrics.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(target), 7,
            None if m is None else jnp.asarray(m))
        got = confusion_matrix(torch.from_numpy(preds),
                               torch.from_numpy(target), 7,
                               None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.int32 and got.shape == (7, 7)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((5, 8), (8,), (3, 4, 2), (1,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [10.0, 1e-3])
def test_global_norm_and_clip_match_jax(dtype, scale):
    """Norm accumulated in fp32 for bf16 leaves too; the clip scales by
    min(1, max_norm / max(norm, 1e-16)) (scale 1e-3: no clipping)."""
    leaves = [x * scale for x in _tree()]
    j_leaves = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in leaves]
    t_leaves = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in leaves]
    want = float(j_optim.global_norm_f32(j_leaves))
    got = optim.global_norm_f32(t_leaves)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    tx = j_optim.clip_by_global_norm_f32(1.0)
    want_c, _ = tx.update(j_leaves, tx.init(j_leaves))
    got_c = optim.clip_by_global_norm_f32(t_leaves, 1.0)
    for a, b in zip(got_c, want_c):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-8)


def test_fp32_adamw_tracks_optax_for_20_steps():
    rng = np.random.default_rng(4)
    p0 = _tree(4)
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 3
              for p in p0] for _ in range(20)]
    sched = schedules.cosine_warm_restarts(1e-2, 2, 7)
    tx = make_optimizer(sched, 1e-2, 1.0, state_dtype="fp32")
    params = [torch.from_numpy(p.copy()) for p in p0]
    state = tx.init(params)

    j_tx = j_steps.make_optimizer(j_sched.cosine_warm_restarts(1e-2, 2, 7),
                                  1e-2, 1.0, state_dtype="fp32")
    j_params = [jnp.asarray(p) for p in p0]
    j_state = j_tx.init(j_params)
    import optax
    for g in grads:
        tx.update(params, [torch.from_numpy(x) for x in g], state)
        u, j_state = j_tx.update([jnp.asarray(x) for x in g], j_state,
                                 j_params)
        j_params = optax.apply_updates(j_params, u)
    assert state.count == 20
    for a, b in zip(params, j_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_sr_bf16_is_bit_exact_against_jax_on_the_same_dither():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 5, 4096))
         ).astype(np.float32)
    noise = rng.integers(0, 1 << 16, 4096).astype(np.uint32)
    want = np.asarray(j_optim._sr_bf16(jnp.asarray(x), jnp.asarray(noise)
                                       ).astype(jnp.float32))
    got = adam_update.sr_bf16(torch.from_numpy(x),
                              torch.from_numpy(noise.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert optim.sr_bf16 is adam_update.sr_bf16


@pytest.mark.parametrize("shape,gdtype,b1,b2", [
    ((300, 256), "float32", 0.5, 0.75),
    ((17, 8, 384), "bfloat16", 0.5, 0.75),
    ((300, 256), "float32", 0.9, 0.999),
    ((17, 8, 384), "bfloat16", 0.9, 0.999),
])
def test_adam_plain_matches_interpreted_pallas_kernel_zero_noise(
        shape, gdtype, b1, b2):
    """With b1 = 0.5, b2 = 0.75 and gradients on the bf16 grid every product
    of the moving averages is exact in fp32, so the moments must agree bit
    for bit. With torch's defaults XLA's CPU backend contracts a product
    into an FMA (tests/test_adam_update.py notes the same), which moves the
    fp32 average by a unit in the last place and a truncated moment by one
    bf16 step in a few percent of the elements; the rest must be equal."""
    rng = np.random.default_rng(6)
    bf16_grid = lambda x: torch.from_numpy(x).bfloat16().float().numpy()
    g = bf16_grid((rng.standard_normal(shape) * 0.1).astype(np.float32))
    mu = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    nu = (rng.random(shape) * 1e-3).astype(np.float32)
    eps = 1e-8
    bc1, bc2 = np.float32(1 - b1 ** 7), np.float32(1 - b2 ** 7)
    j_out, j_mu, j_nu = j_adam.adam_update_leaf(
        jnp.asarray(g).astype(getattr(jnp, gdtype)),
        jnp.asarray(mu).astype(jnp.bfloat16),
        jnp.asarray(nu).astype(jnp.bfloat16), jnp.float32(bc1),
        jnp.float32(bc2), jnp.array([5, 9], jnp.int32), 3, b1=b1, b2=b2,
        eps=eps, interpret=True, zero_noise=True)
    before = kernels.LAUNCHES["adam_update"]
    out, mu2, nu2 = adam_update.adam_update_leaf(
        torch.from_numpy(g).to(getattr(torch, gdtype)),
        torch.from_numpy(mu).bfloat16(), torch.from_numpy(nu).bfloat16(),
        float(bc1), float(bc2), 5, b1=b1, b2=b2, eps=eps, zero_noise=True)
    assert kernels.LAUNCHES["adam_update"] == before    # CPU: plain version
    assert out.dtype == getattr(torch, gdtype)
    for ours, theirs in ((mu2, j_mu), (nu2, j_nu)):
        assert ours.dtype == torch.bfloat16
        a = ours.float().numpy()
        b = np.asarray(theirs.astype(jnp.float32))
        if b1 == 0.5:
            np.testing.assert_array_equal(a, b)
        else:
            assert (a != b).mean() < 0.05
            # one bf16 step (2^-7 relative), or a cancelled average whose
            # last place decides its sign
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-8)
    a = out.float().numpy()
    b = np.asarray(j_out.astype(jnp.float32))
    if b1 == 0.5 and gdtype == "float32":
        # XLA's vectorised CPU divide and square root are not correctly
        # rounded: a few units in the last place (measured 3)
        ulp = np.abs(a.view(np.int32).astype(np.int64)
                     - b.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4
    else:
        np.testing.assert_allclose(a, b, rtol=1e-2 if gdtype == "bfloat16"
                                   else 2e-5, atol=2e-6)


def test_adam_plain_takes_the_dither_words_it_is_given():
    """Low half of each word dithers mu, high half nu, as in the JAX
    kernel's pair trick."""
    rng = np.random.default_rng(7)
    g = torch.from_numpy((rng.standard_normal(512) * 0.1).astype(np.float32))
    mu = torch.zeros(512, dtype=torch.bfloat16)
    nu = torch.zeros(512, dtype=torch.bfloat16)
    words = rng.integers(0, 1 << 32, 512)
    _, mu2, nu2 = adam_update.adam_update_leaf_plain(
        g, mu, nu, 0.1, 0.001, b1=0.9, b2=0.999, eps=1e-8,
        noise=torch.from_numpy(words))
    m32 = (1.0 - 0.9) * g
    n32 = (1.0 - 0.999) * g * g
    want_mu = j_optim._sr_bf16(jnp.asarray(m32.numpy()),
                               jnp.asarray((words & 0xFFFF).astype(np.uint32)))
    want_nu = j_optim._sr_bf16(jnp.asarray(n32.numpy()),
                               jnp.asarray((words >> 16).astype(np.uint32)))
    np.testing.assert_array_equal(mu2.float().numpy(),
                                  np.asarray(want_mu.astype(jnp.float32)))
    np.testing.assert_array_equal(nu2.float().numpy(),
                                  np.asarray(want_nu.astype(jnp.float32)))


def test_stochastic_round_is_unbiased_and_brackets():
    x = torch.tensor([1.00390625e-3, -2.7182818, 3.1415926, 1e-8, -1e-8,
                      0.333333])
    gen = torch.Generator().manual_seed(0)
    tiled = x.expand(4096, 6).contiguous()
    for r in (optim.stochastic_round_bf16(tiled, gen),
              *optim.stochastic_round_bf16_pair(tiled, tiled, gen)):
        assert r.dtype == torch.bfloat16
        r = r.float()
        # unbiased: the mean over many draws is far closer than a bf16 step
        np.testing.assert_allclose(r.mean(0).numpy(), x.numpy(), rtol=2e-4,
                                   atol=1e-12)
        lo = x.bfloat16().float()
        assert ((r - lo).abs() <= lo.abs() * 2 ** -7 + 1e-12).all()


def _quadratic_run(tx, steps=200):
    target = torch.from_numpy(np.random.RandomState(0).randn(64).astype(
        np.float32))
    p = [torch.zeros(64)]
    gen = torch.Generator().manual_seed(1)
    state = tx.init(p, gen)
    for _ in range(steps):
        tx.update(p, [2 * (p[0] - target)], state, gen)
    return p[0], float(((p[0] - target) ** 2).sum())


def test_bf16_moment_trajectory_tracks_fp32_adamw():
    """200 steps on a quadratic (clip out of the way): the bf16-moment
    parameters stay within 3e-2 of the fp32 ones and the loss within 2 %."""
    p_ref, l_ref = _quadratic_run(optim.adamw(lambda s: 1e-2, 1e-4, 1e9))
    p_low, l_low = _quadratic_run(optim.adamw_lowmem(lambda s: 1e-2, 1e-4,
                                                     1e9))
    np.testing.assert_allclose(p_low.numpy(), p_ref.numpy(), atol=3e-2)
    assert abs(l_low - l_ref) / max(l_ref, 1e-9) < 0.02


def test_bf16_moments_do_not_stall():
    """Gradients far below half a bf16 step of the moment still move it:
    the mean over 1024 independent roundings is the fp32 average."""
    tx = optim.adamw_lowmem(lambda s: 1e-3, 0.0, 1e9)
    p = [torch.ones(1024)]
    gen = torch.Generator().manual_seed(2)
    state = tx.init(p, gen)
    assert state.mu[0].dtype == state.nu[0].dtype == torch.bfloat16
    for _ in range(50):
        tx.update(p, [torch.full((1024,), 1e-3)], state, gen)
    expect = 1e-3 * (1 - 0.9 ** 50)
    assert abs(state.mu[0].float().mean().item() - expect) / expect < 0.05


def test_trainable_mask_freezes_modality_embedding():
    model = TAVModel(TAVSpec().tiny(), device="cpu")
    assert modality_embedding_trainable_mask(model, True) is None
    mask = modality_embedding_trainable_mask(model, False)
    names = [n for n, _ in model.named_parameters()]
    frozen = [n for n, t in zip(names, mask) if not t]
    assert frozen == ["model.modality_embedding.weight"]
    params = [torch.ones(3, 4), torch.ones(4)]
    tx = make_optimizer(lambda s: 0.1, 0.1, 1.0, [False, True], "fp32")
    state = tx.init(params)
    assert state.mu[0] is None
    tx.update(params, [torch.ones(3, 4), torch.ones(4)], state)
    # truly frozen: no Adam step and no weight decay either
    assert torch.equal(params[0], torch.ones(3, 4))
    assert (params[1] < 1).all()


def test_make_optimizer_state_dtypes(monkeypatch):
    monkeypatch.setenv("MME_OPT_STATE", "bf16")
    assert make_optimizer(lambda s: 1e-3, 0.0, 1.0).state_dtype == "bf16"
    monkeypatch.delenv("MME_OPT_STATE")
    assert make_optimizer(lambda s: 1e-3, 0.0, 1.0).state_dtype == "fp32"
    factored = make_optimizer(lambda s: 1e-3, 0.0, 1.0,
                              state_dtype="factored")
    assert factored.state_dtype == "factored" and factored.views is None
    monkeypatch.setenv("MME_OPT_STATE", "factored")
    assert make_optimizer(lambda s: 1e-3, 0.0, 1.0).state_dtype == "factored"
    with pytest.raises(ValueError):
        make_optimizer(lambda s: 1e-3, 0.0, 1.0, state_dtype="fp16")


def test_fusable_gate(monkeypatch):
    """Off by default; with MME_FUSED_ADAM=1 only a CUDA leaf qualifies, so
    nothing does here."""
    big = torch.zeros(512, 768)
    monkeypatch.delenv("MME_FUSED_ADAM", raising=False)
    assert not adam_update.fusable(big)
    monkeypatch.setenv("MME_FUSED_ADAM", "1")
    assert not adam_update.fusable(big)
    assert adam_update.MIN_FUSED_ELEMENTS == 1 << 16


def _factored_state(j_state):
    """The ScaleByAdamFactoredState inside make_optimizer's optax chain."""
    found = [s for s in jax.tree.leaves(
        j_state, is_leaf=lambda x: isinstance(
            x, j_optim.ScaleByAdamFactoredState))
        if isinstance(s, j_optim.ScaleByAdamFactoredState)]
    assert len(found) == 1
    return found[0]


def test_factored_adamw_tracks_jax_on_the_same_first_moment():
    """Three steps of clip → factored AdamW in both packages. The stored
    first moment is rounded stochastically from other random bits on each
    side, so the port's is set to JAX's before every step; everything else
    is deterministic: parameters to 1e-6 at lr 1e-2, the row, column and
    full second moments to 1e-6 relative. Leaves: a factored matrix, a
    factored rank-3 leaf (rows = leading dims flattened), a matrix and a
    vector below the size floor."""
    import optax
    rng = np.random.default_rng(5)
    shapes = ((128, 256), (64, 32, 8), (10, 10), (300,))
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
             for _ in range(3)]
    sched = schedules.cosine_warm_restarts(1e-2, 2, 7)
    tx = make_optimizer(sched, 1e-2, 1.0, state_dtype="factored")
    params = [torch.from_numpy(p.copy()) for p in p0]
    state = tx.init(params)
    assert [r is not None for r in state.nu_row] == [True, True, False, False]
    assert state.nu_row[1].shape == (64 * 32,) and state.nu_col[1].shape == (8,)
    assert all(m.dtype == torch.bfloat16 for m in state.mu)

    j_tx = j_steps.make_optimizer(j_sched.cosine_warm_restarts(1e-2, 2, 7),
                                  1e-2, 1.0, state_dtype="factored")
    j_params = [jnp.asarray(p) for p in p0]
    j_state = j_tx.init(j_params)
    gen = torch.Generator().manual_seed(0)
    for g in grads:
        j_f = _factored_state(j_state)
        state.mu = [torch.from_numpy(np.asarray(m.astype(jnp.float32))
                                     ).bfloat16() for m in j_f.mu]
        tx.update(params, [torch.from_numpy(x) for x in g], state, gen)
        u, j_state = j_tx.update([jnp.asarray(x) for x in g], j_state,
                                 j_params)
        j_params = optax.apply_updates(j_params, u)
        j_f = _factored_state(j_state)
        for a, b in zip(params, j_params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
        for i, factored in enumerate((True, True, False, False)):
            if factored:
                assert state.nu[i] is None
                np.testing.assert_allclose(state.nu_row[i].numpy(),
                                           np.asarray(j_f.nu_row[i]),
                                           rtol=1e-6)
                np.testing.assert_allclose(state.nu_col[i].numpy(),
                                           np.asarray(j_f.nu_col[i]),
                                           rtol=1e-6)
            else:
                np.testing.assert_allclose(state.nu[i].numpy(),
                                           np.asarray(j_f.nu_full[i]),
                                           rtol=1e-6)
        # the port's own stochastic rounding: a bf16 neighbour of the fp32
        # first moment, not the same bits as JAX's
        for m, jm in zip(state.mu, j_f.mu):
            np.testing.assert_allclose(
                m.float().numpy(), np.asarray(jm.astype(jnp.float32)),
                rtol=2 ** -7, atol=1e-30)
    assert state.count == 3


def test_factored_state_freezes_masked_leaves():
    params = [torch.ones(128, 128), torch.ones(128, 128)]
    tx = make_optimizer(lambda step: 1e-2, 0.0, 1.0, [True, False],
                        state_dtype="factored")
    state = tx.init(params)
    assert state.mu[1] is None and state.nu_row[1] is None
    tx.update(params, [torch.ones(128, 128)] * 2, state,
              torch.Generator().manual_seed(0))
    assert torch.all(params[1] == 1) and not torch.all(params[0] == 1)


def test_factored_views_are_the_flax_layout_rows_and_columns():
    """``convert.factored_views`` on the tiny TAV model: each leaf's view
    equals the flax leaf with its leading dims flattened, and maps back."""
    from mme_tpu_torch.convert import factored_views, init_params, from_flax
    spec = TAVSpec().tiny()
    model = TAVModel(spec, device="cpu")
    tree = init_params(spec, 0)
    model.load_state_dict(from_flax(tree), strict=True)
    flax = dict(_flat_tree(tree))
    from mme_tpu_torch.convert import _leaves
    views = factored_views(model, min_size=64)
    kinds = set()
    for (path, p, kind, _), view in zip(_leaves(model), views):
        leaf = flax[path]
        if leaf.ndim < 2 or leaf.size < 64:
            assert view is None, path
            continue
        kinds.add(kind)
        to_rc, from_rc = view
        rc = to_rc(p.detach())
        np.testing.assert_array_equal(
            rc.numpy(), leaf.reshape(-1, leaf.shape[-1]), err_msg=str(path))
        assert torch.equal(from_rc(rc), p.detach())
    assert {"dense", "conv", "qkv", "embed"} <= kinds


def _flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tree(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_magnitude_histogram_matches_jax():
    from mme_tpu_torch.train.steps import HIST_BUCKETS, magnitude_histogram
    rng = np.random.default_rng(6)
    a = (rng.standard_normal(4000) * 10.0 ** rng.uniform(-14, 4, 4000)
         ).astype(np.float32)
    a[::50] = 0.0
    a[7], a[8], a[9] = np.nan, np.inf, -np.inf
    a[10], a[11], a[12] = 2.0 ** -40, 2.0 ** -37, 2.0 ** 8   # bucket edges
    b = rng.standard_normal((3, 5)).astype(np.float32)
    want = np.asarray(j_steps.magnitude_histogram(
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}))
    got = magnitude_histogram([torch.from_numpy(a), torch.from_numpy(b)])
    assert got.dtype == torch.int32 and got.shape == (HIST_BUCKETS,)
    assert HIST_BUCKETS == j_steps.HIST_BUCKETS
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == a.size + b.size and got[16] >= 3
    one = magnitude_histogram(torch.from_numpy(b).bfloat16())
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        j_steps.magnitude_histogram(jnp.asarray(b).astype(jnp.bfloat16))))
