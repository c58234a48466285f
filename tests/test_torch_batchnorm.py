"""The port's BatchNorm models and the batch-statistics plumbing
(mme_tpu_torch/models/{norm,image,video}.py, convert.py's conv kernels and
``batch_stats``, the buffers of train/{steps,checkpoint,loop}.py, serve.py,
and the visual_nn / images_nn CLIs) against mme_tpu on the same inputs.

Weights: flax-layout variables drawn once per file (module fixture) by
``convert.init_variables``, whose leaf sets and shapes are held to JAX's
``model.init`` traced by ``jax.eval_shape`` (never run). Where eval mode
reads the running statistics they are set to random values first (means in
[-0.5, 0.5), variances in [0.5, 1.5)), so a model that ignored them would
fail. JAX applies under ``jax.jit``.

Tolerances: fp32 logits within 1e-5 absolute (convolution and BatchNorm
sums in other orders; measured below 1e-6 on outputs below 1); after one
training-mode forward the loss within 1e-5 relative (the batch
statistics of the last stage, over 8 to 16 values per channel, magnify
the fp32 differences of the convolutions), every gradient leaf within
1e-4 of its largest element (the backward through those statistics is as
sensitive: the port alone moves by 1e-5 of SlowR50's largest gradient
between one and four CPU threads; measured 3e-5 against JAX), and the
running means and variances within 1e-6 absolute plus 1e-5 relative (the
batch statistics of a layer carry its input's fp32 differences; flax's
``0.9 · ra + 0.1 · batch`` on the biased batch variance;
``torch.nn.BatchNorm``'s unbiased update is 1e-2 away at these
sizes, as ``test_batchnorm_layer_matches_flax`` shows). A bundle and a
``Predictor`` against the live model within 1e-6.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from mme_tpu.cli import visual_nn as j_visual_nn
from mme_tpu.data import synthetic as j_synthetic
from mme_tpu.models import image as j_image
from mme_tpu.models import video as j_video
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.cli import images_nn, visual_nn
from mme_tpu_torch.cli.common import BatchModel
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import (_leaves, factored_views, from_flax,
                                   grads_to_flax, init_variables,
                                   stats_to_flax, to_flax)
from mme_tpu_torch.data.synthetic import synthetic_image_dataset
from mme_tpu_torch.evals.metrics import Metrics
from mme_tpu_torch.models import image, video
from mme_tpu_torch.models.norm import BatchNorm, GroupNorm
from mme_tpu_torch.serve import Predictor, export_bundle, load_bundle
from mme_tpu_torch.train.checkpoint import CheckpointManager, state_payload
from mme_tpu_torch.train.losses import (class_weights_from_counts,
                                        cross_entropy)
from mme_tpu_torch.train.loop import evaluate, train_network
from mme_tpu_torch.train.policies import sample_weights_from_labels
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step,
                                       model_buffers)

torch.set_num_threads(2)

LOGIT_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
STAT_TOL = dict(rtol=1e-5, atol=1e-6)

# name → (JAX module, port constructor, input shape, JAX apply kwargs,
# port forward kwargs); both packages keep SlowR50's head parameters under
# ``features_only``, as JAX's tree of the full model does. The odd Conv3D
# side pads (1, 1) under flax's SAME at stride 2, the even one (0, 1).
MODELS = {
    "ResNet50": (lambda: j_image.ResNet50(num_classes=3,
                                          stage_sizes=(1, 1, 1, 1)),
                 lambda: image.ResNet50(3, stage_sizes=(1, 1, 1, 1),
                                        device="cpu"),
                 (4, 48, 48, 3), {}, {}),
    "ResnetClassifier": (lambda: j_image.ResnetClassifier(output_dim=2),
                         lambda: image.ResnetClassifier(2, device="cpu"),
                         (2, 32, 32, 3), {}, {}),
    "ResNetFeatureExtractor": (
        lambda: j_image.ResNetFeatureExtractor(feature_dim=16),
        lambda: image.ResNetFeatureExtractor(16, device="cpu"),
        (2, 32, 32, 3), {}, {}),
    "ConvNetClassifier": (
        lambda: j_image.ConvNetClassifier(hidden_dims=(4, 6), output_dim=1),
        lambda: image.ConvNetClassifier((4, 6), 1, 12, device="cpu"),
        (2, 12, 12, 3), {}, {}),
    "ConvNetClassifier3": (
        lambda: j_image.ConvNetClassifier(hidden_dims=(4,), output_dim=3),
        lambda: image.ConvNetClassifier((4,), 3, 12, device="cpu"),
        (2, 12, 12, 3), {}, {}),
    "SlowR50": (lambda: j_video.SlowR50(output_dim=3,
                                        stage_sizes=(1, 1, 1, 1)),
                lambda: video.SlowR50(3, stage_sizes=(1, 1, 1, 1),
                                      device="cpu"),
                (2, 4, 32, 32, 3), {}, {}),
    "SlowR50_features": (
        lambda: j_video.SlowR50(output_dim=3, stage_sizes=(1, 1, 1, 1)),
        lambda: video.SlowR50(3, stage_sizes=(1, 1, 1, 1), device="cpu"),
        (2, 4, 32, 32, 3), {"features_only": True},
        {"features_only": True}),
    "Conv3DClassifier_even": (
        lambda: j_video.Conv3DClassifier(output_dim=3, widths=(4, 8)),
        lambda: video.Conv3DClassifier(3, (4, 8), device="cpu"),
        (2, 4, 32, 32, 3), {}, {}),
    "Conv3DClassifier_odd": (
        lambda: j_video.Conv3DClassifier(output_dim=3, widths=(4, 8)),
        lambda: video.Conv3DClassifier(3, (4, 8), device="cpu"),
        (2, 3, 33, 33, 3), {}, {}),
}
TRAINED = ("ResNet50", "SlowR50")
# the entries with a tree of their own (the feature-only SlowR50 shares
# SlowR50's, the feature extractor all but its head with the classifier)
TREES = [n for n in MODELS if n not in ("SlowR50_features",
                                        "ResNetFeatureExtractor")]


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree)}


def _random_stats(stats, seed):
    rng = np.random.RandomState(seed)
    return {k: (_random_stats(v, seed + 1) if hasattr(v, "items") else
                (rng.rand(*v.shape).astype(np.float32) - 0.5 if k == "mean"
                 else rng.rand(*v.shape).astype(np.float32) + 0.5))
            for k, v in stats.items()}


def _input(name, seed=0):
    return np.random.RandomState(seed).rand(*MODELS[name][2]).astype(
        np.float32)


@pytest.fixture(scope="module")
def zoo():
    """Per model: JAX's init tree (shapes only), the variables drawn by
    ``init_variables`` with random running statistics."""
    out = {}
    for i, (name, (jm, pm, shape, jkw, _)) in enumerate(MODELS.items()):
        x = jnp.zeros((1,) + shape[1:], jnp.float32)
        traced = jax.eval_shape(jm().init, jax.random.PRNGKey(0), x)
        v = init_variables(pm(), seed=i)
        if "batch_stats" in v:
            v["batch_stats"] = _random_stats(v["batch_stats"], seed=i)
        out[name] = (traced, v)
    return out


def _port(name, variables):
    model = MODELS[name][1]()
    model.load_state_dict(from_flax(variables["params"],
                                    variables.get("batch_stats")),
                          strict=True)
    return model


@pytest.mark.parametrize("name", TREES)
def test_init_variables_and_conversion_match_jax(zoo, name):
    """``init_variables`` gives JAX's leaf set and shapes (statistics 0 and
    1 as flax inits them); ``from_flax`` → ``to_flax`` / ``stats_to_flax``
    gives every leaf back bit for bit; the factored optimizer's view of
    every conv kernel is the flax layout's [rows, last]."""
    traced, v = zoo[name]
    assert _shapes(v["params"]) == _shapes(traced["params"])
    fresh = init_variables(MODELS[name][1](), seed=0)
    if "batch_stats" in traced:
        assert _shapes(v["batch_stats"]) == _shapes(traced["batch_stats"])
        for k, a in _flat(fresh["batch_stats"]):
            assert (a == (0.0 if k.endswith("mean") else 1.0)).all(), k
    else:
        assert "batch_stats" not in fresh
    model = _port(name, v)
    got, want = dict(_flat(to_flax(model))), dict(_flat(v["params"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, a in _flat(v.get("batch_stats", {})):
        np.testing.assert_array_equal(dict(_flat(stats_to_flax(model)))[k],
                                      a, err_msg=k)
    for (path, p, kind, _), view in zip(_leaves(model),
                                        factored_views(model, min_size=1)):
        if kind == "conv":
            leaf = want["/".join(path)]
            np.testing.assert_array_equal(view[0](p.detach()).numpy(),
                                          leaf.reshape(-1, leaf.shape[-1]))
            np.testing.assert_array_equal(
                view[1](view[0](p.detach())).numpy(), p.detach().numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_outputs_match_jax(zoo, name):
    """Eval mode (flax ``train=False`` / ``deterministic=True``): the same
    outputs on the running statistics."""
    jm, _, _, jkw, pkw = MODELS[name]
    _, v = zoo[name]
    x = _input(name, seed=1)
    want = jax.jit(lambda v, x: jm().apply(v, x, **jkw))(v, jnp.asarray(x))
    model = _port(name, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), **pkw)
    if isinstance(want, tuple):          # ResNet50: (logits, pooled)
        assert isinstance(got, tuple) and len(got) == len(want)
    else:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_ATOL)


class _Logits(nn.Module):
    """``model(batch, rng)`` over a net whose first output is the logits."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, batch, rng=None):
        out = self.net(batch["image"])
        return out[0] if isinstance(out, tuple) else out


def _cw():
    return np.array([1.0, 0.5, 2.0], np.float32)


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_jax(zoo, name):
    """One training-mode forward and backward (flax ``train=True``,
    ``mutable=["batch_stats"]``): the loss, every gradient and the mutated
    running statistics; then the port's ``make_train_step`` from the same
    weights gives the same loss, gradient norm and statistics."""
    jm, _, _, _, _ = MODELS[name]
    _, v = zoo[name]
    x = _input(name, seed=2)
    n = len(x)
    labels = np.arange(n, dtype=np.int64) % 3
    mask = np.ones(n, np.int32)

    def objective(params, stats):
        out, mutated = jm().apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        logits = out[0] if isinstance(out, tuple) else out
        return (j_cross_entropy(logits, jnp.asarray(labels),
                                jnp.asarray(_cw()), jnp.asarray(mask)),
                mutated["batch_stats"])

    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(v["params"], v["batch_stats"])

    model = _port(name, v).train()
    out = model(torch.from_numpy(x))
    logits = out[0] if isinstance(out, tuple) else out
    loss = cross_entropy(logits, torch.from_numpy(labels),
                         torch.from_numpy(_cw()), torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(loss.item() - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    want_g = dict(_flat(j_grads))
    for k, g in _flat(grads_to_flax(model, grads)):
        scale = max(float(np.abs(want_g[k]).max()), 1e-12)
        np.testing.assert_allclose(g, want_g[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    want_s = dict(_flat(j_stats))
    got_s = dict(_flat(stats_to_flax(model)))
    assert got_s.keys() == want_s.keys()
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], err_msg=k,
                                   **STAT_TOL)

    # the step: fresh weights and statistics, the same batch
    net = _port(name, v)
    step_model = _Logits(net)
    tx = make_optimizer(lambda s: 1e-3, 0.0, 1.0)
    state = TrainState.create(step_model.parameters(), tx, use_accum=False,
                              buffers=model_buffers(step_model))
    assert set(state.buffers) == {f"net.{k.replace('/', '.')}"
                                  for k in want_s}
    step = make_train_step(step_model, tx, num_classes=3)
    _, s_loss, _, s_norm = step(state, {"image": x}, labels, mask, _cw(), 1.0,
                                True, 0)
    j_norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                               for g in jax.tree.leaves(j_grads))))
    assert abs(s_loss.item() - float(j_loss)) <= LOSS_RTOL * float(j_loss)
    assert abs(float(s_norm) - j_norm) <= 1e-4 * j_norm
    for k, a in _flat(stats_to_flax(net)):
        np.testing.assert_allclose(a, want_s[k], err_msg=k, **STAT_TOL)


@pytest.mark.parametrize("shape", [(6, 5), (3, 4, 4, 5)])
def test_batchnorm_layer_matches_flax(shape):
    """``models/norm.py::BatchNorm`` against flax ``nn.BatchNorm``
    (momentum 0.9, eps 1e-5) over two training batches and one eval
    batch: outputs, gradients of the input and the running statistics.
    ``F.batch_norm``'s running variance, the unbiased estimate, misses
    flax's by far more than the tolerance."""
    rng = np.random.RandomState(3)
    xs = [(rng.randn(*shape) * 2 + 1).astype(np.float32) for _ in range(3)]
    C = shape[-1]
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}     # flax's init
    port = BatchNorm(C, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    ref_mean, ref_var = torch.zeros(C), torch.ones(C)
    to_cf = lambda a: torch.from_numpy(a).movedim(-1, 1)

    @jax.jit
    def j_train(x, stats):
        def f(x):
            y, m = bn.apply({"params": params, "batch_stats": stats}, x,
                            use_running_average=False,
                            mutable=["batch_stats"])
            w = jnp.arange(y.size).reshape(y.shape) / y.size
            return jnp.sum(y * w), (y, m)
        (_, (y, m)), gx = jax.value_and_grad(f, has_aux=True)(x)
        return y, m["batch_stats"], gx

    port.train()
    for x in xs[:2]:
        y, stats, gx = j_train(jnp.asarray(x), stats)
        xt = to_cf(x).requires_grad_(True)
        yt = port(xt).movedim(1, -1)
        w = torch.arange(yt.numel(), dtype=torch.float32).reshape(
            yt.shape) / yt.numel()
        (gt,) = torch.autograd.grad((yt * w).sum(), xt)
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(gt.movedim(1, -1).numpy(),
                                   np.asarray(gx), rtol=0, atol=1e-5)
        np.testing.assert_allclose(port.mean.numpy(),
                                   np.asarray(stats["mean"]), **STAT_TOL)
        np.testing.assert_allclose(port.var.numpy(),
                                   np.asarray(stats["var"]), **STAT_TOL)
        F.batch_norm(to_cf(x), ref_mean, ref_var, training=True,
                     momentum=0.1)
    assert np.abs(ref_var.numpy() - np.asarray(stats["var"])).max() > 1e-3
    port.eval()
    y = jax.jit(lambda v, x: bn.apply(v, x, use_running_average=True))(
        {"params": params, "batch_stats": stats}, jnp.asarray(xs[2]))
    with torch.no_grad():
        yt = port(to_cf(xs[2])).movedim(1, -1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(y), rtol=0, atol=1e-5)


def test_group_norm_matches_flax():
    """``models/norm.py::GroupNorm`` against flax ``nn.GroupNorm`` with a
    group per channel (wav2vec2-base's) and with two channels per group,
    on [B, T, C] with a mean above its spread (fp32 statistics of
    E[x²] − E[x]² on both sides)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 50, 8) * 2 + 3).astype(np.float32)
    for groups in (8, 4):
        gn = fnn.GroupNorm(num_groups=groups, epsilon=1e-5)
        p = {"scale": jnp.asarray(rng.rand(8).astype(np.float32) + 0.5),
             "bias": jnp.asarray(rng.randn(8).astype(np.float32))}
        want = jax.jit(gn.apply)({"params": p}, jnp.asarray(x))
        port = GroupNorm(8, groups, device="cpu")
        port.load_state_dict(from_flax(p))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)


class _Recording(CheckpointManager):
    """Keeps a copy of the buffers of every best save, and of the state's
    buffers just after every restore."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.saved, self.restores = [], []

    def save_best(self, state, meta):
        self.saved.append(_copy(state.buffers))
        super().save_best(state, meta)

    def restore_best(self, target_state):
        out = super().restore_best(target_state)
        self.restores.append(_copy(target_state.buffers))
        return out


def _copy(buffers):
    return {k: b.clone() for k, b in buffers.items()}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_resnet_loop_with_batch_stats(tmp_path):
    """``tests/test_batchnorm_models.py::test_resnet_loop_with_batch_stats``
    through the port's ``train_network``: the running statistics move, the
    test accuracy is at least 0.5, every best save carries the statistics
    of its step, and every best reload brings back a best save's (here
    each epoch ends on an improvement, so the reloads find them in place;
    ``test_checkpoint_payload_carries_buffers`` reloads statistics that
    moved after the save)."""
    cfg = ExperimentConfig(epoch=2, batch_size=16, learning_rate=1e-2,
                           log_val=4, output_dim=2, patience=50,
                           checkpoint_dir=str(tmp_path / "ck"))
    net = image.ResNet50(2, stage_sizes=(1, 1, 1, 1), device="cpu")
    net.load_state_dict(from_flax(**init_variables(net, seed=0)))
    model = _Logits(net)
    train_ds = synthetic_image_dataset(96, size=16, num_classes=2, seed=0)
    val_ds = synthetic_image_dataset(32, size=16, num_classes=2, seed=1)
    test_ds = synthetic_image_dataset(32, size=16, num_classes=2, seed=2)

    tx = make_optimizer(cosine_warm_restarts(cfg.learning_rate, 2, 6),
                        cfg.weight_decay, cfg.clip)
    state = TrainState.create(model.parameters(), tx,
                              buffers=model_buffers(model),
                              names=[n for n, _ in model.named_parameters()])
    before = _copy(state.buffers)
    train_step = make_train_step(model, tx, num_classes=2)
    eval_step = make_eval_step(model, num_classes=2)
    cw = class_weights_from_counts(np.bincount(train_ds.labels, minlength=2))
    sw = sample_weights_from_labels(train_ds.labels, cw)
    metric = Metrics(2, {0: "a", 1: "b"}, device="cpu")
    ck = _Recording(cfg.checkpoint_dir, use_async=False)
    state2 = train_network(train_step, eval_step, state, train_ds, val_ds,
                           cfg, metric, cw, sw, 0, checkpoints=ck)
    assert not _same(before, state2.buffers)
    assert ck.saved and ck.restores
    for restored in ck.restores:
        assert any(_same(restored, saved) for saved in ck.saved)
    assert _same(state2.buffers, ck.saved[-1])
    summary = evaluate(eval_step, state2, test_ds, cfg, metric)
    assert summary["test/acc"] >= 0.5


def test_checkpoint_payload_carries_buffers(tmp_path):
    """A state with buffers saves them and a restore copies them into the
    target's own tensors; a state without buffers keeps the payload's
    keys of old, and a payload whose buffers differ from the target's
    raises."""
    net = image.ResNet50(2, stage_sizes=(1, 1, 1, 1), device="cpu")
    net.load_state_dict(from_flax(**init_variables(net, seed=0)))
    model = _Logits(net)
    tx = make_optimizer(lambda s: 1e-3, 0.0, 1.0)
    state = TrainState.create(model.parameters(), tx, use_accum=False,
                              buffers=model_buffers(model))
    model.train()
    model({"image": torch.rand(2, 16, 16, 3)})      # moves the statistics
    saved = _copy(state.buffers)
    ck = CheckpointManager(str(tmp_path / "ck"), use_async=False)
    ck.save_best(state, {"val_loss": 1.0})
    model({"image": torch.rand(2, 16, 16, 3)})
    assert not _same(saved, state.buffers)
    ck.restore_best(state)
    assert _same(saved, state.buffers)
    assert state.buffers["net.bn1.mean"] is net.bn1.mean

    plain = TrainState.create([nn.Parameter(torch.ones(3))], tx)
    assert set(state_payload(plain)) == {"step", "params", "opt_state",
                                         "accum_grads", "accum_count"}
    assert model_buffers(nn.Linear(2, 2)) is None
    other = TrainState.create(model.parameters(), tx, use_accum=False)
    with pytest.raises(ValueError, match="buffers"):
        ck.restore_best(other)


def test_predictor_and_bundle_serve_running_statistics(zoo, tmp_path):
    """A BN model served by ``Predictor`` and by a bundle gives the live
    eval-mode model's probabilities (the bundle's program holds the
    running statistics); with the statistics reset the live model serves
    other probabilities."""
    _, v = zoo["ResNet50"]
    model = _Logits(image.ResNet50(3, stage_sizes=(1, 1, 1, 1),
                                   device="cpu"))
    model.net.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    x = np.random.RandomState(5).rand(5, 16, 16, 3).astype(np.float32)
    model.eval()
    with torch.no_grad():
        want = torch.softmax(model({"image": torch.from_numpy(x)}), -1)
    live = Predictor(model, batch_size=4, device="cpu")
    preds, probs = live({"image": x})
    np.testing.assert_allclose(probs, want.numpy(), rtol=0, atol=1e-6)
    export_bundle(model, {"image": x}, str(tmp_path / "b"), batch_size=4,
                  device="cpu")
    served = load_bundle(str(tmp_path / "b"), device="cpu")
    preds_b, probs_b = served({"image": x})
    np.testing.assert_allclose(probs_b, probs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(preds_b, preds)
    bundled = {k: t for k, t in served.module.state_dict().items()
               if k.endswith((".mean", ".var"))}
    assert len(bundled) == 2 * sum(isinstance(m, BatchNorm)
                                   for m in model.modules())
    fresh = _Logits(image.ResNet50(3, stage_sizes=(1, 1, 1, 1),
                                   device="cpu"))
    fresh.net.load_state_dict(from_flax(v["params"], init_variables(
        fresh.net)["batch_stats"]))
    assert np.abs(Predictor(fresh, batch_size=4, device="cpu")(
        {"image": x})[1] - probs).max() > 1e-3


def test_frozen_backbone_mask_matches_jax():
    """``images_nn``'s trainable mask marks exactly the leaves JAX's does:
    every leaf under a module named ``fc`` (the head's and the backbone's
    own ``fc``)."""
    jm = j_image.ResnetClassifier(output_dim=2)
    traced = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    j_mask = dict(_flat(jax.tree_util.tree_map_with_path(
        lambda path, _: np.bool_(any(getattr(k, "key", None) == "fc"
                                     for k in path)), traced)))
    net = image.ResnetClassifier(2, device="meta")
    model = BatchModel(net, ("image",))
    mask = images_nn.fc_trainable_mask(model)
    paths = ["/".join(p) for p, *_ in _leaves(net)]
    assert sorted(paths) == sorted(j_mask)
    assert [bool(j_mask[p]) for p in paths] == mask
    assert sum(mask) == 4           # backbone.fc and fc, kernel and bias


def test_synthetic_image_and_video_match_jax():
    """``synthetic_image_dataset`` and ``visual_nn.synthetic_video`` give
    JAX's arrays bit for bit."""
    for args in ((10, 8, 2, 0), (7, 5, 3, 4)):
        n, size, k, seed = args
        a = synthetic_image_dataset(n, size=size, num_classes=k, seed=seed)
        b = j_synthetic.synthetic_image_dataset(n, size=size, num_classes=k,
                                                seed=seed)
        np.testing.assert_array_equal(a.features["image"],
                                      b.features["image"])
        np.testing.assert_array_equal(a.labels, b.labels)
        a = visual_nn.synthetic_video(n, 3, size, k, seed)
        b = j_visual_nn._synthetic_video(n, 3, size, k, seed)
        np.testing.assert_array_equal(a.features["video"],
                                      b.features["video"])
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("cli,argv", [
    ("images_nn", ["--dataset", "synthetic", "-m", "ResNet", "-e", "1",
                   "-b", "16", "-y", "2", "-l", "1e-3"]),
    ("images_nn", ["--dataset", "synthetic", "-e", "1", "-b", "16", "-y",
                   "2", "-l", "1e-3"]),
    ("visual_nn", ["--dataset", "synthetic", "-e", "1", "-b", "16", "-y",
                   "3", "-l", "1e-3"]),
])
def test_cli_runs_on_cpu(cli, argv, tmp_path, monkeypatch):
    """``images_nn.main`` (ResNet with the frozen backbone, the ConvNet
    with its [1 - p, p] head) and ``visual_nn.main`` (the Conv3D net) on
    synthetic data, one epoch on the CPU: a finite test loss over the 16
    test records and a checkpoint; the ResNet's backbone moved only in its
    ``fc``."""
    monkeypatch.chdir(tmp_path)
    mod = {"images_nn": images_nn, "visual_nn": visual_nn}[cli]
    summary = mod.main(argv, device="cpu")
    assert np.isfinite(summary["test/loss"])
    assert np.array(summary["test/confusion_matrix"]).sum() == 16
    assert os.path.exists(tmp_path / "checkpoints" / "best_meta.json")


def test_cli_refusals(tmp_path, monkeypatch):
    """A missing pickle raises ``FileNotFoundError`` before any work, for
    ``visual_nn -m ResNet`` with ``MME_PRETRAINED`` naming a directory
    too (which it now loads slow_r50 from, as in JAX:
    tests/test_torch_pretrained.py). (A pickle is read:
    tests/test_torch_pickle_cli.py.)"""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        visual_nn.main(["--dataset", "missing"], device="cpu")
    monkeypatch.setenv("MME_PRETRAINED", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        visual_nn.main(["--dataset", "missing", "-m", "ResNet"],
                       device="cpu")
