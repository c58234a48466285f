"""The port's dp axis, mesh serving and the CLIs' meshes
(mme_tpu_torch/parallel/, the mesh branches of train/{steps,losses,loop},
models/{moe,norm}.py, serve.py, cli/{common,tav_nn}.py) against mme_tpu on
the same numpy-seeded inputs and flax weights.

The port's side runs in one pool of two CPU ranks joined by gloo
(``parallel/launch.py::RankPool``, module fixture, a free port each),
reused by every check; every call has a time limit, so a hang fails. JAX's
side runs its dp mesh on the virtual CPU devices of tests/conftest.py. The
rank-side functions import no JAX: the workers import this file by path.

- dp=2 train and eval steps of a BatchNorm model (Dense → flax-semantics
  BatchNorm → relu → Dense, ``models/norm.py::BatchNorm`` against
  ``flax.linen.BatchNorm``)
  against JAX's step over a 2-device dp mesh: cross entropy with class
  weights and sample masks that differ between the ranks' rows, and the
  soft F-beta loss. Loss, every gradient (the ones the optimizer gets),
  the global grad norm, the running statistics, the eval loss, confusion
  matrix and predictions; then the updated parameters against the port's
  single-process step on the whole batch. Tolerances as
  tests/test_mesh_loop.py:92-94 (2e-4 relative plus 2e-5; the loss 1e-5
  relative, the statistics 1e-5 relative plus 1e-6).
- The MoE encoder's aux loss and gradients under dp=2 against JAX's on
  the whole batch (1e-5, as tests/test_torch_moe.py), and the plain mean
  of per-rank aux values against which it must differ.
- ``Predictor(mesh=dp2)`` against JAX's mesh Predictor on
  tests/test_serve.py::test_predictor_mesh_dp_matches_single_device's
  inputs.
- ``tav_nn.main`` (tiny, synthetic) under ``MME_SP=2`` (the fusion and
  the video tower) and under the auto dp mesh, each against its
  single-rank run, as tests/test_sp_pp_training.py holds JAX's: the test
  loss within 2e-3 and the same confusion matrix.
- The loop's other paths under dp=2 against one rank, on a net over
  ragged waveforms with dialog ids: three epochs, the second with dialog
  accumulation, with and without ``BucketedBatchIter`` (as
  tests/test_bucketed_training.py:100 holds JAX's bucketed dp run): the
  number of steps and the final parameters (fp32 sums in another order:
  1e-5). And ``resume`` under dp: a run stopped by SIGTERM on rank 0 in
  the accumulation epoch (``agree`` stops both ranks, rank 0 writes
  ``latest``), then resumed from ``latest`` after the barrier, ends on
  the parameters of the uninterrupted dp run bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from mme_tpu_torch.cli import tav_nn
from mme_tpu_torch.convert import (from_flax, grads_to_flax, init_variables,
                                   stats_to_flax)
from mme_tpu_torch.models.layers import Dense
from mme_tpu_torch.models.norm import BatchNorm
from mme_tpu_torch.parallel.launch import RankPool
from mme_tpu_torch.train.losses import make_loss_fn
from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                       make_train_step, model_buffers)

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
X_SHAPE = (8, 6)
CW = np.asarray([0.5, 1.0, 2.0], np.float32)
# rank 0's rows all count, rank 1's half: the per-rank ratios differ
MASK = np.asarray([1, 1, 1, 1, 1, 0, 1, 0], np.int32)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
MOE_SPEC = dict(hidden=16, heads=2, layers=2, intermediate=32)


class BNNet(torch.nn.Module):
    """``fc1`` → ``bn`` → relu → ``fc2``; ``model(batch, rng) ->
    logits``."""

    def __init__(self):
        super().__init__()
        # no bias before the BatchNorm: its gradient is 0 up to rounding
        self.fc1 = Dense(X_SHAPE[1], 16, use_bias=False, device="cpu")
        self.bn = BatchNorm(16, device="cpu")
        self.fc2 = Dense(16, 3, device="cpu")

    def forward(self, batch, rng=None):
        return self.fc2(torch.relu(self.bn(self.fc1(batch["image"]))))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# ---------------- rank side (the pool's workers; no JAX) ----------------

def _dp_mesh():
    from mme_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(2, 1)


class _Recording:
    """The optimizer, keeping the gradients each update is given."""

    def __init__(self, tx):
        self.tx, self.seen = tx, []

    def init(self, *a, **k):
        return self.tx.init(*a, **k)

    def update(self, params, grads, *a):
        self.seen.append([g.detach().clone() for g in grads])
        return self.tx.update(params, grads, *a)


def _step(variables, x, labels, mask, loss_name, mesh):
    """One train step of the BatchNorm net from ``variables``: (model, loss,
    grad norm, the gradients the optimizer got)."""
    net = BNNet()
    net.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]), strict=True)
    model = net
    tx = _Recording(make_optimizer(lambda s: 1e-2, 0.0, 1.0))
    state = TrainState.create(model.parameters(), tx, use_accum=False,
                              buffers=model_buffers(model))
    step = make_train_step(model, tx, num_classes=3,
                           loss_fn=make_loss_fn(loss_name), mesh=mesh)
    _, loss, cm, norm = step(state, {"image": x}, labels, mask, CW, 1.0,
                             True, 0)
    return net, float(loss), float(norm), tx.seen[0], cm


def rank_dp_step(variables, x, labels, mask, loss_name):
    """Rank side of the dp=2 check: the eval step before, then the train
    step on this rank's rows; everything in flax layout."""
    from mme_tpu_torch.parallel.mesh import shard_batch
    from mme_tpu_torch.train.steps import make_eval_step
    torch.set_num_threads(1)
    mesh = _dp_mesh()
    local = shard_batch({"x": x, "y": labels, "m": mask}, mesh)
    net = BNNet()
    net.load_state_dict(from_flax(variables["params"],
                                  variables["batch_stats"]), strict=True)
    ev = make_eval_step(net, num_classes=3,
                        loss_fn=make_loss_fn(loss_name), mesh=mesh)
    e_loss, e_cm, e_preds = ev({"image": local["x"]}, local["y"],
                               local["m"], CW)
    net, loss, norm, grads, cm = _step(variables, local["x"], local["y"],
                                       local["m"], loss_name, mesh)
    return dict(loss=loss, norm=norm, grads=grads_to_flax(net, grads),
                stats=stats_to_flax(net), cm=cm.numpy(),
                params={k: v.detach().numpy().copy()
                        for k, v in net.state_dict().items()},
                eval=(float(e_loss), e_cm.numpy(), e_preds.numpy()))


def rank_moe(params, x, bias, proj):
    """The MoE encoder's aux loss and the gradients of
    sum(y · proj) + aux on this rank's rows, under the dp batch axis (and
    the aux of this rank's rows alone)."""
    from mme_tpu_torch.models.layers import EncoderSpec
    from mme_tpu_torch.models.moe import MoESpec, MoETransformerEncoder
    from mme_tpu_torch.parallel.mesh import (batch_reduction, batch_sum,
                                             shard_batch)
    torch.set_num_threads(1)
    mesh = _dp_mesh()
    dp = mesh.axis("dp")
    local = shard_batch({"x": x, "b": bias, "p": proj}, mesh)
    enc = MoETransformerEncoder(EncoderSpec(**MOE_SPEC, ln_style="pre"),
                                MoESpec(), device="cpu").eval()
    enc.load_state_dict(from_flax(params), strict=True)
    xt, bt, pt = (torch.from_numpy(np.ascontiguousarray(local[k]))
                  for k in "xbp")
    with torch.no_grad():
        alone = float(enc(xt, bt)[1])
    with batch_reduction(dp):
        y, aux = enc(xt, bt)
        loss = batch_sum((y * pt).sum()) + aux
        grads = torch.autograd.grad(loss, list(enc.parameters()))
    grads = [g / dp.size for g in dp.all_reduce_many(grads)]
    return float(aux), alone, grads_to_flax(enc, grads)


class _Toy(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, batch):
        return batch["x"] @ self.w


def rank_serve(w, x):
    from mme_tpu_torch.serve import Predictor
    torch.set_num_threads(1)
    mesh = _dp_mesh()
    preds, probs = Predictor(_Toy(w), batch_size=8, device="cpu",
                             mesh=mesh)({"x": x})
    try:
        Predictor(_Toy(w), batch_size=5, device="cpu", mesh=mesh)
        refused = False
    except ValueError:
        refused = True
    return preds, probs, refused


CLI_ARGV = ["-d", "synthetic", "-e", "1", "-b", "8", "-y", "7", "-l",
            "1e-4", "-p", "50"]
CLI_ENV = ("MME_SP", "MME_SP_TOWER", "MME_MESH", "MME_DP", "MME_MP",
           "MME_PP")


def rank_cli(directory, env):
    """``tav_nn.main`` on the CPU in ``directory`` with ``env`` set: the
    test loss and confusion matrix."""
    torch.set_num_threads(1)
    old = {k: os.environ.get(k) for k in CLI_ENV}
    cwd = os.getcwd()
    for k in CLI_ENV:
        os.environ.pop(k, None)
    os.environ.update(env)
    os.chdir(directory)
    try:
        s = tav_nn.main(CLI_ARGV, device="cpu")
    finally:
        os.chdir(cwd)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return s["test/loss"], np.asarray(s["test/confusion_matrix"])


# the loop's net and data: ragged waveforms of up to 64 samples, dialogs
# of 4, length buckets at these bounds
LOOP_BOUNDS = (24, 40, 64)


def _seq_data(n, seed):
    from mme_tpu_torch.data.dataset import ArrayDataset
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, n)
    lengths = rng.randint(8, 65, n)
    mask = (np.arange(64)[None] < lengths[:, None]).astype(np.int32)
    wave = ((rng.randn(n, 64) + labels[:, None]) * mask).astype(np.float32)
    return ArrayDataset({"waveform": wave, "audio_mask": mask},
                        labels.astype(np.int64),
                        dialog_ids=np.arange(n) // 4)


class SeqNet(torch.nn.Module):
    """Masked mean and mean square of a waveform and its length → Dense."""

    def __init__(self):
        super().__init__()
        self.fc = Dense(3, 3, device="cpu")
        with torch.no_grad():
            self.fc.weight.copy_(torch.from_numpy(
                np.random.RandomState(2).randn(3, 3).astype(np.float32)))
            self.fc.bias.zero_()

    def forward(self, batch, rng=None):
        w, m = batch["waveform"], batch["audio_mask"].float()
        n = m.sum(1).clamp(min=1.0)
        return self.fc(torch.stack([(w * m).sum(1) / n,
                                    (w * w * m).sum(1) / n, n / 64], -1))


def loop_run(directory, dp, bucketed, sigterm_at=0, resume=False):
    """``train_network`` on ``SeqNet`` for three epochs (the second with
    dialog accumulation), under a dp=2 mesh or on one process, with or
    without length buckets; ``sigterm_at``: rank 0 sends itself SIGTERM
    at that batch-transform call. Returns the final parameters, the
    number of train steps and the last log."""
    import signal

    from mme_tpu_torch.config import ExperimentConfig
    from mme_tpu_torch.data.dataset import BucketedBatchIter
    from mme_tpu_torch.evals.metrics import Metrics
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import make_mesh
    from mme_tpu_torch.train import loop
    from mme_tpu_torch.train.losses import class_weights_from_counts
    from mme_tpu_torch.train.policies import sample_weights_from_labels
    from mme_tpu_torch.train.schedules import cosine_warm_restarts
    from mme_tpu_torch.train.steps import make_eval_step
    torch.set_num_threads(1)
    mesh = make_mesh(2, 1) if dp else None
    cfg = ExperimentConfig(batch_size=8, epoch=3, log_val=3, patience=10,
                           learning_rate=0.05, checkpoint_dir=directory)
    train_ds, val_ds = _seq_data(48, 0), _seq_data(16, 1)
    model = SeqNet()
    tx = make_optimizer(cosine_warm_restarts(cfg.learning_rate, cfg.T_max,
                                             6), 0.0, 1.0,
                        state_dtype="fp32")
    state = TrainState.create(model.parameters(), tx, use_accum=False,
                              names=[k for k, _ in model.named_parameters()])
    step = make_train_step(model, tx, num_classes=3, mesh=mesh)
    calls, transforms, logs = [], [], []

    def counted(*a):
        calls.append(1)
        return step(*a)

    def transform(rng, batch):
        transforms.append(1)
        if len(transforms) == sigterm_at and distributed.rank() == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch

    cw = class_weights_from_counts(np.bincount(train_ds.labels,
                                               minlength=3))
    loop.train_network(
        counted, make_eval_step(model, num_classes=3, mesh=mesh), state,
        train_ds, val_ds, cfg, Metrics(3, {0: "a", 1: "b", 2: "c"}), cw,
        sample_weights_from_labels(train_ds.labels, cw), 0,
        batch_transform=transform,
        callbacks=loop.LoopCallbacks(log=logs.append), resume=resume,
        batch_iter=BucketedBatchIter(LOOP_BOUNDS) if bucketed else None,
        mesh=mesh)
    return ([p.detach().numpy().copy() for p in model.parameters()],
            sum(calls), logs[-1])


# ------------------------------ parent side ------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(2, timeout_s=240) as p:
        yield p


def _random_stats(stats, rng):
    return {k: (_random_stats(v, rng) if isinstance(v, dict) else
                rng.rand(*v.shape).astype(np.float32)
                + (-0.5 if k == "mean" else 0.5))
            for k, v in stats.items()}


@pytest.fixture(scope="module")
def bn_vars():
    """The net's weights drawn by ``init_variables``, its running
    statistics random (a model that ignored them would fail)."""
    v = init_variables(BNNet(), seed=3)
    v["batch_stats"] = _random_stats(v["batch_stats"],
                                     np.random.RandomState(4))
    return v


def _jax_dp_reference(variables, x, labels, loss_name):
    """JAX over a 2-device dp mesh: the train objective's loss, gradients
    and mutated statistics, and the eval step's loss, cm and predictions."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mme_tpu.train.losses import make_loss_fn as j_make_loss_fn
    from mme_tpu.train.steps import make_eval_step as j_make_eval_step

    from flax import linen as fnn

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            y = fnn.Dense(16, use_bias=False, name="fc1")(x)
            y = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, name="bn")(y)
            return (fnn.Dense(3, name="fc2")(jax.nn.relu(y)),)

    net = JNet()
    loss_fn = j_make_loss_fn(loss_name, 1.0)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh,
                                                                 P("dp")))
    xs, ys, ms = put(x), put(labels), put(MASK)

    def objective(params, stats, x_, y_, m_):
        out, mutated = net.apply({"params": params, "batch_stats": stats},
                                 x_, train=True, mutable=["batch_stats"])
        return (loss_fn(out[0], y_, jnp.asarray(CW), m_),
                mutated["batch_stats"])

    (loss, stats), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(variables["params"],
                                  variables["batch_stats"], xs, ys, ms)

    def apply_fn(v, batch, deterministic=True, rngs=None):
        return net.apply(v, batch["image"], train=False)[0]

    ev = jax.jit(j_make_eval_step(apply_fn, 3, has_batch_stats=True,
                                  loss_fn=loss_fn))
    e_loss, e_cm, e_preds = ev(variables["params"],
                               variables["batch_stats"], {"image": xs}, ys,
                               ms, jnp.asarray(CW))
    return (float(loss), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, stats),
            (float(e_loss), np.asarray(e_cm), np.asarray(e_preds)))


@pytest.mark.parametrize("loss_name", ["CrossEntropy", "FBeta"])
def test_dp_step_matches_jax_dp_mesh(pool, bn_vars, loss_name):
    rng = np.random.RandomState(5)
    x = rng.randn(*X_SHAPE).astype(np.float32)
    labels = rng.randint(0, 3, X_SHAPE[0]).astype(np.int64)
    j_loss, j_grads, j_stats, (je_loss, je_cm, je_preds) = \
        _jax_dp_reference(bn_vars, x, labels, loss_name)
    ranks = pool.run(f"{HERE}:rank_dp_step", bn_vars, x, labels, MASK,
                     loss_name)
    want_g = dict(_flat(j_grads))
    j_norm = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                               for g in want_g.values())))
    for r in ranks:
        assert abs(r["loss"] - j_loss) <= 1e-5 * abs(j_loss)
        assert abs(r["norm"] - j_norm) <= 2e-4 * j_norm + 2e-5
        got_g = dict(_flat(r["grads"]))
        assert got_g.keys() == want_g.keys()
        for k, g in want_g.items():
            np.testing.assert_allclose(got_g[k], g, err_msg=str(k),
                                       **GRAD_TOL)
        for k, s in _flat(j_stats):
            np.testing.assert_allclose(dict(_flat(r["stats"]))[k], s,
                                       err_msg=str(k), **STAT_TOL)
        e_loss, e_cm, e_preds = r["eval"]
        assert abs(e_loss - je_loss) <= 1e-5 * abs(je_loss)
        np.testing.assert_array_equal(e_cm, je_cm)
        np.testing.assert_array_equal(e_preds, je_preds)
        assert r["cm"].sum() == MASK.sum()
    # the replicas agree bit for bit, and with one process on the whole
    # batch up to fp32 sums in another order
    a, b = ranks[0]["params"], ranks[1]["params"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    net, loss, norm, _, _ = _step(bn_vars, x, labels, MASK, loss_name,
                                  None)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(a[k], v.detach().numpy(), err_msg=k,
                                   **GRAD_TOL)


def test_moe_aux_under_dp_matches_jax(pool):
    """The aux loss E·Σ frac·mean_prob is bilinear: under dp it is the
    global batch's (JAX's on the whole batch), not the mean of the ranks'
    own."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mme_tpu.models import layers as j_layers
    from mme_tpu.models import moe as j_moe

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    proj = rng.standard_normal((2, 10, 16)).astype(np.float32)
    bias = np.zeros((2, 1, 1, 10), np.float32)
    bias[1, ..., 7:] = -0.7 * np.finfo(np.float32).max
    enc = j_moe.MoETransformerEncoder(
        j_layers.EncoderSpec(**MOE_SPEC, ln_style="pre"), j_moe.MoESpec())
    params = jax.tree.map(np.asarray, jax.jit(enc.init)(
        jax.random.PRNGKey(5), jnp.asarray(x))["params"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh,
                                                                 P("dp")))

    def loss(p, x_, b_, w_):
        y, inter = enc.apply({"params": p}, x_, b_,
                             mutable=["intermediates"])
        aux = j_moe.collect_aux_loss(inter["intermediates"])
        return jnp.sum(y * w_) + aux, aux

    (_, want_aux), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, put(x), put(bias), put(proj))
    ranks = pool.run(f"{HERE}:rank_moe", params, x, bias, proj)
    leaves = dict(_flat(jax.tree.map(np.asarray, want)))
    for aux, _, grads in ranks:
        np.testing.assert_allclose(aux, float(want_aux), atol=1e-5)
        got = dict(_flat(grads))
        assert got.keys() == leaves.keys()
        for path, b in leaves.items():
            np.testing.assert_allclose(
                got[path], b, rtol=0, err_msg=str(path),
                atol=1e-5 * max(np.abs(b).max(), 1e-6))
    mean_of_ranks = np.mean([alone for _, alone, _ in ranks])
    assert abs(mean_of_ranks - float(want_aux)) > 1e-4


def test_mesh_serving_matches_jax(pool):
    """tests/test_serve.py's mesh-serving inputs (11 rows, chunks of 8)
    through ``Predictor(mesh=dp2)``: JAX's mesh and single-device numbers,
    and a batch size that dp does not divide refused."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mme_tpu.serve import Predictor as JPredictor

    rng = np.random.RandomState(5)
    w = rng.randn(5, 3).astype(np.float32)
    x = rng.randn(11, 5).astype(np.float32)
    toy = lambda v, batch, deterministic=True, rngs=None: (
        batch["x"] @ v["params"]["w"])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    p_s, pr_s = JPredictor(toy, {"w": jnp.asarray(w)}, batch_size=8)({"x": x})
    p_m, pr_m = JPredictor(toy, {"w": jnp.asarray(w)}, batch_size=8,
                           mesh=mesh)({"x": x})
    for preds, probs, refused in pool.run(f"{HERE}:rank_serve", w, x):
        for p, pr in ((p_s, pr_s), (p_m, pr_m)):
            np.testing.assert_array_equal(preds, p)
            np.testing.assert_allclose(probs, pr, rtol=1e-6, atol=1e-7)
        assert refused


def test_cli_under_sp_and_dp_matches_single_rank(pool, tmp_path):
    """``tav_nn.main`` on two ranks: ``MME_SP=2`` on the fusion trunk (its
    sequence does not divide by 2: the padding path) and on the video
    tower, and the auto dp mesh (``MME_MESH`` on by default, dp=2 over the
    batch of 8), each against the single-rank run. Dropout, SpecAugment
    and the video keep-mask draw the global batch's numbers on every
    rank, so the runs see the same masks."""
    base = tmp_path / "single"
    base.mkdir()
    want = rank_cli(str(base), {})
    for tag, env in (("sp_fusion", {"MME_SP": "2"}),
                     ("sp_video", {"MME_SP": "2", "MME_SP_TOWER": "video"}),
                     ("dp", {})):
        d = tmp_path / tag
        d.mkdir()
        for loss, cm in pool.run(f"{HERE}:rank_cli", str(d), env):
            assert np.isfinite(loss)
            assert abs(loss - want[0]) < 2e-3, (tag, loss, want[0])
            np.testing.assert_array_equal(cm, want[1])
        assert (d / "checkpoints" / "best_meta.json").exists()


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["plain", "bucketed"])
def test_dp_loop_with_dialog_accumulation_matches_single_rank(
        pool, tmp_path, bucketed):
    want, n_want, _ = loop_run(str(tmp_path / "one"), False, bucketed)
    ranks = pool.run(f"{HERE}:loop_run", str(tmp_path / "dp"), True,
                     bucketed)
    for params, n, last in ranks:
        assert n == n_want
        for a, b in zip(params, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the replicas agree bit for bit
    for a, b in zip(ranks[0][0], ranks[1][0]):
        assert np.array_equal(a, b)


def test_dp_resume_ends_where_an_uninterrupted_dp_run_does(pool, tmp_path):
    """SIGTERM at rank 0's 12th batch-transform call: epoch 1's second
    step (epoch 0 takes 6 for its steps and 4 for its two validations of
    2 batches), not a log point."""
    whole = pool.run(f"{HERE}:loop_run", str(tmp_path / "whole"), True,
                     False)
    cut = str(tmp_path / "cut")
    first = pool.run(f"{HERE}:loop_run", cut, True, False, 12)
    for _, _, last in first:
        assert last["preempted"] is True and last["epoch"] == 1
    rest = pool.run(f"{HERE}:loop_run", cut, True, False, 0, True)
    for r in range(2):
        assert first[r][1] + rest[r][1] == whole[r][1]
        for a, b in zip(rest[r][0], whole[r][0]):
            assert np.array_equal(a, b)
