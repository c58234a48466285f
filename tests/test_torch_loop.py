"""The port's loop and what it stands on (mme_tpu_torch/{config,data,evals,
train/policies,train/early_stopping,train/loop,utils/profiling}.py) against
mme_tpu's on the same inputs.

Exact: the flag contract and ``config_from_args``, ``batches``, the bucketed
iterator, ``epoch_order``, ``DialogAccumulator``, ``dialog_counts``,
``synthetic_tav_dataset``, prediction dumps, ``EarlyStopping`` decisions,
``RunLogger`` records, the prefetched batches. Scores from a confusion
matrix: 1e-6 (fp32 on both sides). The loop on a two-layer MLP with its
dropout at 0, weights carried across, four epochs of the whole policy stack
(60 Adam steps at lr 5e-3): the final parameters within 1e-5 absolute
(measured 1.2e-6), confusion matrices equal, the scores from them within
1e-5, and the logged losses and gradient norms within 1e-4 relative (plus
1e-5 absolute). The losses get the looser bound because this MLP's logits
reach the tens: the first forward already differs by an fp32 ulp of a 4.7
loss (matmul sums in another order), and parameters 1e-7 apart give losses
2e-5 apart (measured up to 9.3e-5 relative, on a gradient norm of 0.008).
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from mme_tpu.core import config as j_config
from mme_tpu.data import dataset as j_dataset
from mme_tpu.data import prefetch as j_prefetch
from mme_tpu.data import synthetic as j_synthetic
from mme_tpu.evals import dumps as j_dumps
from mme_tpu.evals import metrics as j_metrics
from mme_tpu.models import fusion as j_fusion
from mme_tpu.train import early_stopping as j_early
from mme_tpu.train import loop as j_loop
from mme_tpu.train import policies as j_policies
from mme_tpu.train import steps as j_steps
from mme_tpu.train.losses import class_weights_from_counts
from mme_tpu.train.schedules import cosine_warm_restarts as j_cosine
from mme_tpu.utils import profiling as j_profiling

from mme_tpu_torch import config
from mme_tpu_torch.data import dataset, prefetch, synthetic
from mme_tpu_torch.evals import dumps, metrics
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.train import early_stopping, loop, policies, steps
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.utils import profiling

torch.set_num_threads(2)

# ---- (a) the numpy pieces and the flag contract, exactly -------------------

ARGVS = [[], ["-l", "0.01", "-e", "5", "-b", "8", "--mask", "True",
              "-ls", "FBeta", "-beta", "2", "-s", "7", "-d", "synthetic"],
         ["--learning_rate", "3e-4", "-es", "3", "-p", "2.5", "-t", "4",
          "-m", "TAVFormer", "-lt", "sentiment", "-y", "3", "-o", "16,16",
          "-ed", "yes", "-dr", "0.1", "-nl", "6", "-lpe", "false"]]


@pytest.mark.parametrize("argv", ARGVS)
@pytest.mark.parametrize("mesh_env", [{}, {"MME_MP": "2", "MME_DP": "4"}])
def test_config_from_args_matches_jax(argv, mesh_env, monkeypatch):
    for k, v in mesh_env.items():
        monkeypatch.setenv(k, v)
    want = j_config.config_from_args(j_config.arg_parse("tav_nn", argv),
                                     log_val=7)
    got = config.config_from_args(config.arg_parse("tav_nn", argv),
                                  log_val=7)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hidden_layer_dims == want.hidden_layer_dims
    sweep = {"dropout": 0.25, "batch_size": 4, "not_a_field": 1}
    assert (dataclasses.asdict(config.apply_sweep_overrides(got, sweep))
            == dataclasses.asdict(j_config.apply_sweep_overrides(want,
                                                                 sweep)))


def test_config_defaults_and_helpers_match_jax():
    assert (dataclasses.asdict(config.ExperimentConfig())
            == dataclasses.asdict(j_config.ExperimentConfig()))
    for s in ("32", "32,16", "1,2,3,4"):
        assert config.hidden_layer_count(s) == j_config.hidden_layer_count(s)
    with pytest.raises(ValueError):
        config.hidden_layer_count("1,2,3")
    for v in ("True", "no", "1", "F", True):
        assert config._str2bool(v) == j_config._str2bool(v)


@pytest.mark.parametrize("var", ["MME_COORDINATOR", "MME_NUM_PROCESSES"])
def test_multi_host_config_is_refused(var, monkeypatch):
    """``config_from_args`` joins the multi-process runtime; half of the
    env contract is refused before any rendezvous, naming what is
    missing."""
    for v in ("MME_COORDINATOR", "MME_NUM_PROCESSES", "MME_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, "2")
    with pytest.raises(ValueError, match="MME_PROCESS_ID"):
        config.config_from_args(config.arg_parse("tav_nn", []))


@pytest.mark.parametrize("device,backend,rank_device", [
    ("cpu", "gloo", None), ("cuda", "nccl", "cuda:1")])
def test_backend_follows_requested_device(device, backend, rank_device,
                                          monkeypatch):
    """``config_from_args(device=)`` joins with the backend of the device
    the caller asked for, not of the card the machine has: a CPU run on a
    machine with a card takes gloo and leaves the card alone. The rendezvous
    is stubbed; the host is made to show two cards."""
    import torch.distributed as dist
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.update(set_device=str(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **k: seen.update(k))
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.delenv("MME_DIST_BACKEND", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("MME_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MME_NUM_PROCESSES", "2")
    monkeypatch.setenv("MME_PROCESS_ID", "1")
    config.config_from_args(config.arg_parse("tav_nn", []), device=device)
    assert seen["backend"] == backend
    assert (seen["world_size"], seen["rank"]) == (2, 1)
    assert seen.get("set_device") == rank_device


def _ds(mod, n=23, seed=3):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(100, 1001, n)
    t = np.arange(1000)[None, :]
    feats = {"x": rng.randn(n, 4).astype(np.float32),
             "waveform": rng.randn(n, 1000).astype(np.float32),
             "audio_mask": (t < lengths[:, None]).astype(np.int32)}
    return mod.ArrayDataset(feats, rng.randint(0, 3, n).astype(np.int64),
                            dialog_ids=np.repeat(np.arange(6), 4)[:n])


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, dict):
                assert u.keys() == v.keys()
                for k in u:
                    np.testing.assert_array_equal(u[k], v[k])
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("batch_size", [1, 5, 8])
def test_batches_and_buckets_match_jax(batch_size):
    jd, pd = _ds(j_dataset), _ds(dataset)
    order = np.random.RandomState(0).permutation(len(jd))
    _same_batches(dataset.batches(pd, order, batch_size),
                  j_dataset.batches(jd, order, batch_size))
    bounds = (250, 500, 1000)
    jit, pit = j_dataset.BucketedBatchIter(bounds), \
        dataset.BucketedBatchIter(bounds)
    assert (pit.epoch_len(pd, order, batch_size)
            == jit.epoch_len(jd, order, batch_size))
    _same_batches(pit(pd, order, batch_size), jit(jd, order, batch_size))
    lengths = pd.features["audio_mask"].sum(1)
    _same_batches(
        dataset.bucketed_batches(pd, order, batch_size, lengths, bounds),
        j_dataset.bucketed_batches(jd, order, batch_size, lengths, bounds))


def test_policies_match_jax():
    w = np.random.RandomState(1).rand(30) + 0.1
    jr, pr = np.random.default_rng(5), np.random.default_rng(5)
    for epoch in range(5):
        np.testing.assert_array_equal(
            policies.epoch_order(pr, epoch, 2, w, 30),
            j_policies.epoch_order(jr, epoch, 2, w, 30))
    labels = np.random.RandomState(2).randint(0, 4, 30)
    cw = np.linspace(0.2, 0.9, 4)
    np.testing.assert_array_equal(
        policies.sample_weights_from_labels(labels, cw),
        j_policies.sample_weights_from_labels(labels, cw))
    ids = np.random.RandomState(3).randint(0, 9, 40)
    assert policies.dialog_counts(ids) == j_policies.dialog_counts(ids)
    counts = policies.dialog_counts(ids)
    pa, ja = (policies.DialogAccumulator(counts),
              j_policies.DialogAccumulator(counts))
    assert [pa.step(i) for i in range(45)] == [ja.step(i) for i in range(45)]


def test_synthetic_tav_dataset_matches_jax():
    got = synthetic.synthetic_tav_dataset(TAVSpec().tiny(), 10, text_len=9,
                                          audio_len=300, seed=4,
                                          dialog_size=3)
    want = j_synthetic.synthetic_tav_dataset(j_fusion.TAVSpec().tiny(), 10,
                                             text_len=9, audio_len=300,
                                             seed=4, dialog_size=3)
    assert got.features.keys() == want.features.keys()
    for k in want.features:
        assert got.features[k].dtype == want.features[k].dtype
        np.testing.assert_array_equal(got.features[k], want.features[k])
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.dialog_ids, want.dialog_ids)


def test_prediction_dumps_match_jax(tmp_path):
    labels, preds = np.array([0, 3, 2, 1]), np.array([0, 1, 2, 2])
    mask = np.array([1, 1, 0, 1])
    for mod, name in ((dumps, "p.txt"), (j_dumps, "j.txt")):
        mod.dump_predictions(str(tmp_path / "d" / name), labels, preds, mask)
        mod.dump_predictions(str(tmp_path / "d" / name), labels[:1],
                             preds[:1])
    text = (tmp_path / "d" / "p.txt").read_text()
    assert text == (tmp_path / "d" / "j.txt").read_text()
    for a, b in zip(dumps.load_dump(str(tmp_path / "d" / "p.txt")),
                    j_dumps.load_dump(str(tmp_path / "d" / "j.txt"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_early_stopping_matches_jax(mode, tmp_path):
    seq = [0.9, 0.8, 0.85, 0.8, 0.7, 0.71, 0.72, 0.73, 0.6]
    p = early_stopping.EarlyStopping(patience=3, min_delta=0.005, mode=mode,
                                     save_path=str(tmp_path / "p.pkl"))
    j = j_early.EarlyStopping(patience=3, min_delta=0.005, mode=mode)
    w = torch.zeros(3)
    for i, m in enumerate(seq):
        w += 1.0                       # updated in place, like parameters
        state = {"w": w, "step": i}
        assert p(m, state) == j(m, {"w": w.numpy().copy(), "step": i})
        assert (p.counter, p.best_metric) == (j.counter, j.best_metric)
        best = j.restore_best()
        assert p.restore_best()["step"] == best["step"]
        np.testing.assert_array_equal(p.restore_best()["w"].numpy(),
                                      best["w"])
    fresh = early_stopping.EarlyStopping(save_path=str(tmp_path / "p.pkl"))
    assert fresh.restore_best()["step"] == j.restore_best()["step"]


def test_run_logger_and_step_timer_match_jax(tmp_path, monkeypatch, capsys):
    rows = [{"train/loss": np.float32(1.5), "epoch": 0},
            {"val/confusion_matrix": [[1, 0], [2, 3]],
             "val/loss": torch.tensor(0.25)}]
    for mod, name in ((profiling, "p"), (j_profiling, "j")):
        lg = mod.RunLogger(str(tmp_path / name))
        for r in rows:
            lg.log(r if mod is profiling else
                   {k: (v.item() if isinstance(v, torch.Tensor) else v)
                    for k, v in r.items()})
        lg.finish()
    read = lambda n: [{k: v for k, v in json.loads(line).items()
                       if k != "_time"}
                      for line in open(tmp_path / n / "metrics.jsonl")]
    assert read("p") == read("j")
    # MME_WANDB=1 without wandb: JSONL only, with the same notice
    monkeypatch.setenv("MME_WANDB", "1")
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    profiling.RunLogger(str(tmp_path / "w")).log({"a": 1})
    assert "logging JSONL only" in capsys.readouterr().out
    assert (tmp_path / "w" / "metrics.jsonl").exists()

    ticks = iter([0.0, 0.5, 0.75, 1.5, 2.0, 4.0])
    clock = lambda: next(ticks)
    monkeypatch.setattr(time, "perf_counter", clock)
    pt, jt = profiling.StepTimer(window=3), j_profiling.StepTimer(window=3)
    for _ in range(3):
        pt.tick()
        jt._times.append(pt._times[-1])
        assert pt.steps_per_sec == jt.steps_per_sec


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    ds = _ds(dataset)
    with profiling.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
        fed = prefetch.prefetch_batches(
            dataset.batches(ds, np.arange(len(ds)), 4), device="cpu")
        next(fed)
        fed.close()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # the program's own span, in the same timeline
    assert any(e.get("name") == "mme.prefetch.wait" for e in events)
    with profiling.profile_trace(None):
        pass


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_matches_jax_and_stops_when_abandoned():
    ds = _ds(dataset)
    order = np.arange(len(ds))
    got = [(({k: v.numpy() for k, v in b.items()}), l, m, i) for b, l, m, i
           in prefetch.prefetch_batches(dataset.batches(ds, order, 4),
                                        device="cpu")]
    want = [({k: np.asarray(v) for k, v in b.items()}, l, m, i)
            for b, l, m, i in j_prefetch.prefetch_batches(
                j_dataset.batches(ds, order, 4))]
    _same_batches(got, want)
    assert all(isinstance(m, np.ndarray) for _, _, m, _ in got)

    def failing():
        yield from dataset.batches(ds, order[:8], 4)
        raise KeyError("producer fault")

    seen = []
    with pytest.raises(KeyError, match="producer fault"):
        for item in prefetch.prefetch_batches(failing(), device="cpu"):
            seen.append(item)
    assert len(seen) == 2

    it = prefetch.prefetch_batches(dataset.batches(ds, order, 1),
                                   device="cpu", depth=1)
    next(it)
    it.close()
    deadline = time.time() + 5
    while any(t.name == "mme-prefetch" for t in threading.enumerate()):
        assert time.time() < deadline, "producer outlived its consumer"
        time.sleep(0.05)


# ---- (b) scores from a confusion matrix ------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_and_summary_match_jax(seed):
    rng = np.random.RandomState(seed)
    c = 7
    cm = rng.randint(0, 9, (c, c)).astype(np.int32)
    cm[rng.randint(c)] = 0                  # a class absent from targets
    got = metrics.scores_from_confusion(torch.from_numpy(cm))
    want = j_metrics.scores_from_confusion(jnp.asarray(cm))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    labels = {i: f"c{i}" for i in range(c)}
    pm, jm = metrics.Metrics(c, labels), j_metrics.Metrics(c, labels)
    preds, target = rng.randint(0, c, 50), rng.randint(0, c, 50)
    w = (rng.rand(50) > 0.2).astype(np.int32)
    pm.update_metrics(torch.from_numpy(preds), torch.from_numpy(target),
                      torch.from_numpy(w))
    jm.update_metrics(jnp.asarray(preds), jnp.asarray(target),
                      jnp.asarray(w))
    pm.merge(torch.from_numpy(cm))
    jm.merge(jnp.asarray(cm))
    for a, b in zip(pm.compute_scores("val"), jm.compute_scores("val")):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(list(a.values()), list(b.values()),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    sp, sj = pm.summary("val", True), jm.summary("val", True)
    assert list(sp) == list(sj)
    assert sp["val/confusion_matrix"] == sj["val/confusion_matrix"]
    np.testing.assert_allclose(
        [v for k, v in sp.items() if k != "val/confusion_matrix"],
        [v for k, v in sj.items() if k != "val/confusion_matrix"],
        rtol=1e-6, atol=1e-6)
    pm.reset_metrics()
    assert int(pm.cm.sum()) == 0


# ---- (c) the loop on a two-layer MLP ---------------------------------------

class JTinyMLP(fnn.Module):
    """``tests/test_train_loop.py``'s TinyMLP with its dropout at 0."""

    classes: int = 3

    @fnn.compact
    def __call__(self, batch, *, deterministic=True):
        x = fnn.relu(fnn.Dense(32)(batch["x"]))
        x = fnn.Dropout(0.0)(x, deterministic=deterministic)
        return fnn.Dense(self.classes)(x)


class TinyMLP(torch.nn.Module):
    """The same MLP over the flax tree's arrays, kept in the flax layout."""

    def __init__(self, params):
        super().__init__()
        self.k0, self.b0, self.k1, self.b1 = (
            torch.nn.Parameter(torch.tensor(np.asarray(params[m][n])))
            for m in ("Dense_0", "Dense_1") for n in ("kernel", "bias"))

    def forward(self, batch, rng=None):
        h = torch.relu(batch["x"] @ self.k0 + self.b0)
        return h @ self.k1 + self.b1


_CENTERS = np.random.RandomState(123).randn(3, 8) * 3


def mlp_data(mod, n=240, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, n)
    x = _CENTERS[labels] + rng.randn(n, 8)
    return mod.ArrayDataset({"x": x.astype(np.float32)},
                            labels.astype(np.int64),
                            dialog_ids=np.repeat(np.arange(n // 4), 4)[:n])


MLP_CFG = dict(epoch=4, batch_size=16, learning_rate=5e-3, epoch_switch=2,
               patience=50, T_max=2, log_val=5, output_dim=3)
# the whole run, and tests/test_train_loop.py's patience case: at lr 0 the
# validation loss never improves again, so patience 1 breaks the run at
# its second validation
RUNS = [("full", {}),
        ("patience", {"patience": 1.0, "epoch": 50, "log_val": 2,
                      "learning_rate": 0.0})]


def mlp_params():
    return jax.tree.map(np.asarray, JTinyMLP().init(
        jax.random.PRNGKey(0), {"x": jnp.zeros((1, 8), jnp.float32)})[
        "params"])


def port_mlp_run(params, ckdir, resume=False, transform=None, **cfg):
    """The port's loop on TinyMLP; returns (model, state, logs, steps)."""
    cfg = config.ExperimentConfig(**dict(MLP_CFG, **cfg),
                                  checkpoint_dir=str(ckdir))
    train_ds = mlp_data(dataset)
    model = TinyMLP(params)
    n = int(np.ceil(len(train_ds) / cfg.batch_size))
    tx = steps.make_optimizer(cosine_warm_restarts(cfg.learning_rate,
                                                   cfg.T_max, n),
                              cfg.weight_decay, cfg.clip, state_dtype="fp32")
    state = steps.TrainState.create(
        model.parameters(), tx, use_accum=False,
        names=[k for k, _ in model.named_parameters()])
    step = steps.make_train_step(model, tx, num_classes=3)
    calls = []

    def counted(*a):
        calls.append(1)
        return step(*a)

    cw = class_weights_from_counts(np.bincount(train_ds.labels, minlength=3))
    sw = policies.sample_weights_from_labels(train_ds.labels, cw)
    logs = []
    kw = {} if transform is None else {"batch_transform": transform}
    state = loop.train_network(
        counted, steps.make_eval_step(model, num_classes=3), state, train_ds,
        mlp_data(dataset, 60, 1), cfg, metrics.Metrics(3, {0: "a", 1: "b",
                                                           2: "c"}),
        cw, sw, 0, callbacks=loop.LoopCallbacks(log=logs.append),
        resume=resume, **kw)
    return model, state, logs, len(calls)


@pytest.fixture(scope="module")
def jax_mlp_runs(tmp_path_factory):
    """JAX's train_network on TinyMLP for each config of the parity test:
    (logs, train steps, final params, test summary)."""
    out = {}
    params = mlp_params()
    for key, extra in RUNS:
        cfg = j_config.ExperimentConfig(
            **dict(MLP_CFG, **extra),
            checkpoint_dir=str(tmp_path_factory.mktemp("jck")))
        train_ds = mlp_data(j_dataset)
        model = JTinyMLP()

        def apply_fn(variables, batch, deterministic=True, rngs=None,
                     mutable=None):
            return model.apply(variables, batch, deterministic=deterministic,
                               rngs=rngs)

        n = int(np.ceil(len(train_ds) / cfg.batch_size))
        tx = j_steps.make_optimizer(j_cosine(cfg.learning_rate, cfg.T_max, n),
                                    cfg.weight_decay, cfg.clip)
        state = j_steps.TrainState.create(jax.tree.map(jnp.asarray, params),
                                          tx)
        step = j_steps.make_train_step(apply_fn, tx, num_classes=3)
        calls = []

        def counted(*a):
            calls.append(1)
            return step(*a)

        eval_step = j_steps.make_eval_step(apply_fn, num_classes=3)
        cw = class_weights_from_counts(np.bincount(train_ds.labels,
                                                   minlength=3))
        sw = j_policies.sample_weights_from_labels(train_ds.labels, cw)
        logs = []
        metric = j_metrics.Metrics(3, {0: "a", 1: "b", 2: "c"})
        state = j_loop.train_network(
            counted, eval_step, state, train_ds, mlp_data(j_dataset, 60, 1),
            cfg, metric, cw, sw, jax.random.PRNGKey(0),
            callbacks=j_loop.LoopCallbacks(log=logs.append))
        test = j_loop.evaluate(eval_step, state, mlp_data(j_dataset, 60, 2),
                               cfg, metric)
        out[key] = (logs, len(calls), jax.tree.map(np.asarray, state.params),
                    test)
    return params, out


def assert_logs_match(got, want, tol=1e-5, loss_rtol=1e-4):
    """Every logged dict: lists and epochs equal, losses and gradient norms
    within ``loss_rtol`` relative, other numbers within ``tol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k.endswith("steps_per_sec"):
                continue
            if isinstance(v, list) or k == "epoch":
                assert g[k] == v, k
            elif k.endswith(("loss", "grad_norm")):
                np.testing.assert_allclose(g[k], v, rtol=loss_rtol, atol=tol,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g[k], v, rtol=tol, atol=tol,
                                           err_msg=k)


@pytest.mark.parametrize("key,extra", RUNS)
def test_loop_on_mlp_matches_jax(jax_mlp_runs, key, extra, tmp_path):
    params, runs = jax_mlp_runs
    want_logs, want_steps, want_params, want_test = runs[key]
    model, state, logs, n_steps = port_mlp_run(params, tmp_path / "ck",
                                               **extra)
    assert n_steps == want_steps
    if key == "full":
        assert n_steps == 60 and len(logs) == 2 * 4 * 3  # 3 log points/epoch
        assert {d["epoch"] for d in logs if "epoch" in d} == {0, 1, 2, 3}
    else:
        assert n_steps == 4 and len(logs) == 4   # broke at validation 2
    assert_logs_match(logs, want_logs)
    for (m, n), p in zip([(m, n) for m in ("Dense_0", "Dense_1")
                          for n in ("kernel", "bias")],
                         (model.k0, model.b0, model.k1, model.b1)):
        np.testing.assert_allclose(p.detach().numpy(), want_params[m][n],
                                   rtol=0, atol=1e-5, err_msg=f"{m}/{n}")
    test = loop.evaluate(steps.make_eval_step(model, num_classes=3), state,
                         mlp_data(dataset, 60, 2),
                         config.ExperimentConfig(**MLP_CFG),
                         metrics.Metrics(3, {0: "a", 1: "b", 2: "c"}))
    assert_logs_match([test], [want_test])


# ---- (d) prefetch on and off give the same run ------------------------------

def test_loop_with_prefetch_off_gives_the_same_run(monkeypatch, tmp_path):
    params = mlp_params()
    model_on, _, logs_on, _ = port_mlp_run(params, tmp_path / "on", epoch=2)
    monkeypatch.setenv("MME_PREFETCH", "0")
    model_off, _, logs_off, _ = port_mlp_run(params, tmp_path / "off",
                                             epoch=2)
    assert_logs_match(logs_off, logs_on, tol=0, loss_rtol=0)
    for a, b in zip(model_on.parameters(), model_off.parameters()):
        assert torch.equal(a, b)
