"""The port's pipeline parallelism (mme_tpu_torch/parallel/pipeline.py, the
pp branch of models/layers.py::TransformerEncoder, the stage rule of
parallel/sharding_rules.py::sync_grads, cli/tav_nn.py's ``MME_PP``)
against mme_tpu on the same numpy-seeded inputs and flax weights.

The port's side runs in pools of CPU ranks joined by gloo
(``parallel/launch.py::RankPool``, module fixtures): four ranks for the
encoder and the dp x pp step, two for the CLI. The rank-side functions
import no JAX: the workers import this file by path. JAX's side runs
``pipeline_encoder_apply`` on the virtual CPU devices of
tests/conftest.py, one program per case.

- The stage trees: ``stack_encoder_params`` / ``stage_params`` against
  JAX's stacking and its [P, k, ...] reshape.
- The pipelined encoder (4 pre-LN layers of JAX's tests/test_pipeline.py)
  against JAX's ``pipeline_encoder_apply`` for P in {2, 4} and M in
  {1, 2, 4}, with and without a key bias and the final LayerNorm: the
  output, with and without gradients recorded, at rtol = atol = 2e-5
  (tests/test_pipeline.py); P=2 runs on a ("dp", "pp") mesh of 2 x 2
  whose dp lines compute the same batch. Gradients of sum(y²) leaf by
  leaf after ``sync_grads`` at rtol 5e-4 / atol 5e-5
  (test_pipeline_gradients_match_sequential's), and the input's gradient
  the same on every rank.
- The gradient sync: a stage leaf's gradient, held by one pp rank, is
  summed over pp; a replicated leaf keeps its value (the mean of equal
  copies).
- dp x pp on four ranks: the tiny TAV's train step (fusion trunk as two
  stages of two microbatches, dp=2) against the one-rank step: loss, the
  confusion matrix, every gradient the optimizer is handed within 1e-4 of
  its largest element (tests/test_torch_tensor_parallel.py's tolerance);
  a checkpoint written under pp (rank 0 writes) restores leaf for leaf
  into a fresh pp state and on one rank.
- Dropout: the pipeline refuses training without a generator; with one,
  every stage takes the masks the sequential stack draws (JAX's pipeline
  folds (stage, microbatch) into its key instead, so its masks differ
  from its sequential run's), so the output and gradients are the
  sequential encoder's at the tolerances above, the step's generator ends
  in the same state on every rank and where the sequential stack leaves
  it, and the tiny TAV's dp x pp step with a dropout trunk matches the
  one-rank step.
- ``tav_nn.main`` with ``MME_PP=2 MME_PP_MICRO=2`` on two ranks (the
  fusion and the audio tower) against the one-rank run, as JAX's
  tests/test_sp_pp_training.py::_assert_matches holds its pp runs: test
  loss within 2e-3 and the same confusion matrix; the fusion run with
  ``MME_MP=2`` (the caller's mesh wins: no mp axis), ``MME_PREDICT_OUT``
  and ``MME_EXPORT_BUNDLE`` (every prediction the one-rank run's, the
  bundle serving what the one-rank bundle serves); and ``-m TAVMoE``,
  whose MoE trunk has no pipeline branch in JAX either
  (``mme_tpu/models/moe.py``): it runs whole on every rank.
- The refusals of ``parallel_spec`` before any work, with JAX's messages.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from mme_tpu_torch.cli import tav_nn
from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import from_flax, grads_to_flax, init_params
from mme_tpu_torch.convert import init_variables, to_flax
from mme_tpu_torch.models.fusion import TAVSpec
from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
from mme_tpu_torch.parallel.launch import RankPool
from mme_tpu_torch.parallel.pipeline import (stack_encoder_params,
                                             stage_params,
                                             unstack_to_encoder_params)
from mme_tpu_torch.train.build_tav import build_tav, example_tav_batch

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
# tests/test_pipeline.py::make_encoder: 4 pre-LN layers, hidden 16, 2 heads
ENC = dict(hidden=16, heads=2, layers=4, intermediate=32, ln_style="pre")
X_SHAPE = (8, 6, 16)
# (P, M, key bias, final LayerNorm): every P and M, each option on and off
CASES = [(2, 1, True, True), (2, 2, False, False), (2, 4, True, False),
         (4, 1, False, True), (4, 2, True, False), (4, 4, True, True)]
SPEC = TAVSpec().tiny()
B = 8
CFG = dict(batch_size=B, text_max_len=12, audio_max_samples=400)
LABELS = np.arange(B, dtype=np.int64) % 7
MASK = np.ones(B, np.int32)
CW = np.ones(7, np.float32)
# the tiny TAV with dropout in its fusion trunk as well (the flagship
# trunk has none)
TRUNK_DROP = dataclasses.replace(SPEC, fusion=dataclasses.replace(
    SPEC.fusion, dropout=0.4))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _quiet(spec):
    """Every dropout rate and SpecAugment probability 0."""
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


def _batch():
    b = example_tav_batch(SPEC, B, 12, 400, seed=1)
    b["text_mask"][1, 7:] = 0
    b["audio_mask"][2, 250:] = 0
    return b


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _handed(into: list):
    """The gradients each optimizer update is handed (after the step's
    sync over the ranks, before the clip)."""
    from mme_tpu_torch.train.optim import Optimizer
    plain = Optimizer.update

    def noted(self, params, grads, state, generator=None):
        into.append([g.detach().clone() for g in grads])
        return plain(self, params, grads, state, generator)

    Optimizer.update = noted
    try:
        yield into
    finally:
        Optimizer.update = plain


# ---------------- rank side (the pools' workers; no JAX) ----------------

def _pp_mesh(P):
    """P=4: a ("pp",) mesh of the pool's four ranks; P=2: ("dp", "pp") of
    2 x 2."""
    from mme_tpu_torch.parallel.mesh import Mesh
    return Mesh(("pp",), (4,)) if P == 4 else Mesh(("dp", "pp"), (2, 2))


def _encoder(variables, mesh=None, micro=4, **kw):
    spec = EncoderSpec(**{**ENC, **kw})
    if mesh is not None:
        spec = dataclasses.replace(spec, pp_mesh=mesh, pp_axis="pp",
                                   pp_micro=micro)
    enc = TransformerEncoder(spec, device="cpu")
    enc.load_state_dict(from_flax(variables["params"]), strict=True)
    return enc


def rank_encoder(P, M, final_ln, variables, x, bias):
    """The pipelined encoder in eval mode: its output without and with
    gradients recorded, the input's gradient of sum(y²) and, after
    ``sync_grads``, every parameter's gradient in the flax layout."""
    from mme_tpu_torch.parallel.sharding_rules import stage_of, sync_grads
    torch.set_num_threads(1)
    mesh = _pp_mesh(P)
    enc = _encoder(variables, mesh, M, final_ln=final_ln).eval()
    b = None if bias is None else torch.from_numpy(bias)
    with torch.no_grad():
        y_eval = enc(torch.from_numpy(x), b).numpy()
    xt = torch.from_numpy(x).requires_grad_()
    y = enc(xt, b)
    params = list(enc.parameters())
    dx, *grads = torch.autograd.grad((y ** 2).sum(), [xt] + params,
                                     allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    stages = sum(stage_of(p) is not None for p in params)
    grads = sync_grads(grads, params, mesh)
    return {"y_eval": y_eval, "y": y.detach().numpy(), "dx": dx.numpy(),
            "stage_leaves": stages,
            "grads": dict(_flat(grads_to_flax(enc, grads)))}


def rank_sync(stage_value, replicated_value):
    """``sync_grads`` on a 2 x 2 ("dp", "pp") mesh of one stage leaf, whose
    gradient is ``stage_value`` times (dp index + 1) on pp index 0 and
    zero on pp index 1, and one replicated leaf, ``replicated_value``
    times (dp index + 1) on every pp rank."""
    from mme_tpu_torch.parallel.sharding_rules import mark_stage, sync_grads
    mesh = _pp_mesh(2)
    stage = torch.nn.Parameter(torch.zeros(3))
    plain = torch.nn.Parameter(torch.zeros(3))
    mark_stage([stage], mesh.axis("pp"))
    dp, pp = mesh.coords["dp"], mesh.coords["pp"]
    g_stage = torch.full((3,), stage_value * (dp + 1) * (pp == 0))
    g_plain = torch.full((3,), replicated_value * (dp + 1))
    out = sync_grads([g_stage, g_plain], [stage, plain], mesh)
    return out[0].numpy(), out[1].numpy()


def _step(params, mesh=None, spec=None, steps=1):
    """Train steps of the tiny TAV from ``params`` on the batch (this
    rank's dp rows under a mesh, the fusion trunk as a pipeline of two
    microbatches over its pp axis): (model, state, loss, cm, the handed
    gradients, the step generator)."""
    from mme_tpu_torch.parallel.mesh import shard_batch
    spec = _quiet(SPEC) if spec is None else spec
    batch, labels, mask = _batch(), LABELS, MASK
    if mesh is not None:
        spec = dataclasses.replace(spec, fusion=dataclasses.replace(
            spec.fusion, pp_mesh=mesh, pp_axis="pp", pp_micro=2))
        local = shard_batch({**batch, "_l": labels, "_m": mask}, mesh)
        labels, mask = local.pop("_l"), local.pop("_m")
        batch = local
    with _env(MME_OPT_STATE="fp32"):
        model, state, step, _ = build_tav(
            spec, ExperimentConfig(**CFG), 10, params=params, remat=False,
            use_accum=False, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    seen: list = []
    with _handed(seen):
        for _ in range(steps):
            _, loss, cm, _ = step(state, batch, labels, mask, CW, 1.0, True,
                                  gen)
    return model, state, float(loss), cm.numpy(), seen[0], gen


def rank_dp_pp_step(params, save_dir):
    """The dp=2 x pp=2 fp32 step of the quiet tiny TAV: loss, cm and the
    handed gradients by parameter name; its state written to
    ``save_dir`` (rank 0 writes) and read back into a fresh pp state."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.parallel.mesh import Mesh
    from mme_tpu_torch.parallel.sharding_rules import stage_of
    from mme_tpu_torch.train.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    mesh = Mesh(("dp", "pp"), (2, 2))
    model, state, loss, cm, grads, _ = _step(params, mesh)
    names = [n for n, _ in model.named_parameters()]
    out = {"loss": loss, "cm": cm,
           "stage_leaves": sum(stage_of(p) is not None for p in state.params),
           "grads": {n: g.numpy() for n, g in zip(names, grads)},
           "params": dict(_flat(to_flax(model)))}
    CheckpointManager(save_dir, use_async=False).save_best(
        state, {"val_loss": loss})
    model2, fresh, *_ = _step(params, mesh)
    CheckpointManager(save_dir, use_async=False).restore_best(fresh)
    out["restored"] = dict(_flat(to_flax(model2)))
    if distributed.rank() != 0:
        out.pop("params"), out.pop("restored")
    return out


def rank_dropout(variables, x, seed):
    """The pipelined encoder with dropout in training mode on a ("pp",)
    mesh of 4: the refusal without a generator; with one, the output, the
    input's gradient and every gradient after ``sync_grads`` of sum(y · x),
    and the generator's state after; then a dp x pp TAV step with dropout
    in the fusion trunk: its loss, the handed gradients and the step
    generator's state."""
    from mme_tpu_torch.parallel.mesh import Mesh
    from mme_tpu_torch.parallel.sharding_rules import sync_grads
    torch.set_num_threads(1)
    mesh = _pp_mesh(4)
    enc = _encoder(variables, mesh, 4, dropout=0.4,
                   attention_dropout=0.2).train()
    try:
        enc(torch.from_numpy(x))
        refused = None
    except ValueError as e:
        refused = str(e)
    out = {"refused": refused, **_dropout_run(enc, x, seed)}
    params = list(enc.parameters())
    out["grads"] = dict(_flat(grads_to_flax(enc, sync_grads(
        out.pop("grads"), params, mesh))))
    _, _, loss, _, grads, gen = _step(init_params(SPEC, 0),
                                      Mesh(("dp", "pp"), (2, 2)), TRUNK_DROP)
    out["tav"] = {"loss": loss, "grads": [g.numpy() for g in grads],
                  "gen_state": gen.get_state().numpy()}
    return out


def _dropout_run(enc, x, seed):
    xt = torch.from_numpy(x).requires_grad_()
    gen = torch.Generator().manual_seed(seed)
    y = enc(xt, None, gen)
    params = list(enc.parameters())
    dx, *grads = torch.autograd.grad((y * xt.detach()).sum(), [xt] + params,
                                     allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "grads": grads,
            "gen_state": gen.get_state().numpy()}


CLI_ARGV = ["-d", "synthetic", "-e", "1", "-b", "8", "-y", "7", "-l",
            "1e-4", "-p", "50"]
CLI_ENV = ("MME_SP", "MME_PP", "MME_PP_MICRO", "MME_PP_TOWER", "MME_MP",
           "MME_DP", "MME_MESH", "MME_PREDICT_OUT", "MME_EXPORT_BUNDLE",
           "MME_RUN_DIR")


def rank_cli(directory, env, argv=()):
    """``tav_nn.main`` on the CPU in ``directory`` with ``env`` set: the
    test loss, confusion matrix and the lines it printed that are not
    JSON."""
    torch.set_num_threads(1)
    old = {k: os.environ.get(k) for k in CLI_ENV}
    cwd = os.getcwd()
    for k in CLI_ENV:
        os.environ.pop(k, None)
    os.environ.update(env)
    os.chdir(directory)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            s = tav_nn.main(CLI_ARGV + list(argv), device="cpu")
    finally:
        os.chdir(cwd)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = [x for x in printed.getvalue().splitlines()
             if not x.startswith("{")]
    return s["test/loss"], np.asarray(s["test/confusion_matrix"]), lines


# ------------------------------ parent side ------------------------------

@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, timeout_s=300) as p:
        yield p


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, timeout_s=300) as p:
        yield p


def _variables(final_ln=False, seed=1, **kw):
    return init_variables(TransformerEncoder(
        EncoderSpec(**{**ENC, **kw}, final_ln=final_ln), device="meta"),
        seed)


def _x():
    return np.random.default_rng(0).standard_normal(X_SHAPE).astype(
        np.float32)


def _bias():
    from mme_tpu.ops.attention import additive_mask
    keep = np.random.default_rng(2).uniform(size=X_SHAPE[:2]) > 0.3
    return np.asarray(additive_mask(keep), np.float32)


def _jax_pipeline(P, M, final_ln, variables, x, bias):
    """JAX's pipelined encoder on P virtual devices: the output and the
    gradients of sum(y²) with respect to the parameters and the input."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mme_tpu.models.layers import EncoderSpec as JSpec
    from mme_tpu.parallel.pipeline import pipeline_encoder_apply

    spec = JSpec(**ENC, final_ln=final_ln)
    mesh = Mesh(np.asarray(jax.devices()[:P]), ("pp",))
    params = jax.tree.map(jnp.asarray, variables["params"])
    jb = None if bias is None else jnp.asarray(bias)

    def loss(p, xx):
        y = pipeline_encoder_apply(spec, p, xx, mesh, n_microbatches=M,
                                   bias=jb)
        return jnp.sum(y ** 2), y

    (_, y), (g, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (np.asarray(y), dict(_flat(jax.tree.map(np.asarray, g))),
            np.asarray(dx))


def test_stage_trees_match_jax():
    import jax
    import jax.numpy as jnp

    from mme_tpu.parallel import pipeline as jp

    params = _variables()["params"]
    want = jp.stack_encoder_params(jax.tree.map(jnp.asarray, params), 4)
    got = stack_encoder_params(params, 4)
    assert dict(_flat(got)).keys() == dict(_flat(want)).keys()
    for k, w in _flat(want):
        np.testing.assert_array_equal(dict(_flat(got))[k], w)
    staged = stage_params(params, 4, 2)
    for k, w in _flat(want):
        np.testing.assert_array_equal(dict(_flat(staged))[k],
                                      w.reshape((2, 2) + w.shape[1:]))
    back = unstack_to_encoder_params(got, 4)
    for k, w in _flat(params):
        np.testing.assert_array_equal(dict(_flat(back))[k], w)
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        stage_params(params, 4, 3)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "P{}-M{}{}{}".format(
    c[0], c[1], "-bias" if c[2] else "", "-final_ln" if c[3] else ""))
def test_pipelined_encoder_matches_jax(pool4, case):
    P, M, has_bias, final_ln = case
    variables, x = _variables(final_ln), _x()
    bias = _bias() if has_bias else None
    y, g, dx = _jax_pipeline(P, M, final_ln, variables, x, bias)
    ranks = pool4.run(f"{HERE}:rank_encoder", P, M, final_ln, variables, x,
                      bias)
    for r in ranks:
        np.testing.assert_allclose(r["y_eval"], y, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["y"], y, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["dx"], dx, rtol=5e-4, atol=5e-5)
        assert r["stage_leaves"] == sum(
            len(list(_flat(variables["params"][f"layer_{i}"])))
            for i in range(ENC["layers"]))
        assert r["grads"].keys() == g.keys()
        for k, w in g.items():
            np.testing.assert_allclose(r["grads"][k], w, rtol=5e-4,
                                       atol=5e-5, err_msg=str(k))


def test_sync_sums_stage_leaves_and_averages_replicated(pool4):
    for stage, plain in pool4.run(f"{HERE}:rank_sync", 1.0, 2.0):
        # pp index 0 of each dp line holds 1 and 2: summed over pp and
        # averaged over dp → 1.5, where a mean over pp would give 0.75
        np.testing.assert_allclose(stage, 1.5)
        # 2 and 4 on both pp ranks of each dp line → their mean, 3
        np.testing.assert_allclose(plain, 3.0)


def test_dp_pp_step_matches_one_rank(pool4, tmp_path):
    from mme_tpu_torch.train.checkpoint import CheckpointManager
    params = init_params(SPEC, 0)
    model, state, loss, cm, grads, _ = _step(params)
    names = [n for n, _ in model.named_parameters()]
    want = dict(zip(names, (g.numpy() for g in grads)))
    ranks = pool4.run(f"{HERE}:rank_dp_pp_step", params, str(tmp_path))
    fusion_leaves = sum(n.startswith("model.fusion_encoder.layer_")
                        for n in names)
    for r in ranks:
        assert abs(r["loss"] - loss) <= 2e-5 * abs(loss)
        np.testing.assert_array_equal(r["cm"], cm)
        assert r["stage_leaves"] == fusion_leaves > 0
        assert r["grads"].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(
                r["grads"][k], w, rtol=0, err_msg=k,
                atol=1e-4 * max(np.abs(w).max(), 1e-6))
    # the pp run's checkpoint: restored under pp and on one rank
    first = ranks[0]
    for k, w in first["params"].items():
        np.testing.assert_array_equal(first["restored"][k], w)
    model1, fresh, *_ = _step(params)
    CheckpointManager(str(tmp_path), use_async=False).restore_best(fresh)
    back = dict(_flat(to_flax(model1)))
    for k, w in first["params"].items():
        np.testing.assert_array_equal(back[k], w)


def test_dropout_through_the_pipeline(pool4):
    """Dropout in training mode: the pipeline refuses to run without the
    step's generator; with it, every stage takes the masks the sequential
    stack draws (each microbatch its rows, each stage its layers'), so the
    output and every gradient are the sequential encoder's, and the
    generator ends where the sequential stack leaves it on every rank. The
    tiny TAV's dp x pp step with dropout in the pipelined trunk: the
    one-rank step's loss and gradients, and the same step generator state
    on every rank."""
    x = _x()
    variables = _variables(dropout=0.4, attention_dropout=0.2)
    seq = _encoder(variables, dropout=0.4, attention_dropout=0.2).train()
    want = _dropout_run(seq, x, 5)
    want_g = dict(_flat(grads_to_flax(seq, want["grads"])))
    # the masks fired
    assert np.abs(want["y"] - _dropout_run(seq.eval(), x, 5)["y"]).max() > 0.1
    _, _, loss, _, grads, gen = _step(init_params(SPEC, 0), spec=TRUNK_DROP)
    ranks = pool4.run(f"{HERE}:rank_dropout", variables, x, 5)
    for r in ranks:
        assert r["refused"] is not None and "Generator" in r["refused"]
        np.testing.assert_allclose(r["y"], want["y"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["dx"], want["dx"], rtol=5e-4,
                                   atol=5e-5)
        np.testing.assert_array_equal(r["gen_state"], want["gen_state"])
        for k, w in want_g.items():
            np.testing.assert_allclose(r["grads"][k], w, rtol=5e-4,
                                       atol=5e-5, err_msg=str(k))
        tav = r["tav"]
        assert abs(tav["loss"] - loss) <= 2e-5 * abs(loss)
        for g, w in zip(tav["grads"], grads):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-4 * max(np.abs(w.numpy()).max(),
                                                       1e-6))
        np.testing.assert_array_equal(tav["gen_state"], gen.get_state())


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-rank CLI run with ``MME_PREDICT_OUT`` and
    ``MME_EXPORT_BUNDLE``: its environment and (loss, cm)."""
    d = tmp_path_factory.mktemp("pp_one_rank")
    env = {"MME_PREDICT_OUT": str(d / "pred.jsonl"),
           "MME_EXPORT_BUNDLE": str(d / "bundle"),
           "MME_RUN_DIR": str(d / "run")}
    return env, rank_cli(str(d), env)


def _bundle_batch(bundle):
    """A batch of the features a TAV bundle was exported with."""
    with open(os.path.join(bundle, "meta.json")) as f:
        feats = json.load(f)["features"]
    b = example_tav_batch(SPEC, 5, feats["input_ids"]["shape"][1],
                          feats["waveform"]["shape"][1], seed=9)
    return {k: b[k].astype(feats[k]["dtype"]) for k in feats}


@pytest.mark.parametrize("tower", ["fusion", "audio"])
def test_cli_pp_matches_one_rank(pool2, one_rank, tmp_path, tower):
    from mme_tpu_torch.serve import load_bundle
    base_env, (loss, cm, _) = one_rank
    env = {"MME_PP": "2", "MME_PP_MICRO": "2", "MME_PP_TOWER": tower}
    if tower == "fusion":
        env.update(MME_MP="2", MME_PREDICT_OUT=str(tmp_path / "pred.jsonl"),
                   MME_EXPORT_BUNDLE=str(tmp_path / "bundle"),
                   MME_RUN_DIR=str(tmp_path / "run"))
    ranks = pool2.run(f"{HERE}:rank_cli", str(tmp_path), env)
    for got_loss, got_cm, lines in ranks:
        assert abs(got_loss - loss) < 2e-3, (got_loss, loss)
        np.testing.assert_array_equal(got_cm, cm)
        assert f"{tower} tower pp=2 dp=1 (GPipe pipeline)" in lines
        assert (tower == "fusion") == (
            "MME_MP=2: the mesh {'dp': 1, 'pp': 2} has no mp axis; every "
            "leaf replicated" in lines)
    if tower != "fusion":
        return
    rows = [[json.loads(line) for line in open(e["MME_PREDICT_OUT"])]
            for e in (env, base_env)]
    assert len(rows[0]) == len(rows[1]) > 0
    for a, b in zip(*rows):
        assert a["index"] == b["index"] and a["pred"] == b["pred"]
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-3)
    batch = _bundle_batch(base_env["MME_EXPORT_BUNDLE"])
    got, want = (load_bundle(e["MME_EXPORT_BUNDLE"], device="cpu")(batch)
                 for e in (env, base_env))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)


def test_cli_pp_moe_trunk_runs_whole(pool2, tmp_path):
    """``-m TAVMoE`` under ``MME_PP=2``: JAX's MoE trunk has no pipeline
    branch (it trains unpipelined, every device the whole trunk), and the
    port's neither: each rank runs it whole, and the run matches one
    rank's."""
    (tmp_path / "one").mkdir()
    loss, cm, _ = rank_cli(str(tmp_path / "one"), {}, ["-m", "TAVMoE"])
    for got_loss, got_cm, _ in pool2.run(
            f"{HERE}:rank_cli", str(tmp_path),
            {"MME_PP": "2", "MME_PP_MICRO": "2"}, ["-m", "TAVMoE"]):
        assert abs(got_loss - loss) < 2e-3, (got_loss, loss)
        np.testing.assert_array_equal(got_cm, cm)


@pytest.mark.parametrize("case", [
    ({"MME_SP": "2", "MME_PP": "2"}, 2, "MME_SP and MME_PP are exclusive"),
    ({"MME_PP": "2", "MME_PP_TOWER": "lidar"}, 2, "MME_PP_TOWER='lidar'"),
    ({"MME_PP": "2"}, 3, "3 ranks not divisible by MME_PP=2"),
    ({"MME_PP": "2"}, 6, "batch 8 not divisible by dp=3"),
    ({"MME_PP": "4"}, 4, "2 fusion layers not divisible into 4 stages"),
    ({"MME_PP": "2", "MME_PP_MICRO": "3"}, 2,
     r"batch 8 must split into 3 microbatches of a dp=1 multiple"),
    ({"MME_PP": "2", "MME_PP_MICRO": "8"}, 4,
     r"batch 8 must split into 8 microbatches of a dp=2 multiple")],
    ids=["sp_and_pp", "tower", "ranks", "dp_batch", "layers", "micro",
         "micro_dp"])
def test_parallel_spec_refuses_before_any_work(case, monkeypatch):
    """JAX's checks of ``MME_PP`` (mme_tpu/cli/tav_nn.py:80-117), in its
    order, each before a mesh is made; the world's size stands in for
    the ranks."""
    from mme_tpu_torch.parallel import distributed
    env, world, message = case
    for k in CLI_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    made = []
    monkeypatch.setattr(tav_nn, "make_mesh", lambda *a, **k: made.append(a))
    cfg = ExperimentConfig(batch_size=B)
    with pytest.raises(ValueError, match=message):
        tav_nn.parallel_spec(cfg, SPEC)
    assert not made
