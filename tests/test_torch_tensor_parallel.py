"""The port's tensor parallelism (mme_tpu_torch/parallel/sharding_rules.py,
the tp paths of models/layers.py, train/{steps,optim,checkpoint}.py,
cli/common.py, serve.py) against mme_tpu on the same numpy-seeded inputs
and flax weights.

The port's side runs in one pool of four CPU ranks joined by gloo
(``parallel/launch.py::RankPool``, module fixture), a ``("dp", "mp")`` mesh
of dp=2 and mp=2; the rank-side functions import no JAX (the workers
import this file by path).

- The rule: on the tiny TAV tree the port cuts exactly the leaves JAX's
  ``tp_spec_for_path`` shards (tests/test_tensor_parallel.py:18-36), and
  on an encoder whose 3 heads mp=2 does not divide it keeps qkv whole and
  cuts ``out`` and the MLP, as JAX does.
- The dp=2 x mp=2 train step of the tiny TAV (dropout off, fp32) against
  JAX's unsharded step, as tests/test_tensor_parallel.py:39-76 holds
  JAX's 4dp x 2mp step: loss rtol 2e-5, the confusion matrix equal, every
  gathered parameter within 3e-5; and against the port's one-rank step:
  every gathered gradient the optimizer is handed within 1e-4 of its
  largest element (tests/test_torch_train.py's tolerance), the moments
  and the grad norm. K3 on the shards (``MME_FUSED_ADAM=interpret``, bf16
  moments): each rank's dither is drawn over its block's own indices, so
  the gathered moments are held to within one bf16 ulp of the one-rank
  step's, not bit for bit. Checkpoints: a state written at mp=2 restores
  at mp=1, and one written at mp=1 restores at mp=2, leaf for leaf.
- An encoder in training mode (dropout on both attention and MLP) on odd
  local heads (6 heads: 3 a rank) through the flash wrapper's CPU path,
  and on 3 heads (qkv whole, ``out`` cut): output and every gathered
  gradient against the unsharded encoder with the same generator.
- ``tav_nn.main`` with ``MME_MP=2`` on the four ranks (dp=2 x mp=2),
  ``MME_PREDICT_OUT`` and ``MME_EXPORT_BUNDLE`` set, against the
  one-rank run: test loss within 2e-3 (tests/test_torch_parallel.py's
  CLI tolerance), the confusion matrix and every predicted class equal,
  the probabilities within 1e-3, the mp=2 bundle serving what the mp=1
  bundle serves.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mme_tpu_torch.config import ExperimentConfig
from mme_tpu_torch.convert import (_flax_shape, _leaves, from_flax,
                                   grads_to_flax, init_params,
                                   init_variables, to_flax)
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
from mme_tpu_torch.parallel.launch import RankPool
from mme_tpu_torch.parallel.sharding_rules import tp_plan
from mme_tpu_torch.train.build_tav import build_tav, example_tav_batch

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
SPEC = TAVSpec().tiny()
B = 4
CFG = dict(batch_size=B, text_max_len=12, audio_max_samples=400)
LABELS = np.arange(B, dtype=np.int64) % 7
MASK = np.ones(B, np.int32)
CW = np.ones(7, np.float32)
# the odd-heads encoders: 6 heads of 64 (3 a rank), and 3 heads of 8
# (mp=2 does not divide them: qkv whole, out and the MLP cut)
ODD = {"odd_local_heads": dict(hidden=384, heads=6, layers=2,
                               intermediate=64),
       "heads_not_divided": dict(hidden=24, heads=3, layers=2,
                                 intermediate=40)}


def _quiet(spec):
    """Every dropout rate and SpecAugment probability 0 (the port's and
    JAX's spec have the same field names)."""
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


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


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
    mean over the ranks, before the clip)."""
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


def _step(params, mesh=None, logged=False, **env):
    """One train step of the quiet tiny TAV from ``params`` on the batch
    (this rank's dp rows under a mesh): (model, state, loss, cm, norm,
    the handed gradients). ``logged``: the step logs the per-module norms
    and histograms (``norm`` is their dictionary, as numpy)."""
    from mme_tpu_torch.parallel.mesh import shard_batch
    from mme_tpu_torch.train.steps import make_train_step
    batch, labels, mask = _batch(), LABELS, MASK
    if mesh is not None:
        local = shard_batch({**batch, "_l": labels, "_m": mask}, mesh)
        labels, mask = local.pop("_l"), local.pop("_m")
        batch = local
    with _env(**{"MME_OPT_STATE": "fp32", **env}):
        model, state, step, _ = build_tav(
            _quiet(SPEC), ExperimentConfig(**CFG), 10, params=params,
            remat=False, use_accum=False, device="cpu", mesh=mesh)
        if logged:
            step = make_train_step(model, _fp32_tx(), 7, mesh=mesh,
                                   log_module_norms=True,
                                   log_histograms=True)
        seen: list = []
        with _handed(seen):
            _, loss, cm, norm = step(state, batch, labels, mask, CW, 1.0,
                                     True, 0)
    norm = ({k: v.numpy() for k, v in norm.items()} if logged
            else float(norm))
    return model, state, float(loss), cm.numpy(), norm, seen[0]


def _fp32_tx():
    """An fp32 AdamW (the logged norms are of the gradients and
    parameters before its update)."""
    from mme_tpu_torch.train.steps import make_optimizer
    return make_optimizer(lambda s: 0.0, 0.0, 1.0, state_dtype="fp32")


def _whole(model, state, grads=None) -> dict:
    """The state in the flax layout with every cut leaf gathered (a
    collective under a mesh): params, moments and the handed gradients."""
    from mme_tpu_torch.parallel.sharding_rules import (full_tensor,
                                                       shard_of, whole_model)
    shards = [shard_of(p) for p in state.params]

    def gathered(xs):
        return [full_tensor(x, s) for x, s in zip(xs, shards)]

    mu, nu = gathered(state.opt_state.mu), gathered(state.opt_state.nu)
    g = None if grads is None else gathered(grads)
    with whole_model(model):
        out = {"params": dict(_flat(to_flax(model))),
               "mu": dict(_flat(to_flax(model, mu))),
               "nu": dict(_flat(to_flax(model, nu)))}
        if g is not None:
            out["grads"] = dict(_flat(grads_to_flax(model, g)))
    return out


# ---------------- rank side (the pool's workers; no JAX) ----------------

def _mesh():
    from mme_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(2, 2)


def rank_tp_step(params, save_dir, load_dir):
    """The dp=2 x mp=2 fp32 step and its gathered state; a checkpoint of
    it into ``save_dir``; the mp=1 checkpoint in ``load_dir`` restored into
    a fresh cut state; the bf16-moment step with K3's plain version on the
    shards. Rank 0 returns the trees, every rank its scalars."""
    from mme_tpu_torch.parallel import distributed
    from mme_tpu_torch.train.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    mesh = _mesh()
    model, state, loss, cm, norm, grads = _step(params, mesh)
    out = {"loss": loss, "cm": cm, "norm": norm,
           "cut": sum(hasattr(p, "mme_shard") for p in state.params),
           "first": _whole(model, state, grads)}
    CheckpointManager(save_dir, use_async=False).save_best(
        state, {"val_loss": loss})
    model2, fresh, *_ = _step(params, mesh)
    CheckpointManager(load_dir, use_async=False).restore_best(fresh)
    out["restored"] = _whole(model2, fresh)
    model3, state3, *_ = _step(params, mesh, MME_OPT_STATE="bf16",
                               MME_FUSED_ADAM="interpret")
    out["bf16"] = _whole(model3, state3)
    out["logged"] = _step(params, mesh, logged=True)[4]
    if distributed.rank() != 0:
        for k in ("first", "restored", "bf16"):
            out.pop(k)
    return out


def rank_odd_heads(name, x, bias, seed, variables):
    """An encoder with ``ODD[name]`` cut over mp=2 in training mode (the
    attention's core through the flash wrapper, whose CPU path is its
    plain version): output and every gathered gradient of sum(y · x)."""
    from mme_tpu_torch.ops import attention
    from mme_tpu_torch.parallel.sharding_rules import shard_model, whole_model
    torch.set_num_threads(1)
    enc = _odd_encoder(name, variables)
    shard_model(enc, _mesh())
    heads = enc.layer_0.attention.qkv.weight.shape[0] // (
        3 * enc.layer_0.attention.head_dim)
    plain = attention._decide_flash
    attention._decide_flash = lambda q, b: True
    try:
        y, grads = _odd_run(enc, x, bias, seed)
    finally:
        attention._decide_flash = plain
    from mme_tpu_torch.parallel.sharding_rules import full_tensor, shard_of
    whole = [full_tensor(g, shard_of(p))
             for g, p in zip(grads[1:], enc.parameters())]
    with whole_model(enc):
        tree = dict(_flat(grads_to_flax(enc, whole)))
    return heads, y, grads[0].numpy(), tree


CLI_ARGV = ["-d", "synthetic", "-e", "1", "-b", "8", "-y", "7", "-l",
            "1e-4", "-p", "50"]
CLI_ENV = ("MME_MP", "MME_DP", "MME_MESH", "MME_PREDICT_OUT",
           "MME_EXPORT_BUNDLE", "MME_RUN_DIR")


def rank_cli(directory, env):
    """``tav_nn.main`` on the CPU in ``directory`` with ``env`` set: the
    test loss and confusion matrix."""
    from mme_tpu_torch.cli import tav_nn
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


def _odd_encoder(name, variables):
    enc = TransformerEncoder(EncoderSpec(**ODD[name], ln_style="pre",
                                         dropout=0.1,
                                         attention_dropout=0.2),
                             device="cpu")
    enc.load_state_dict(from_flax(variables["params"]), strict=True)
    return enc.train()


def _odd_run(enc, x, bias, seed):
    xt = torch.from_numpy(x).requires_grad_()
    y = enc(xt, torch.from_numpy(bias),
            torch.Generator().manual_seed(seed))
    grads = torch.autograd.grad((y * xt.detach()).sum(),
                                [xt] + list(enc.parameters()))
    return y.detach().numpy(), [g.detach() for g in grads]


# ------------------------------ parent side ------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=300) as p:
        yield p


def _jax_tp_spec_leaves(params, mp):
    """The flax paths JAX's rule shards over ``mp`` ranks (its divisibility
    fallback applied), from ``tp_spec_for_path`` itself."""
    import jax
    from mme_tpu.parallel.sharding_rules import tp_spec_for_path

    out = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        spec = tp_spec_for_path(path, leaf)
        keys = tuple(k.key for k in path)
        for dim, axis in enumerate(spec):
            if axis == "mp" and leaf.shape[dim] % mp == 0:
                out.add(keys)
    return out


@pytest.mark.parametrize("case", ["tav", "heads_not_divided"])
def test_tp_rule_cuts_jax_leaves(case):
    if case == "tav":
        model = TAVModel(SPEC, device="meta")
    else:
        model = TransformerEncoder(EncoderSpec(**ODD[case]), device="meta")
    params = init_variables(model, 0)["params"]
    want = _jax_tp_spec_leaves(params, 2)
    names = {id(p): n for n, p in model.named_parameters()}
    plan = tp_plan(model, 2)
    got = {path for path, p, _, _ in _leaves(model) if names[id(p)] in plan}
    assert got == want
    kinds = {"/".join(p[-3:]) for p in got}
    if case == "tav":
        assert any(k.endswith("qkv/kernel") for k in kinds)
        assert any(k.endswith("fc1/kernel") for k in kinds)
        assert len(got) == 48
    else:
        # heads that mp does not divide: the fused qkv and its bias whole
        assert not any("qkv" in k for k in kinds)
        assert any(k.endswith("attention/out/kernel") for k in kinds)
    # the cut dims: qkv's three row blocks, [out, in] for the dense
    for path, p, kind, heads in _leaves(model):
        if names[id(p)] in plan:
            dim, blocks = plan[names[id(p)]]
            flax = _flax_shape(tuple(p.shape), kind, heads)
            assert blocks == (3 if kind == "qkv" else 1)
            assert p.shape[dim] % (2 * blocks) == 0 and len(flax) >= 1


def _jax_step(params):
    """JAX's unsharded train step from ``params`` on the batch."""
    import jax
    import jax.numpy as jnp

    from mme_tpu.core.config import ExperimentConfig as JConfig
    from mme_tpu.models import fusion as j_fusion
    from mme_tpu.train import build_tav as j_build

    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    _, state, step, _ = j_build.build_tav(
        _quiet(j_fusion.TAVSpec().tiny()), JConfig(**CFG), 10,
        example_batch=jb, remat=False, use_accum=False)
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    state, loss, cm, _ = step(
        state, jb, jnp.asarray(LABELS, jnp.int32), jnp.asarray(MASK),
        jnp.asarray(CW), jnp.asarray(1.0, jnp.float32), jnp.asarray(True),
        jax.random.PRNGKey(7))
    return (float(loss), np.asarray(cm),
            dict(_flat(jax.tree.map(np.asarray, state.params))))


def _bf16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)) * 65536.0


def test_dp2_mp2_step_matches_jax_and_one_rank(pool, tmp_path):
    from mme_tpu_torch.train.checkpoint import CheckpointManager

    params = init_params(SPEC, 0)
    model, state, loss, cm, norm, grads = _step(params)
    one = _whole(model, state, grads)
    one_dir, mp2_dir = tmp_path / "mp1", tmp_path / "mp2"
    CheckpointManager(str(one_dir), use_async=False).save_best(
        state, {"val_loss": loss})
    ranks = pool.run(f"{HERE}:rank_tp_step", params, str(mp2_dir),
                     str(one_dir))
    j_loss, j_cm, j_params = _jax_step(params)
    for r in ranks:
        assert r["cut"] == 48
        assert abs(r["loss"] - j_loss) <= 2e-5 * abs(j_loss)
        np.testing.assert_array_equal(r["cm"], j_cm)
        np.testing.assert_array_equal(r["cm"], cm)
        assert abs(r["norm"] - norm) <= 1e-5 * norm
    first = ranks[0]["first"]
    assert first["params"].keys() == j_params.keys()
    for k, want in j_params.items():
        np.testing.assert_allclose(first["params"][k], want, atol=3e-5,
                                   rtol=0, err_msg=str(k))
    for k, want in one["grads"].items():
        np.testing.assert_allclose(first["grads"][k], want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-6),
                                   err_msg=str(k))
        for m in ("mu", "nu"):
            top = max(np.abs(one[m][k]).max(), 1e-30)
            np.testing.assert_allclose(first[m][k], one[m][k], rtol=0,
                                       atol=2e-4 * top, err_msg=str(k))
    # the mp=1 checkpoint restored into the cut state, leaf for leaf
    restored = ranks[0]["restored"]
    for m in ("params", "mu", "nu"):
        for k, want in one[m].items():
            np.testing.assert_array_equal(restored[m][k], want,
                                          err_msg=f"{m} {k}")
    # the mp=2 checkpoint restored at mp=1, leaf for leaf
    model1, fresh, *_ = _step(params)
    CheckpointManager(str(mp2_dir), use_async=False).restore_best(fresh)
    back = _whole(model1, fresh)
    for m in ("params", "mu", "nu"):
        for k, want in first[m].items():
            np.testing.assert_array_equal(back[m][k], want,
                                          err_msg=f"{m} {k}")
    # K3 on the shards: each bf16 moment within one bf16 ulp of one rank's,
    # beyond what the two runs' fp32 gradients (the same step's) move it
    model, state, *_ = _step(params, MME_OPT_STATE="bf16",
                             MME_FUSED_ADAM="interpret")
    want = _whole(model, state)
    got = ranks[0]["bf16"]
    for m, weight in (("mu", 0.1), ("nu", 0.001)):
        for k, w in want[m].items():
            g, ga, gb = got[m][k], first["grads"][k], one["grads"][k]
            if m == "nu":
                ga, gb = ga * ga, gb * gb
            moved = weight * np.abs(ga - gb) * (1 + 1e-3)
            ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
            assert (np.abs(g - w) <= ulp + moved).all(), (m, k)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, atol=1e-7, rtol=0,
                                   err_msg=str(k))
    # MME_LOG_NORMS / MME_LOG_HISTS: a cut leaf summed over mp, a
    # replicated one counted once; the parameters' histograms exact, the
    # gradients' within the few elements fp32 rounding moves across a
    # bucket edge
    logged = _step(params, logged=True)[4]
    for r in ranks:
        assert r["logged"].keys() == logged.keys()
        for k, w in logged.items():
            if k.startswith("hist/param/"):
                np.testing.assert_array_equal(r["logged"][k], w)
            elif k.startswith("hist/grad/"):
                assert r["logged"][k].sum() == w.sum()
                assert np.abs(r["logged"][k] - w).sum() <= 1e-3 * w.sum()
            else:
                np.testing.assert_allclose(r["logged"][k], w, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(ODD))
def test_odd_heads_forward_and_backward_match_unsharded(pool, name):
    rng = np.random.default_rng(11)
    h = ODD[name]["hidden"]
    x = rng.standard_normal((2, 10, h)).astype(np.float32)
    bias = np.zeros((2, 1, 1, 10), np.float32)
    bias[1, ..., 7:] = -1e9
    variables = init_variables(TransformerEncoder(
        EncoderSpec(**ODD[name], ln_style="pre"), device="meta"), 3)
    enc = _odd_encoder(name, variables)
    y, grads = _odd_run(enc, x, bias, 5)
    want = dict(_flat(grads_to_flax(enc, grads[1:])))
    local = {"odd_local_heads": 3, "heads_not_divided": 3}[name]
    for heads, got_y, got_dx, got in pool.run(
            f"{HERE}:rank_odd_heads", name, x, bias, 5, variables):
        assert heads == local
        np.testing.assert_allclose(got_y, y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_dx, grads[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, err_msg=str(k),
                                       atol=1e-5 * max(np.abs(w).max(), 1))


def test_cli_mp2_trains_predicts_and_exports_like_one_rank(pool, tmp_path):
    from mme_tpu_torch.serve import load_bundle

    runs = {}
    for tag in ("one", "mp2"):
        d = tmp_path / tag
        d.mkdir()
        runs[tag] = {"MME_PREDICT_OUT": str(d / "pred.jsonl"),
                     "MME_EXPORT_BUNDLE": str(d / "bundle"),
                     "MME_RUN_DIR": str(d / "run")}
    want = rank_cli(str(tmp_path / "one"), runs["one"])
    ranks = pool.run(f"{HERE}:rank_cli", str(tmp_path / "mp2"),
                     {**runs["mp2"], "MME_MP": "2"})
    for loss, cm in ranks:
        assert abs(loss - want[0]) < 2e-3, (loss, want[0])
        np.testing.assert_array_equal(cm, want[1])
    rows = {tag: [json.loads(line) for line in open(env["MME_PREDICT_OUT"])]
            for tag, env in runs.items()}
    assert len(rows["mp2"]) == len(rows["one"]) > 0
    for a, b in zip(rows["mp2"], rows["one"]):
        assert a["index"] == b["index"] and a["pred"] == b["pred"]
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-3)
    with open(os.path.join(runs["mp2"]["MME_RUN_DIR"],
                           "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert any("export_bundle" in d for d in logged)
    batch = _bundle_batch(runs["one"]["MME_EXPORT_BUNDLE"])
    preds = {tag: load_bundle(env["MME_EXPORT_BUNDLE"], device="cpu")(batch)
             for tag, env in runs.items()}
    np.testing.assert_array_equal(preds["mp2"][0], preds["one"][0])
    np.testing.assert_allclose(preds["mp2"][1], preds["one"][1], atol=1e-3)


def _bundle_batch(bundle):
    """A batch of the features a TAV bundle was exported with (its meta
    records them): ``example_tav_batch`` at their text and audio lengths,
    in their dtypes."""
    with open(os.path.join(bundle, "meta.json")) as f:
        feats = json.load(f)["features"]
    b = example_tav_batch(SPEC, 5, feats["input_ids"]["shape"][1],
                          feats["waveform"]["shape"][1], seed=9)
    assert set(b) == set(feats)
    return {k: b[k].astype(feats[k]["dtype"]) for k in feats}
