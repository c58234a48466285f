"""The port's other fusion trunks (mme_tpu_torch/models/fusion.py:
``TAVFormer``, ``TAVForMAETwoTower``, ``TAVForW2V2``, ``TAVMoEFormer``)
against ``mme_tpu.models.fusion.FUSION_MODELS`` on one flax-layout weight
tree per model and the same numpy-seeded batch; the MoE trunk's aux loss
through ``make_train_step`` / ``make_eval_step``, ``Predictor``, a bundle
and the ``tav_nn`` CLI.

The weights are drawn once per file (module fixture) by
``convert.init_params(model=name)``, whose leaf set and shapes are held to
JAX's ``model.init`` (traced by ``jax.eval_shape``, never run); both
packages apply them in eval mode, JAX under ``jax.jit``. The batch carries
ragged rows and a zero-padded serving row.

Tolerances: fp32 logits within 1e-5 absolute (fp32 sums in other orders);
bf16 logits within 5e-2 of JAX's bf16 logits and of the fp32 logits, as
tests/test_torch_model.py holds the flagship's (each framework rounds at
other places; a near-tie in a bf16 router may also route a token
differently). The train step's loss within 1e-5, its gradient norm within
1e-4 relative and every parameter after one step within 1e-5 absolute, as
tests/test_torch_train.py holds the flagship's; every gradient leaf within
1e-5 of its largest element (fp32 sums in other orders). A bundle and the
live Predictor within 1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.models import fusion as j_fusion
from mme_tpu.models.moe import collect_aux_loss
from mme_tpu.train import schedules as j_schedules
from mme_tpu.train import steps as j_steps
from mme_tpu.train.losses import cross_entropy as j_cross_entropy

from mme_tpu_torch.cli import tav_nn
from mme_tpu_torch.convert import from_flax, grads_to_flax, init_params, \
    to_flax
from mme_tpu_torch.models import fusion
from mme_tpu_torch.serve import (BUNDLE_META, Predictor, export_bundle,
                                 load_bundle)
from mme_tpu_torch.train.build_tav import example_tav_batch
from mme_tpu_torch.train.losses import cross_entropy
from mme_tpu_torch.train.schedules import cosine_warm_restarts
from mme_tpu_torch.train.steps import (TrainState, make_eval_step,
                                       make_optimizer, make_train_step)

from tests.test_torch_train import _quiet

torch.set_num_threads(2)

NAMES = ("TAVFormer", "TAVForMAE2Tower", "TAVForW2V2", "TAVMoE")
CLASSES = {"TAVFormer": "TAVFormer", "TAVForMAE2Tower": "TAVForMAETwoTower",
           "TAVForW2V2": "TAVForW2V2", "TAVMoE": "TAVMoEFormer"}
SPEC = fusion.TAVSpec().tiny()
J_SPEC = j_fusion.TAVSpec().tiny()
LR, CLIP, WD = 1e-3, 1.0, 0.01


def _batch(n=3, seed=1):
    b = example_tav_batch(SPEC, n, 12, 4000, seed=seed)
    b["text_mask"][1, 7:] = 0
    b["audio_mask"][1, 2500:] = 0
    b["text_mask"][n - 1] = 0            # a zero-padded serving row
    b["audio_mask"][n - 1] = 0
    b["video"][n - 1] = 0
    b["video_keep"][n - 1] = False
    return b


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


def _j_apply(model, params, jb):
    """JAX logits (and the collected aux for the MoE trunk), jitted."""
    def run(p, b):
        out, inter = model.apply({"params": p}, b,
                                 mutable=["intermediates"])
        return out, collect_aux_loss(inter.get("intermediates", {}))
    return jax.jit(run)(params, jb)


@pytest.fixture(scope="module")
def ref():
    """Per model: the flax-layout weights, JAX's init shapes, the fp32
    logits and aux of JAX on one batch."""
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name in NAMES:
        model = j_fusion.FUSION_MODELS[name](J_SPEC)
        shapes = jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0), jb))["params"]
        params = init_params(SPEC, 0, model=name)
        logits, aux = _j_apply(model, params, jb)
        out[name] = (params, shapes, np.asarray(logits), float(aux))
    return batch, jb, out


def _port(name, params, spec=SPEC):
    model = fusion.FUSION_MODELS[name](spec, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    return model


def test_registry_has_jax_keys_and_falls_back():
    assert fusion.FUSION_MODELS.keys() == j_fusion.FUSION_MODELS.keys()
    for name, cls in j_fusion.FUSION_MODELS.items():
        assert fusion.FUSION_MODELS[name].__name__ == cls.__name__
    assert (fusion.FUSION_MODELS.get("NoSuchModel",
                                     fusion.FUSION_MODELS["MAE_encoder"])
            is fusion.TAVModel)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_jax_leaves_and_round_trips(ref, name):
    _, _, out = ref
    params, shapes, _, _ = out[name]
    drawn = dict(_flat(params))
    want = {p: s.shape for p, s in _flat(shapes)}
    assert {p: a.shape for p, a in drawn.items()} == want
    assert all(a.dtype == np.float32 for a in drawn.values())
    back = dict(_flat(to_flax(_port(name, params))))
    assert back.keys() == drawn.keys()
    for path, leaf in drawn.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_expert_stacks_draw_flax_fan_in(ref):
    """flax's lecun_normal treats E of an [E, H, I] leaf as a receptive
    field: fan-in E·H for w1 and E·I for w2, the std of JAX's own draw."""
    params = ref[2]["TAVMoE"][0]
    moe = params["encoder"]["layer_1"]["moe_mlp"]
    E, H, inter = moe["w1"].shape
    assert moe["w2"].shape == (E, inter, H) and moe["b1"].shape == (E, inter)
    lecun = jax.nn.initializers.lecun_normal()
    for leaf, fan_in in (("w1", E * H), ("w2", E * inter)):
        std = fan_in ** -0.5
        drawn = moe[leaf]
        jax_draw = np.asarray(lecun(jax.random.PRNGKey(1), drawn.shape))
        assert abs(drawn.std() - std) < 0.05 * std, leaf
        assert abs(jax_draw.std() - std) < 0.05 * std, leaf
        assert np.abs(drawn).max() <= 2 * std / 0.8796 + 1e-6
    assert (moe["b1"] == 0).all() and (moe["b2"] == 0).all()
    assert moe["router"]["kernel"].shape == (H, E)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax_fp32(ref, name):
    batch, _, out = ref
    params, _, want, want_aux = out[name]
    model = _port(name, params).eval()
    assert type(model).__name__ == CLASSES[name]
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    if name == "TAVMoE":
        got, aux = got
        np.testing.assert_allclose(aux.item(), want_aux, atol=1e-5)
        assert aux.item() > 0
    else:
        assert isinstance(got, torch.Tensor)
    assert got.dtype == torch.float32 and got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_logits_bf16_agreement(ref, name):
    batch, jb, out = ref
    params, _, fp32, _ = out[name]
    j_model = j_fusion.FUSION_MODELS[name](
        J_SPEC.with_compute_dtype(jnp.bfloat16))
    want, _ = _j_apply(j_model, params, jb)
    want = np.asarray(want, np.float32)
    model = _port(name, params, SPEC.with_compute_dtype(torch.bfloat16))
    with torch.no_grad():
        got = _logits(model.eval()({k: torch.from_numpy(v)
                                    for k, v in batch.items()}))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)
    np.testing.assert_allclose(got.numpy(), fp32, atol=5e-2, rtol=0)


def _train_inputs():
    labels = np.array([0, 3, 6], np.int32)
    mask = np.array([1, 1, 0], np.int32)        # a padded batch row
    cw = np.linspace(0.5, 1.5, 7).astype(np.float32)
    return labels, mask, cw


def _j_moe_apply(model):
    def apply_fn(variables, batch, deterministic=True, rngs=None,
                 mutable=None):
        logits, inter = model.apply(
            variables, batch, deterministic=deterministic, rngs=rngs,
            mutable=["intermediates"])
        return logits, collect_aux_loss(inter["intermediates"])
    return apply_fn


def test_moe_gradients_include_aux_as_in_jax(ref):
    """CE + aux and every gradient leaf against ``jax.value_and_grad`` of
    the objective JAX's ``has_aux_loss=True`` step differentiates."""
    batch, jb, out = ref
    params = out["TAVMoE"][0]
    labels, mask, cw = _train_inputs()
    apply_fn = _j_moe_apply(j_fusion.TAVMoEFormer(_quiet(J_SPEC)))

    def objective(p):
        logits, aux = apply_fn({"params": p}, jb, deterministic=False)
        return j_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(cw),
                               jnp.asarray(mask)) + aux, aux

    (want_loss, want_aux), want = jax.jit(
        jax.value_and_grad(objective, has_aux=True))(params)
    model = _port("TAVMoE", params, _quiet(SPEC)).train()
    logits, aux = model({k: torch.from_numpy(v) for k, v in batch.items()},
                        rng=torch.Generator().manual_seed(0))
    loss = cross_entropy(logits, torch.from_numpy(labels),
                         torch.from_numpy(cw), torch.from_numpy(mask)) + aux
    loss.backward()
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    assert aux.item() > 0
    got = dict(_flat(grads_to_flax(model)))
    leaves = {p: np.asarray(v) for p, v in _flat(want)}
    assert got.keys() == leaves.keys()
    for path, b in leaves.items():
        np.testing.assert_allclose(got[path], b, rtol=0, err_msg=str(path),
                                   atol=1e-5 * max(np.abs(b).max(), 1e-6))
    router = got[("encoder", "layer_1", "moe_mlp", "router", "kernel")]
    assert np.abs(router).sum() > 0


def test_moe_train_step_matches_jax_has_aux_loss_step(ref):
    """One ``make_train_step(..., has_aux_loss=True)`` step against JAX's:
    the logged loss is CE + aux, then the gradient norm, the confusion
    matrix and every parameter after the update."""
    batch, jb, out = ref
    params = out["TAVMoE"][0]
    labels, mask, cw = _train_inputs()
    sched = (LR, 10, 10)
    j_tx = j_steps.make_optimizer(
        j_schedules.cosine_warm_restarts(*sched), WD, CLIP,
        state_dtype="fp32")
    j_state = j_steps.TrainState.create(jax.tree.map(jnp.asarray, params),
                                        j_tx, use_accum=False)
    j_step = j_steps.make_train_step(
        _j_moe_apply(j_fusion.TAVMoEFormer(_quiet(J_SPEC))), j_tx, 7,
        rng_names=("dropout", "spec_augment"), has_aux_loss=True,
        donate=False)
    j_state, j_loss, j_cm, j_norm = j_step(
        j_state, jb, jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(cw),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(True),
        jax.random.PRNGKey(0))

    model = _port("TAVMoE", params, _quiet(SPEC))
    tx = make_optimizer(cosine_warm_restarts(*sched), WD, CLIP,
                        state_dtype="fp32")
    state = TrainState.create(model.parameters(), tx, use_accum=False)
    step = make_train_step(model, tx, num_classes=7, has_aux_loss=True)
    _, loss, cm, norm = step(state, batch, labels, mask, cw, 1.0, True, 0)
    with torch.no_grad():
        logits, aux = model.eval()({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    ce = cross_entropy(logits, torch.from_numpy(labels),
                       torch.from_numpy(cw), torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    assert aux.item() > 0 and abs(loss.item() - ce.item()) > 0.5 * aux.item()
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
    got = dict(_flat(to_flax(model)))
    for path, b in _flat(jax.tree.map(np.asarray, j_state.params)):
        np.testing.assert_allclose(got[path], b, atol=1e-5, rtol=0,
                                   err_msg=str(path))
    assert max(np.abs(got[p] - b).max() for p, b in _flat(params)) > 1e-4


def test_moe_eval_step_drops_aux_as_jax(ref):
    batch, jb, out = ref
    params = out["TAVMoE"][0]
    labels, mask, cw = _train_inputs()
    j_eval = jax.jit(j_steps.make_eval_step(
        _j_moe_apply(j_fusion.TAVMoEFormer(J_SPEC)), 7, has_aux_loss=True))
    want_loss, want_cm, want_preds = j_eval(
        jax.tree.map(jnp.asarray, params), None, jb, jnp.asarray(labels),
        jnp.asarray(mask), jnp.asarray(cw))
    model = _port("TAVMoE", params)
    eval_step = make_eval_step(model, num_classes=7, has_aux_loss=True)
    loss, cm, preds = eval_step(batch, labels, mask, cw)
    assert not model.training
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want_cm))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))
    logits = torch.from_numpy(out["TAVMoE"][2])
    ce = cross_entropy(logits, torch.from_numpy(labels), torch.from_numpy(cw),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), ce.item(), atol=1e-5)


def test_moe_predictor_and_bundle_serve_the_logits(ref, tmp_path):
    """A ``(logits, aux)`` model serves its logits: the Predictor's
    probabilities against the softmax of JAX's logits, chunks of 2 (the
    second zero-padded) against chunks of 4 (MoE capacity is per row, so
    padding rows do not move the real ones), and a bundle of it against
    the live Predictor."""
    batch, _, out = ref
    params, _, logits, _ = out["TAVMoE"]
    model = _port("TAVMoE", params)
    preds, probs = Predictor(model, batch_size=2, device="cpu")(batch)
    want = torch.softmax(torch.from_numpy(logits), -1).numpy()
    np.testing.assert_allclose(probs, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(preds, logits.argmax(-1))
    _, probs4 = Predictor(model, batch_size=4, device="cpu")(batch)
    np.testing.assert_allclose(probs4, probs, atol=1e-6, rtol=0)

    path = tmp_path / "bundle"
    export_bundle(model, batch, str(path), batch_size=2, device="cpu")
    meta = json.loads((path / BUNDLE_META).read_text())
    assert meta["model"] == "TAVMoEFormer" and meta["batch_size"] == 2
    b_preds, b_probs = load_bundle(str(path), device="cpu")(batch)
    assert b_probs.shape == (3, 7) and b_probs.dtype == np.float32
    np.testing.assert_array_equal(b_preds, preds)
    np.testing.assert_allclose(b_probs, probs, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_model_flag_builds_its_fusion_model(name, tmp_path, monkeypatch):
    """``-m`` goes through FUSION_MODELS with weights from
    ``init_params(model=name)``; only TAVMoE trains with the aux loss."""
    seen = {}

    def capture(cfg, model, *a, **k):
        seen.update(model=model, **k)
        return {}

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tav_nn, "run_classifier", capture)
    tav_nn.main(["--dataset", "synthetic", "-m", name, "--seed", "5"],
                device="cpu")
    model = seen["model"]
    assert type(model).__name__ == CLASSES[name]
    assert seen["has_aux_loss"] == (name == "TAVMoE")
    want = dict(_flat(init_params(model.spec, 5, model=name)))
    got = dict(_flat(to_flax(model)))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_tav_moe_cli_trains_one_epoch(tmp_path, monkeypatch):
    """-m TAVMoE trains end to end (synthetic, tiny) with the aux loss
    wired through the train step, as JAX's
    tests/test_model_variants.py::test_tav_moe_cli_smoke."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MME_RUN_DIR", str(tmp_path))
    monkeypatch.delenv("MME_EVAL_ONLY", raising=False)
    summary = tav_nn.main(["--dataset", "synthetic", "--model", "TAVMoE",
                           "--epoch", "1", "--batch_size", "8",
                           "--output_dim", "7"], device="cpu")
    assert np.isfinite(summary["test/loss"])
    logs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    train = [d["train/loss"] for d in logs if "train/loss" in d]
    assert train and all(np.isfinite(train))


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("name", ("MAE_encoder",) + NAMES)
def test_ln_sites_count_every_layer_norm_call(name, share, monkeypatch):
    """``time_layer_norm.ln_sites(model=name)``, from which chip_smoke.py
    expects its K4a/K4b counts, lists exactly the (rows, features) of every
    FusedLayerNorm call of one forward (``MME_FUSED_LN=interpret`` sends
    each call through ``fused_layer_norm``)."""
    from collections import Counter
    from mme_tpu_torch.ops import layer_norm
    from mme_tpu_torch.time_layer_norm import ln_sites
    calls = []
    plain = layer_norm.fused_layer_norm

    def spy(x, *a, **k):
        calls.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, *a, **k)

    monkeypatch.setattr(layer_norm, "fused_layer_norm", spy)
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    spec = dataclasses.replace(SPEC, share_audio_frontend=share)
    model = fusion.FUSION_MODELS[name](spec, device="cpu")
    model.load_state_dict(from_flax(init_params(spec, 0, model=name)))
    batch = example_tav_batch(spec, 2, 12, 4000)
    with torch.no_grad():
        model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    want = ln_sites(spec, 2, 12, 4000, model=name)
    assert Counter(calls) == Counter(want) and len(calls) == len(want)
