"""The port's expert parallelism (``MoESpec.ep_axis`` in
mme_tpu_torch/models/moe.py, its cut in parallel/sharding_rules.py, the
``all_to_all`` of parallel/mesh.py, the step's gradient mean) against
mme_tpu's ``MoEMlp`` on the same numpy-seeded inputs and weights.

The port's side runs in one pool of two CPU ranks joined by gloo
(``parallel/launch.py::RankPool``, module fixture); the rank-side functions
import no JAX (the workers import this file by path).

- ``MoEMlp`` with 4 experts cut over ep=2 against JAX's unsharded layer
  (tests/test_moe.py:113-134, rtol 2e-5 and atol 1e-6): the output, and
  the gradients of sum(y · proj) with respect to x, the router and the
  expert stacks. Once with the same rows on both ranks (JAX's test
  layout), where each expert's gradient is the sum of the two ranks'
  identical contributions, twice the layer's (the step's mean divides it
  out), and once with the rows split over the axis, where it is the
  layer's and the router's gradients of the two ranks sum to the layer's.
- An ``ep_axis`` that the mesh lacks warns and runs the unsharded layer,
  as in JAX.
- One ``TAVMoE`` train step of the tiny spec (dropout off) with its
  experts cut over the dp axis of a dp=2 mesh against the one-rank step:
  the loss (task loss plus the aux loss of the global batch), the grad
  norm, every gathered gradient the optimizer is handed within 1e-4 of
  its largest element and every gathered parameter after the step.
"""

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from mme_tpu_torch.convert import (from_flax, grads_to_flax, init_params,
                                   init_variables, to_flax)
from mme_tpu_torch.models.fusion import TAVMoEFormer, TAVSpec
from mme_tpu_torch.models.layers import EncoderSpec
from mme_tpu_torch.models.moe import MoEMlp, MoESpec
from mme_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
LAYER = dict(hidden=8, intermediate=16)
MOE = dict(num_experts=4, top_k=2)
X_SHAPE = (4, 6, 8)
TOL = dict(rtol=2e-5, atol=1e-6)
SPEC = TAVSpec().tiny()
STEP_B = 4
LABELS = np.arange(STEP_B, dtype=np.int64) % 7
MASK = np.ones(STEP_B, np.int32)
CW = np.ones(7, np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


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


@contextlib.contextmanager
def _handed(into: list):
    """The gradients each optimizer update is handed."""
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


def _whole_flax(model, tensors=None):
    """``model``'s parameters (or ``tensors`` aligned with them) in the flax
    layout, every cut leaf gathered first."""
    from mme_tpu_torch.parallel.sharding_rules import (full_tensor,
                                                       shard_of, whole_model)
    params = list(model.parameters())
    whole = (None if tensors is None else
             [full_tensor(t, shard_of(p)) for t, p in zip(tensors, params)])
    with whole_model(model):
        return dict(_flat(to_flax(model) if whole is None
                          else grads_to_flax(model, whole)))


def _moe_step(params, mesh=None):
    """One train step of the quiet tiny TAVMoE: (loss, grad norm, the
    handed gradients and the parameters after, both in the flax layout
    and gathered). Under a mesh the experts are cut over its dp axis and
    this rank steps on its dp rows."""
    from mme_tpu_torch.parallel.mesh import shard_batch
    from mme_tpu_torch.parallel.sharding_rules import shard_model
    from mme_tpu_torch.train.build_tav import example_tav_batch
    from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                           make_train_step)
    moe = (MoESpec() if mesh is None
           else MoESpec(ep_axis="dp", ep_mesh=mesh))
    model = TAVMoEFormer(_quiet(SPEC), moe=moe, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    shard_model(model, mesh)
    tx = make_optimizer(lambda s: 1e-4, 1e-4, 1.0, state_dtype="fp32")
    state = TrainState.create(model.parameters(), tx, use_accum=False)
    step = make_train_step(model, tx, num_classes=7, has_aux_loss=True,
                           mesh=mesh)
    batch = example_tav_batch(SPEC, STEP_B, 12, 400, seed=3)
    batch["text_mask"][1, 6:] = 0
    labels, mask = LABELS, MASK
    if mesh is not None:
        local = shard_batch({**batch, "_l": labels, "_m": mask}, mesh)
        labels, mask = local.pop("_l"), local.pop("_m")
        batch = local
    seen: list = []
    with _handed(seen):
        _, loss, cm, norm = step(state, batch, labels, mask, CW, 1.0, True,
                                 0)
    cut = sum(hasattr(p, "mme_shard") for p in model.parameters())
    return (float(loss), float(norm), cm.numpy(), cut,
            _whole_flax(model, seen[0]), _whole_flax(model))


# ---------------- rank side (the pool's workers; no JAX) ----------------

def rank_layer(params, x, proj, split):
    """``MoEMlp`` cut over ep=2: the output and the gradients of
    sum(y · proj) on this rank's rows (all of them, or its half with
    ``split``), the expert stacks gathered."""
    from mme_tpu_torch.parallel.mesh import Mesh
    from mme_tpu_torch.parallel.sharding_rules import shard_model
    torch.set_num_threads(1)
    mesh = Mesh(("ep",), (2,))
    layer = MoEMlp(EncoderSpec(**LAYER), MoESpec(**MOE, ep_axis="ep",
                                                 ep_mesh=mesh), device="cpu")
    layer.load_state_dict(from_flax(params), strict=True)
    shard_model(layer, None)
    if split:
        rows = slice(mesh.coords["ep"] * 2, mesh.coords["ep"] * 2 + 2)
        x, proj = x[rows], proj[rows]
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
    y, _ = layer(xt)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(np.ascontiguousarray(proj))).sum(),
        [xt] + list(layer.parameters()))
    return (layer.w1.shape[0], y.detach().numpy(), grads[0].numpy(),
            _whole_flax(layer, grads[1:]))


def rank_moe_step(params):
    from mme_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    return _moe_step(params, make_mesh(2, 1))


# ------------------------------ parent side ------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(2, timeout_s=240) as p:
        yield p


def _jax_layer(params, x, proj):
    """JAX's unsharded ``MoEMlp``: output, and the gradients of
    sum(y · proj) with respect to x and the parameters."""
    import jax
    import jax.numpy as jnp

    from mme_tpu.models import layers as j_layers
    from mme_tpu.models import moe as j_moe

    layer = j_moe.MoEMlp(j_layers.EncoderSpec(**LAYER), j_moe.MoESpec(**MOE))

    def loss(p, xx):
        y = layer.apply({"params": p}, xx)
        return jnp.sum(y * proj), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (np.asarray(y), np.asarray(gx),
            dict(_flat(jax.tree.map(np.asarray, gp))))


@pytest.mark.parametrize("split", [False, True], ids=["same_rows",
                                                      "rows_split"])
def test_ep_layer_matches_jax(pool, split):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    proj = rng.standard_normal(X_SHAPE).astype(np.float32)
    params = init_variables(MoEMlp(EncoderSpec(**LAYER), MoESpec(**MOE),
                                   device="meta"), 7)["params"]
    y, gx, gp = _jax_layer(params, x, proj)
    ranks = pool.run(f"{HERE}:rank_layer", params, x, proj, split)
    router = ("router", "kernel")
    for r, (local, y_r, gx_r, gp_r) in enumerate(ranks):
        assert local == 2                       # 2 of the 4 experts a rank
        rows = slice(2 * r, 2 * r + 2) if split else slice(None)
        np.testing.assert_allclose(y_r, y[rows], **TOL)
        np.testing.assert_allclose(gx_r, gx[rows], **TOL)
        assert gp_r.keys() == gp.keys()
        for k in ("w1", "b1", "w2", "b2"):
            got = gp_r[(k,)] if split else gp_r[(k,)] / 2
            np.testing.assert_allclose(got, gp[(k,)], err_msg=k, **TOL)
        if not split:
            np.testing.assert_allclose(gp_r[router], gp[router], **TOL)
    if split:
        np.testing.assert_allclose(
            sum(gp_r[router] for *_, gp_r in ranks), gp[router], **TOL)


def test_ep_axis_the_mesh_lacks_warns_and_runs_unsharded():
    from mme_tpu_torch.parallel.mesh import Mesh
    params = init_variables(MoEMlp(EncoderSpec(**LAYER), MoESpec(**MOE),
                                   device="meta"), 7)["params"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        X_SHAPE).astype(np.float32))
    plain = MoEMlp(EncoderSpec(**LAYER), MoESpec(**MOE), device="cpu")
    with pytest.warns(UserWarning, match="not in the mesh"):
        layer = MoEMlp(EncoderSpec(**LAYER),
                       MoESpec(**MOE, ep_axis="ep",
                               ep_mesh=Mesh(("dp",), (1,))), device="cpu")
    assert layer.ep is None
    for m in (plain, layer):
        m.load_state_dict(from_flax(params), strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, want = layer(x), plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tavmoe_step_ep2_matches_one_rank(pool):
    params = init_params(SPEC, 0, model="TAVMoE")
    loss, norm, cm, cut, grads, after = _moe_step(params)
    assert cut == 0
    for r_loss, r_norm, r_cm, r_cut, r_grads, r_after in pool.run(
            f"{HERE}:rank_moe_step", params):
        assert r_cut == 4                     # w1, b1, w2, b2 of one block
        assert abs(r_loss - loss) <= 1e-5 * abs(loss)
        assert abs(r_norm - norm) <= 1e-5 * norm
        np.testing.assert_array_equal(r_cm, cm)
        assert r_grads.keys() == grads.keys()
        for k, want in grads.items():
            np.testing.assert_allclose(
                r_grads[k], want, rtol=0, err_msg=str(k),
                atol=1e-4 * max(np.abs(want).max(), 1e-6))
        for k, want in after.items():
            np.testing.assert_allclose(r_after[k], want, rtol=0, atol=1e-5,
                                       err_msg=str(k))
