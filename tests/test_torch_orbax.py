"""``tools/orbax_to_torch.py``: a checkpoint that JAX's orbax manager
(``mme_tpu/train/checkpoint.py``) wrote restores into the port's
``CheckpointManager`` (``mme_tpu_torch/train/checkpoint.py``) bit for bit.

JAX's manager writes a tiny ``TAVModel`` ``TrainState``: parameters drawn
with numpy (``convert.init_params``), bf16 moments, count, step, an
accumulation buffer and its count set to drawn values, once with the flat
``layer_<i>`` trees and once with every encoder in the scan layout
(``convert_tree_to_scan``), into best and into latest; and a BatchNorm
net (a conv, a BatchNorm, a dense head) behind ``BatchModel`` with fp32 moments, a
trainable mask (its frozen leaves carry no moments) and drawn running
statistics. The tool converts each; the port restores it into a state
built as its CLIs build one, and every parameter, moment, buffer and
counter equals JAX's (back in the flax layout through ``convert.to_flax``
/ ``stats_to_flax``). The restored TAV model's logits on one batch match
JAX's on the checkpoint's parameters within ``test_torch_model.py``'s
tolerance (1e-4).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.models import fusion as j_fusion
from mme_tpu.models.layers import convert_tree_to_scan
from mme_tpu.train.checkpoint import CheckpointManager as JaxManager
from mme_tpu.train.steps import TrainState as JaxState
from mme_tpu.train.steps import make_optimizer as j_make_optimizer

from mme_tpu_torch.cli.common import BatchModel
from mme_tpu_torch.convert import (_leaves, init_params, init_variables,
                                   stats_to_flax, to_flax)
from mme_tpu_torch.models.layers import Conv, Dense
from mme_tpu_torch.models.norm import BatchNorm
from mme_tpu_torch.models.fusion import TAVModel, TAVSpec
from mme_tpu_torch.train.build_tav import example_tav_batch
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.steps import (TrainState, make_optimizer,
                                       model_buffers)
from tools import orbax_to_torch

torch.set_num_threads(2)

SPEC = TAVSpec(output_dim=7).tiny()
J_SPEC = j_fusion.TAVSpec(output_dim=7).tiny()
STEP, COUNT, ACCUM_COUNT = 5, 3, 2


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _drawn(tree, rng):
    """Every leaf of an abstract tree (``jax.eval_shape``) as a numpy
    array: floats drawn non-zero in their dtype, int32 scalars (the
    optimizer's counts) ``COUNT``, anything else (the dither key) zero."""
    def draw(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            v = rng.standard_normal(x.shape).astype(np.float32) + 3.0
            return v.astype(x.dtype)
        if x.dtype == jnp.int32 and x.shape == ():
            return np.asarray(COUNT, np.int32)
        return np.zeros(x.shape, x.dtype)
    return jax.tree.map(draw, tree)


def _adam(opt_state):
    """JAX's Adam state in its optax chain."""
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


def _jax_state(params, tx, rng, batch_stats=None, accum=True):
    """A JAX TrainState of numpy leaves: ``params`` and ``batch_stats`` as
    given, the optimizer state (its structure from ``tx.init`` traced by
    ``jax.eval_shape``, never run), the accumulation buffer and the
    counters drawn."""
    shapes = jax.eval_shape(lambda p: JaxState.create(
        p, tx, batch_stats=batch_stats, use_accum=accum), params)
    return shapes.replace(
        step=np.asarray(STEP, np.int32), params=params,
        opt_state=_drawn(shapes.opt_state, rng), batch_stats=batch_stats,
        accum_grads=_drawn(shapes.accum_grads, rng) if accum else None,
        accum_count=np.asarray(ACCUM_COUNT, np.int32))


def _save(directory, state, which):
    mgr = JaxManager(directory)
    if which == "best":
        mgr.save_best(state, {"epoch": 1, "val_loss": 0.5})
    else:
        mgr.save_latest(state, {"epoch": 1, "batch": 3, "preempted": True})
    mgr.wait()


def _assert_tree_equal(got, want, cast=np.float32):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(
            got[path], np.asarray(want[path]).astype(cast), err_msg=str(path))


@pytest.fixture(scope="module")
def tav():
    """The tiny TAV parameters (numpy), JAX's bf16-moment state on them,
    and one batch."""
    os.environ["MME_OPT_STATE"] = "bf16"
    try:
        tx = j_make_optimizer(lambda s: 1e-3, 1e-4, 1.0)
    finally:
        del os.environ["MME_OPT_STATE"]
    params = init_params(SPEC, 0)
    state = _jax_state(params, tx, np.random.default_rng(1))
    return params, state, example_tav_batch(SPEC, 2, 12, 4000, seed=3)


def _port_tav_state(model):
    tx = make_optimizer(lambda s: 1e-3, 1e-4, 1.0, state_dtype="bf16")
    return TrainState.create(
        model.parameters(), tx, use_accum=True,
        generator=torch.Generator().manual_seed(0),
        names=[n for n, _ in model.named_parameters()],
        buffers=model_buffers(model))


def _convert_and_restore(tav, directory, layout, which):
    """JAX's state written in ``layout`` into ``which``, converted by the
    tool, restored by the port: (port model, restored state, meta, JAX's
    meta)."""
    _, state, _ = tav
    if layout == "scan":
        # the scan case without an accumulation buffer, as the CLIs save
        state = state.replace(accum_grads=None, accum_count=np.asarray(
            0, np.int32))
    saved = state
    if layout == "scan":
        adam = _adam(state.opt_state)
        scanned = adam._replace(mu=convert_tree_to_scan(adam.mu),
                                nu=convert_tree_to_scan(adam.nu))
        saved = state.replace(
            params=convert_tree_to_scan(state.params),
            opt_state=jax.tree.map(lambda x: scanned if x is adam else x,
                                   state.opt_state,
                                   is_leaf=lambda x: x is adam))
        assert "layers_scan" in saved.params["model"]["fusion_encoder"]
    _save(str(directory / "jax"), saved, which)
    state_used[layout, which] = state
    out = orbax_to_torch.main([str(directory / "jax"), str(directory / "port"),
                               "--model", "TAVModel", "--tiny",
                               "--which", which, "--seed", "11"])
    assert os.path.isdir(out)
    model = TAVModel(SPEC, device="cpu")
    mgr = CheckpointManager(str(directory / "port"), use_async=False)
    port = _port_tav_state(model)
    restored, meta = (mgr.restore_best(port) if which == "best"
                      else mgr.restore_latest(port))
    with open(directory / "jax" / f"{which}_meta.json") as f:
        jmeta = json.load(f)
    jmeta.pop("_data", None)
    return model, restored, meta, jmeta


state_used = {}


@pytest.fixture(scope="module")
def restored(tav, tmp_path_factory):
    """``_convert_and_restore`` once per (layout, which) for the file."""
    cache = {}

    def get(layout, which):
        if (layout, which) not in cache:
            cache[layout, which] = _convert_and_restore(
                tav, tmp_path_factory.mktemp(f"{layout}_{which}"), layout,
                which)
        return cache[layout, which]
    return get


@pytest.mark.parametrize("layout,which", [("flat", "best"),
                                          ("scan", "latest")])
def test_tav_checkpoint_restores_bit_for_bit(tav, restored, layout, which):
    model, got, meta, jmeta = restored(layout, which)
    state = state_used[layout, which]
    assert meta["epoch"] == 1
    assert {k: v for k, v in meta.items() if k != "_data"} == jmeta
    assert got.step == STEP
    assert got.accum_count == (ACCUM_COUNT if layout == "flat" else 0)
    o = got.opt_state
    assert o.count == COUNT and o.seed == 11
    adam = _adam(state.opt_state)
    assert all(m.dtype == torch.bfloat16 for m in o.mu + o.nu)
    _assert_tree_equal(to_flax(model), state.params)
    # bf16 moments compared in fp32: both sides hold the same bf16 values
    _assert_tree_equal(to_flax(model, o.mu), adam.mu)
    _assert_tree_equal(to_flax(model, o.nu), adam.nu)
    if state.accum_grads is None:
        assert got.accum_grads is None
    else:
        _assert_tree_equal(to_flax(model, got.accum_grads),
                           state.accum_grads)


def test_restored_tav_logits_match_jax(tav, restored):
    params, _, batch = tav
    model = restored("flat", "best")[0]
    model.eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax.jit(lambda p, b: j_fusion.TAVModel(J_SPEC).apply(
        {"params": p}, b))(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-4, rtol=1e-4)


class _TinyBN(torch.nn.Module):
    """conv → BatchNorm → dense, from the port's layers: the smallest
    model with running statistics."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(3, 4, (3, 3), device="cpu")
        self.bn = BatchNorm(4, device="cpu")
        self.head = Dense(4, 3, device="cpu")


def _bn_model():
    return BatchModel(_TinyBN(), ("image",))


def _port_paths(net):
    """Each parameter's flax path, in the order of ``net.parameters()``."""
    by_id = {id(p): tuple(path) for path, p, *_ in _leaves(net)}
    return [by_id[id(p)] for p in net.parameters()]


def test_batchnorm_checkpoint_with_frozen_leaves(tmp_path):
    """fp32 moments under a trainable mask (JAX's multi_transform leaves
    the frozen leaves out of the Adam state) and the running statistics
    as the port's buffers."""
    model = _bn_model()
    variables = init_variables(model.net, seed=4)
    rng = np.random.default_rng(5)
    stats = jax.tree.map(lambda x: rng.random(x.shape, np.float32) + 0.5,
                         variables["batch_stats"])
    params = variables["params"]
    paths = _port_paths(model.net)
    frozen = set(paths[:2])
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: tuple(k.key for k in path) not in frozen, params)
    assert sum(jax.tree.leaves(mask)) == len(paths) - 2
    tx = j_make_optimizer(lambda s: 1e-3, 1e-4, 1.0, trainable_mask=mask,
                          state_dtype="fp32")
    state = _jax_state(params, tx, rng, batch_stats=stats, accum=False)
    _save(str(tmp_path / "jax"), state, "best")
    # through the command line, the model named by module:function
    orbax_to_torch.main([str(tmp_path / "jax"), str(tmp_path / "port"),
                         "--model", "tests.test_torch_orbax:_bn_model",
                         "--seed", "2"])

    trainable = [p not in frozen for p in paths]
    port = TrainState.create(
        model.parameters(),
        make_optimizer(lambda s: 1e-3, 1e-4, 1.0, trainable_mask=trainable,
                       state_dtype="fp32"),
        use_accum=False, names=[n for n, _ in model.named_parameters()],
        buffers=model_buffers(model))
    restored, _ = CheckpointManager(str(tmp_path / "port")).restore_best(
        port)
    o = restored.opt_state
    assert restored.step == STEP and o.count == COUNT and o.seed == 2
    assert restored.accum_grads is None
    assert [m is None for m in o.mu] == [not t for t in trainable]
    _assert_tree_equal(to_flax(model.net), params)
    _assert_tree_equal(stats_to_flax(model.net), stats)
    adam = _adam(state.opt_state)
    for key in ("mu", "nu"):
        got = dict(_flat(to_flax(model.net, [
            torch.zeros_like(p) if m is None else m
            for p, m in zip(model.parameters(), getattr(o, key))])))
        want = {p: a for p, a in _flat(getattr(adam, key))
                if hasattr(a, "shape")}
        assert set(want) == set(paths) - frozen
        for path, a in want.items():
            assert got[path].dtype == np.float32
            np.testing.assert_array_equal(got[path], np.asarray(a))
