"""The port's MoE FFN (mme_tpu_torch/models/moe.py) against
mme_tpu/models/moe.py on the same numpy-seeded inputs and flax weights:
router top-k gates and aux, dispatch/combine with its capacity cut,
``_capacity``, the single-expert MoE against a dense ``Mlp``, and the
``MoETransformerEncoder`` forward, aux and every gradient leaf, with the
routes compared token by token.

Everything runs in fp32, where the routes of the two packages must agree
exactly (a near-tie in the router could flip a token's expert set in
lower precision; the bf16 legs live in tests/test_torch_fusion_variants.py
and compare logits only). Tolerances: gates, aux and outputs within 1e-5
absolute at unit scale; gradients within 1e-5 of each leaf's largest
element, as tests/test_torch_train.py holds them (fp32 sums in other
orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.models import layers as j_layers
from mme_tpu.models import moe as j_moe

from mme_tpu_torch.convert import from_flax, grads_to_flax
from mme_tpu_torch.models.layers import EncoderSpec, Mlp
from mme_tpu_torch.models.moe import (MoEMlp, MoESpec, MoETransformerEncoder,
                                      _capacity, dispatch_combine,
                                      router_gates)

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 1e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _tied_logits():
    """[2, 6, 4] router logits with exact ties in some rows: the first
    index must win, as in jnp.argmax."""
    logits = _normal((2, 6, 4), 0)
    logits[0, 0] = [1.0, 1.0, 0.5, 0.5]
    logits[0, 1] = [0.2, 0.7, 0.7, 0.7]
    logits[1, 2] = 0.0
    return logits


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_gates_match_jax(top_k):
    logits = _tied_logits()
    want_gates, want_aux = j_moe.router_gates(jnp.asarray(logits), top_k)
    gates, aux = router_gates(torch.from_numpy(logits), top_k)
    np.testing.assert_array_equal(gates.numpy() > 0,
                                  np.asarray(want_gates) > 0)
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=ATOL)
    nnz = (gates.numpy() > 0).sum(-1)
    assert (nnz == top_k).all()
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    if top_k == 1:
        # Switch convention: the raw p_max, not renormalised to 1
        np.testing.assert_allclose(gates.sum(-1).numpy(), probs.max(-1),
                                   rtol=1e-6)
    else:
        np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert 0.5 < aux.item() < 4.0


def test_router_top1_has_task_gradient():
    """With top-1 the combine weight carries d(loss)/d(router)."""
    layer = MoEMlp(EncoderSpec(hidden=8, intermediate=16),
                   MoESpec(num_experts=4, top_k=1), device="cpu")
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    y, _ = layer(torch.from_numpy(_normal((2, 6, 8), 8)))
    (y ** 2).sum().backward()
    assert layer.router.weight.grad.abs().sum().item() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_combine_matches_jax_and_cuts_at_capacity(dtype):
    logits = _normal((2, 8, 4), 1)
    jgates, _ = j_moe.router_gates(jnp.asarray(logits), 2)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    C = 3
    want_d, want_c = j_moe.dispatch_combine(jgates.astype(jdt), C)
    gates = torch.from_numpy(np.asarray(jgates)).to(dtype)
    dispatch, combine = dispatch_combine(gates, C)
    assert dispatch.dtype == combine.dtype == dtype
    np.testing.assert_array_equal(dispatch.float().numpy(),
                                  np.asarray(want_d, np.float32))
    np.testing.assert_array_equal(combine.float().numpy(),
                                  np.asarray(want_c, np.float32))
    d = dispatch.float().numpy()
    assert (d.sum(axis=1) <= 1).all()          # a slot holds one token
    assert (d.sum(axis=(2, 3)) <= 2).all()     # a token takes at most k
    assert (combine.float().numpy().sum(3)
            <= gates.float().numpy() + 1e-6).all()
    # 8 tokens × 2 routes over 4 experts of 3 slots: some tokens are cut
    routed = (gates.float().numpy() > 0).sum()
    assert d.sum() < routed
    per_expert = (gates.float().numpy() > 0).sum(axis=1)     # [B, E]
    np.testing.assert_array_equal(d.sum(axis=(1, 3)),
                                  np.minimum(per_expert, C))


def test_capacity_formula_matches_jax():
    for seq in (1, 10, 70, 473):
        for k in (1, 2):
            for e in (1, 4, 8):
                for f in (1.0, 1.25, 1.5, 2.0):
                    assert _capacity(seq, k, e, f) == j_moe._capacity(
                        seq, k, e, f), (seq, k, e, f)
    assert _capacity(473, 2, 4, 1.5) == 355


def test_moe_mlp_with_one_expert_is_the_dense_mlp():
    """E = 1, top-1, ample capacity: the gate is p = 1 and the MoE MLP is
    the dense Mlp on the same weights, as in JAX."""
    spec = EncoderSpec(hidden=8, intermediate=16)
    moe = MoEMlp(spec, MoESpec(num_experts=1, top_k=1, capacity_factor=2.0),
                 device="cpu")
    dense = Mlp(spec, device="cpu")
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.from_numpy(_normal(p.shape, p.numel())))
        dense.fc1.weight.copy_(moe.w1[0].t())
        dense.fc1.bias.copy_(moe.b1[0])
        dense.fc2.weight.copy_(moe.w2[0].t())
        dense.fc2.bias.copy_(moe.b2[0])
        x = torch.from_numpy(_normal((2, 6, 8), 2))
        y, aux = moe(x)
        np.testing.assert_allclose(y.numpy(), dense(x).numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert aux.item() == pytest.approx(1e-2)   # E · 1 · 1 · weight


SPEC = dict(hidden=16, heads=2, layers=4, intermediate=32)


@pytest.fixture(scope="module", params=["pre", "post"])
def encoder_ref(request):
    """A tiny JAX MoETransformerEncoder (layers 1 and 3 carry MoE), its
    output, aux, gradients and router logits on one input, in fp32."""
    ln_style = request.param
    jspec = j_layers.EncoderSpec(**SPEC, ln_style=ln_style)
    enc = j_moe.MoETransformerEncoder(jspec, j_moe.MoESpec())
    x = _normal((2, 10, 16), 4)
    bias = np.zeros((2, 1, 1, 10), np.float32)
    bias[1, ..., 7:] = -0.7 * np.finfo(np.float32).max    # padded keys
    params = jax.tree.map(np.asarray, enc.init(jax.random.PRNGKey(5),
                                               jnp.asarray(x))["params"])
    # a fixed projection of the output: sum(y²) would be constant through
    # a final post-LN and leave only rounding noise in the gradients
    proj = _normal((2, 10, 16), 6)

    def loss(p):
        (y, inter) = enc.apply({"params": p}, jnp.asarray(x),
                               jnp.asarray(bias), mutable=["intermediates"])
        aux = j_moe.collect_aux_loss(inter["intermediates"])
        return jnp.sum(y * proj) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    _, state = enc.apply({"params": params}, jnp.asarray(x),
                         jnp.asarray(bias), capture_intermediates=True,
                         mutable=["intermediates"])
    inter = state["intermediates"]
    routers = {i: np.asarray(inter[f"layer_{i}"]["moe_mlp"]["router"]
                             ["__call__"][0]) for i in (1, 3)}
    return (ln_style, x, bias, params, np.asarray(y), float(aux),
            jax.tree.map(np.asarray, grads), routers, proj)


def _port_encoder(ln_style, params):
    enc = MoETransformerEncoder(EncoderSpec(**SPEC, ln_style=ln_style),
                                MoESpec(), device="cpu")
    enc.load_state_dict(from_flax(params), strict=True)
    return enc


def test_moe_encoder_forward_aux_and_routes_match_jax(encoder_ref):
    ln_style, x, bias, params, want_y, want_aux, _, routers, _ = encoder_ref
    enc = _port_encoder(ln_style, params).eval()
    assert [type(getattr(enc, f"layer_{i}")).__name__ for i in range(4)] \
        == ["EncoderBlock", "MoEEncoderBlock"] * 2
    seen = {}
    for i in (1, 3):
        getattr(enc, f"layer_{i}").moe_mlp.router.register_forward_hook(
            lambda mod, args, out, i=i: seen.__setitem__(i, out.detach()))
    with torch.no_grad():
        y, aux = enc(torch.from_numpy(x), torch.from_numpy(bias))
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), want_aux, atol=ATOL)
    assert aux.item() > 0
    for i in (1, 3):
        np.testing.assert_allclose(seen[i].numpy(), routers[i], atol=ATOL)
        got, _ = router_gates(seen[i], 2)
        want, _ = j_moe.router_gates(jnp.asarray(routers[i]), 2)
        np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)


def test_moe_encoder_gradients_match_jax(encoder_ref):
    ln_style, x, bias, params, _, _, want, _, proj = encoder_ref
    enc = _port_encoder(ln_style, params).eval()
    y, aux = enc(torch.from_numpy(x), torch.from_numpy(bias))
    ((y * torch.from_numpy(proj)).sum() + aux).backward()
    got = dict(_flat(grads_to_flax(enc)))
    leaves = dict(_flat(want))
    assert got.keys() == leaves.keys()
    for path, b in leaves.items():
        np.testing.assert_allclose(got[path], b, rtol=0, err_msg=str(path),
                                   atol=GRAD_RTOL * max(np.abs(b).max(),
                                                        1e-6))
    for i in (1, 3):
        m = got[(f"layer_{i}", "moe_mlp", "router", "kernel")]
        assert np.abs(m).sum() > 0
        assert np.abs(got[(f"layer_{i}", "moe_mlp", "w1")]).sum() > 0


def test_no_aux_is_carried_across_forwards(encoder_ref):
    """The aux of a call is that call's alone: nothing accumulates in
    module state, in eval or training mode."""
    ln_style, x, bias, params, _, want_aux, _, _, _ = encoder_ref
    enc = _port_encoder(ln_style, params)
    xt, bt = torch.from_numpy(x), torch.from_numpy(bias)
    for mode in (enc.eval, enc.train):
        mode()
        with torch.no_grad():
            auxes = [enc(xt, bt)[1].item() for _ in range(3)]
        assert auxes == [auxes[0]] * 3
        np.testing.assert_allclose(auxes[0], want_aux, atol=ATOL)
    # half the batch routes on its own rows only: a different aux
    with torch.no_grad():
        part = enc(xt[:1], bt[:1])[1].item()
    assert part != auxes[0]


def test_expert_parallel_axis_raises():
    """``ep_axis`` without a mesh raises nothing and runs the unsharded
    layer, as JAX's does outside a mesh (tests/test_torch_expert_parallel.py
    holds it cut over two ranks)."""
    spec = EncoderSpec(hidden=8, intermediate=16)
    plain = MoEMlp(spec, MoESpec(), device="cpu")
    layer = MoEMlp(spec, MoESpec(ep_axis="ep"), device="cpu")
    assert layer.ep is None
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
        layer.load_state_dict(plain.state_dict())
        x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
        got, want = layer.eval()(x), plain.eval()(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
