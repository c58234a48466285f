"""The port's fused MLP (mme_tpu_torch/ops/fused_mlp.py) against mme_tpu's,
whose Pallas kernels run in interpret mode, on the same numpy-seeded inputs.
On the CPU the port's function runs its plain versions. The port stores
weights as [out, in], JAX as [in, out]: the test transposes.

Tolerances. fp32: 1e-5 of each tensor's largest element (sums over H, F or N
fp32 products in another order), which also covers the 1.5e-7 of the TPU
kernel's erf polynomial against the port's exact ``erf``. bf16: ``a`` and
``dh`` are rounded to bf16 on both sides at fp32 values that differ in the
last place, and each result is rounded to bf16 once more: 2e-2 of each
tensor's largest element.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mme_tpu.models import layers as j_layers
from mme_tpu.ops import fused_mlp as j_mlp

from mme_tpu_torch.convert import from_flax
from mme_tpu_torch.models import layers as t_layers
from mme_tpu_torch.ops import fused_mlp as t_mlp
from mme_tpu_torch.ops import kernels

torch.set_num_threads(2)

_J_DTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
_TOL = {"fp32": 1e-5, "bf16": 2e-2}
N, H, FF = 100, 32, 64        # N is ragged against any row tile


def _inputs(seed=0, n=N, h=H, f=FF):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=r(n, h), w1=r(f, h) * h ** -0.5, b1=r(f) * 0.3,
                w2=r(h, f) * f ** -0.5, b2=r(h) * 0.3, do=r(n, h))


def _close(got, want, tol, name):
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-3))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("act", t_mlp.ACTS)
def test_fused_mlp_matches_jax_interpret(act, dtype):
    a = _inputs()
    jd, td = _J_DTYPE[dtype], _T_DTYPE[dtype]
    jx, jw1, jw2, jdo = (jnp.asarray(a[k]).astype(jd)
                         for k in ("x", "w1", "w2", "do"))
    want, vjp = jax.vjp(
        lambda x, w1, b1, w2, b2: j_mlp.fused_mlp(x, w1, b1, w2, b2, act,
                                                  True),
        jx, jw1.T, jnp.asarray(a["b1"]), jw2.T, jnp.asarray(a["b2"]))
    j_dx, j_dw1, j_db1, j_dw2, j_db2 = vjp(jdo)

    leaves = [torch.from_numpy(a[k]).to(td if k in ("x", "w1", "w2")
                                        else torch.float32).requires_grad_()
              for k in ("x", "w1", "b1", "w2", "b2")]
    before = dict(kernels.LAUNCHES)
    out = t_mlp.fused_mlp(*leaves, act)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(a["do"]).to(td))
    assert kernels.LAUNCHES == before          # a CPU tensor: plain versions
    # gradients come back in each tensor's own dtype, as in JAX
    assert [g.dtype for g in grads] == [td, td, torch.float32, td,
                                        torch.float32]
    assert (j_dw1.dtype, j_db1.dtype) == (jd, jnp.float32)
    tol = _TOL[dtype]
    _close(out, want, tol, "out")
    for name, got, ref in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                              (j_dx, j_dw1.T, j_db1, j_dw2.T, j_db2)):
        _close(got, ref, tol, name)


@pytest.mark.parametrize("act", t_mlp.ACTS)
def test_bwd_plain_matches_autograd_of_the_unfused_chain(act):
    a = _inputs(seed=1)
    leaves = [torch.from_numpy(a[k]).requires_grad_()
              for k in ("x", "w1", "b1", "w2", "b2")]
    x, w1, b1, w2, b2 = leaves
    out = F.linear(t_layers.activation(act)(F.linear(x, w1, b1)), w2, b2)
    do = torch.from_numpy(a["do"])
    want = torch.autograd.grad(out, leaves, do)
    with torch.no_grad():
        torch.testing.assert_close(
            t_mlp.fused_mlp_fwd_plain(x, w1, b1, w2, b2, act), out,
            atol=1e-5, rtol=1e-5)
        got = t_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, do, act)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * max(w.abs().max().item(), 1))


def test_shape_rule_and_dispatch(monkeypatch):
    ok = t_mlp.kernel_supports
    # the four full-width MLPs of the TAV model all run through the kernels
    for h, f in ((768, 3072), (1024, 4096)):
        assert ok(h, f, torch.bfloat16) and ok(h, f, torch.float32)
    assert ok(256, 64, torch.float32)
    assert not ok(32, 64, torch.float32) and not ok(1280, 5120, torch.bfloat16)
    assert not ok(768, 3000, torch.bfloat16)
    assert not ok(768, 3072, torch.float16)
    x = torch.zeros(4, 768)
    monkeypatch.delenv("MME_FUSED_MLP", raising=False)
    assert not t_mlp.use_fused_mlp(x, 768, 3072, torch.float32)
    monkeypatch.setenv("MME_FUSED_MLP", "1")
    assert not t_mlp.use_fused_mlp(x, 768, 3072, torch.float32)   # CPU
    meta = torch.zeros(4, 768, device="meta")
    assert not t_mlp.use_fused_mlp(meta, 768, 3072, torch.float32)
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    assert t_mlp.use_fused_mlp(x, 32, 64, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        t_mlp.fused_mlp_fwd(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="activation"):
        t_mlp.act_pair("swish")


def test_bf16_scratch_and_bounds():
    """The bf16 kernels' transients: a and dh [N, F] and one db1 partial row
    per 128 rows; the bound counts 4 and 10 N·H·F flops."""
    s = t_mlp.scratch_shapes(11712, 3072)
    assert s == {"a": (11712, 3072), "dh": (11712, 3072),
                 "db1_rows": (92, 3072)}
    assert t_mlp.scratch_shapes(1, 64)["db1_rows"] == (1, 64)
    assert t_mlp.scratch_shapes(129, 64)["db1_rows"] == (2, 64)
    (f_ops, f_bytes, f_ms, f_by), (b_ops, _, b_ms, b_by) = t_mlp.bounds(
        11712, 768, 3072, 2)
    assert (f_ops, b_ops) == (4 * 11712 * 768 * 3072, 10 * 11712 * 768 * 3072)
    assert f_bytes == 2 * 11712 * 768 * 2 + 2 * 768 * 3072 * 2 + 3840 * 4
    assert f_by == b_by == "operations" and 0.11 < f_ms < 0.12 < b_ms


@pytest.mark.parametrize("a_mn,b_mn", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_gemm_operand_orders_on_cpu(a_mn, b_mn):
    """gemm_bf16 reads each operand's order from its strides (a transposed
    view is MN-major); on the CPU it is its plain version."""
    g = torch.Generator().manual_seed(a_mn * 2 + b_mn)
    a = torch.randn(24, 40, generator=g).bfloat16()
    b = torch.randn(40, 16, generator=g).bfloat16()
    a = a.t().contiguous().t() if a_mn else a
    b = b if b_mn else b.t().contiguous().t()
    assert t_mlp.gemm_operand_major(a, 1) == a_mn
    assert t_mlp.gemm_operand_major(b, 0) == b_mn
    before = dict(kernels.LAUNCHES)
    torch.testing.assert_close(t_mlp.gemm_bf16(a, b),
                               (a.float() @ b.float()).bfloat16())
    assert kernels.LAUNCHES == before


def test_gemm_operand_order_rejects_what_tma_cannot_read():
    x = torch.zeros(20, 36, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unit stride"):
        t_mlp.gemm_operand_major(x[:, ::2], 1)         # no unit stride
    with pytest.raises(ValueError, match="unit stride"):
        t_mlp.gemm_operand_major(x[:, :30], 1)         # 72-byte rows
    with pytest.raises(ValueError, match="2-D"):
        t_mlp.gemm_operand_major(torch.zeros(2, 3, 4), 1)


def _block_pair(spec_kw, seed=3):
    """One EncoderBlock in both packages on the same weights."""
    j_spec = j_layers.EncoderSpec(**spec_kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, j_spec.hidden)).astype(np.float32)
    j_block = j_layers.EncoderBlock(j_spec)
    params = j_block.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    # biases and LayerNorm parameters away from their 0/1 initial values
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(
            np.float32), params)
    block = t_layers.EncoderBlock(t_layers.EncoderSpec(**spec_kw),
                                  device="cpu")
    block.load_state_dict(from_flax(params), strict=True)
    return j_block, params, block, x


@pytest.mark.parametrize("ln_style", ["pre", "post"])
def test_encoder_block_with_interpret_in_both_packages(monkeypatch, ln_style):
    """MME_FUSED_MLP=interpret routes Mlp through the fused function in both
    packages: output and every gradient leaf agree (fp32: 2e-5, the JAX
    test's tolerance), and the port's fused block equals its unfused one."""
    kw = dict(hidden=32, heads=4, layers=1, intermediate=64,
              ln_style=ln_style)
    j_block, params, block, x = _block_pair(kw)
    block.eval()
    tx = torch.from_numpy(x)
    unfused = block(tx)
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    calls = []
    real = t_layers.fused_mlp
    monkeypatch.setattr(t_layers, "fused_mlp",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    out = block(tx)
    assert calls == [(48, 32)]
    want, vjp = jax.vjp(lambda p: j_block.apply({"params": p},
                                                jnp.asarray(x)), params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(out, unfused, atol=2e-5, rtol=2e-5)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    j_grads = vjp(jnp.asarray(g))[0]
    out.backward(torch.from_numpy(g))
    for name, want_g in (("fc1", j_grads["mlp"]["fc1"]),
                         ("fc2", j_grads["mlp"]["fc2"])):
        dense = getattr(block.mlp, name)
        np.testing.assert_allclose(dense.weight.grad.numpy(),
                                   np.asarray(want_g["kernel"]).T, atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(dense.bias.grad.numpy(),
                                   np.asarray(want_g["bias"]), atol=2e-5,
                                   rtol=1e-4)
    np.testing.assert_allclose(block.ln1.weight.grad.numpy(),
                               np.asarray(j_grads["ln1"]["scale"]),
                               atol=2e-5, rtol=1e-4)


def test_mlp_bf16_module_casts_weights_and_keeps_fp32_parameter_grads(
        monkeypatch):
    spec = t_layers.EncoderSpec(hidden=32, heads=4, layers=1, intermediate=64,
                                dtype=torch.bfloat16)
    mlp = t_layers.Mlp(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = torch.randn(3, 7, 32, generator=g)
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    seen = []
    real = t_layers.fused_mlp
    monkeypatch.setattr(
        t_layers, "fused_mlp",
        lambda *a: seen.append([t.dtype for t in a[:5]]) or real(*a))
    out = mlp(x)
    assert seen == [[torch.bfloat16, torch.bfloat16, torch.float32,
                     torch.bfloat16, torch.float32]]
    assert out.dtype == torch.bfloat16 and out.shape == (3, 7, 32)
    out.float().sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in mlp.parameters())
    monkeypatch.setenv("MME_FUSED_MLP", "0")
    torch.testing.assert_close(out.float(), mlp(x).float(), atol=2e-2,
                               rtol=2e-2)


def test_remat_on_and_off_bit_equal_with_dropout_and_both_knobs(monkeypatch):
    """Under remat the block is recomputed in the backward pass and the fused
    backward recomputes h inside that recomputed forward; with the generator
    rewound the gradients equal the unremat'd encoder's bit for bit."""
    monkeypatch.setenv("MME_FUSED_MLP", "interpret")
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    spec = t_layers.EncoderSpec(hidden=32, heads=4, layers=2, intermediate=64,
                                ln_style="pre", dropout=0.1,
                                attention_dropout=0.1, final_ln=True)
    plain = t_layers.TransformerEncoder(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    remat = t_layers.TransformerEncoder(
        dataclasses.replace(spec, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(3, 11, 32, generator=g)

    def grads(model):
        rng = torch.Generator().manual_seed(7)
        out = model(x, None, rng)
        got = torch.autograd.grad((out ** 2).sum(), list(model.parameters()))
        return out, got, rng.get_state()

    out_a, want, state_a = grads(plain)
    out_b, got, state_b = grads(remat)
    assert torch.equal(out_a, out_b) and torch.equal(state_a, state_b)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
