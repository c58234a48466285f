"""The port's fused LayerNorm (mme_tpu_torch/ops/layer_norm.py) against
mme_tpu's, whose Pallas kernels run in interpret mode, on the same
numpy-seeded inputs. On the CPU the port's function runs its plain versions:
the forward formula and the backward kernel's explicit formula.

Tolerances. fp32: 1e-5 absolute on y and dx, 1e-5 of the largest element on
dscale and dbias (sums over N rows in another order). bf16: y and dx are
rounded to bf16 on both sides from fp32 values that differ in the last
place, so one bf16 step (2^-8 relative) at most: 2e-2 at values of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.ops import layer_norm as j_ln

from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops import layer_norm as t_ln

torch.set_num_threads(2)

_J_DTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_T_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
_TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _inputs(n, h, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(h)).astype(np.float32)
    g = rng.standard_normal((n, h)).astype(np.float32)
    return x, scale, bias, g


def _np(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,h", [(300, 128), (1, 128), (300, 96), (1, 96)])
def test_fused_layer_norm_matches_jax_interpret(dtype, n, h):
    x, scale, bias, g = _inputs(n, h)
    jx = jnp.asarray(x).astype(_J_DTYPE[dtype])
    jg = jnp.asarray(g).astype(_J_DTYPE[dtype])
    want, vjp = jax.vjp(
        lambda a, s, b: j_ln.fused_layer_norm(a, s, b, 1e-5, interpret=True),
        jx, jnp.asarray(scale), jnp.asarray(bias))
    want_dx, want_ds, want_db = vjp(jg)

    tx = torch.from_numpy(x).to(_T_DTYPE[dtype]).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    before = dict(kernels.LAUNCHES)
    got = t_ln.fused_layer_norm(tx, ts, tb, 1e-5)
    dx, ds, db = torch.autograd.grad(
        got, (tx, ts, tb), torch.from_numpy(g).to(_T_DTYPE[dtype]))
    assert kernels.LAUNCHES == before          # a CPU tensor: plain versions
    assert got.dtype == dx.dtype == _T_DTYPE[dtype]
    assert ds.dtype == db.dtype == torch.float32
    tol = _TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(dx.float().numpy(), _np(want_dx), atol=tol,
                               rtol=0)
    for a, b in ((ds, want_ds), (db, want_db)):
        b = _np(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("n,h", [(300, 128), (7, 96)])
def test_backward_formula_matches_autograd_of_the_plain_path(n, h):
    """The kernel's explicit backward against autograd through
    ``layer_norm``, in fp32: 1e-5 of each gradient's scale."""
    x, scale, bias, g = _inputs(n, h, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = t_ln.layer_norm(*leaves, 1e-5, torch.float32)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    got = t_ln.fused_layer_norm_bwd_plain(torch.from_numpy(g), leaves[0],
                                          leaves[1], 1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * max(b.abs().max().item(), 1))


def test_leading_shape_and_expanded_gradient():
    x, scale, bias, _ = _inputs(2 * 5 * 3, 64, seed=2)
    tx = torch.from_numpy(x).reshape(2, 5, 3, 64).requires_grad_()
    y = t_ln.fused_layer_norm(tx, torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-6)
    assert y.shape == tx.shape
    y.sum().backward()                       # autograd expands a scalar
    ref = torch.from_numpy(x).reshape(2, 5, 3, 64).requires_grad_()
    t_ln.layer_norm(ref, torch.from_numpy(scale), torch.from_numpy(bias),
                    1e-6, torch.float32).sum().backward()
    torch.testing.assert_close(tx.grad, ref.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_module_with_interpret_matches_jax_module(monkeypatch, dtype):
    """``FusedLayerNorm`` with MME_FUSED_LN=interpret in both packages, and
    the port's fused path against its plain path."""
    x, scale, bias, g = _inputs(2 * 150, 128, seed=3)
    x3 = x.reshape(2, 150, 128)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    j_mod = j_ln.FusedLayerNorm(epsilon=1e-5, dtype=_J_DTYPE[dtype])
    mod = t_ln.FusedLayerNorm(128, 1e-5, _T_DTYPE[dtype], device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x3).to(_T_DTYPE[dtype])
    plain = mod(tx)
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    want = j_mod.apply(params, jnp.asarray(x3).astype(_J_DTYPE[dtype]))
    calls = []
    real = t_ln.fused_layer_norm
    monkeypatch.setattr(t_ln, "fused_layer_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = mod(tx)
    assert calls == [1] and got.dtype == _T_DTYPE[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=_TOL[dtype], rtol=0)
    assert torch.equal(got, plain)           # same arithmetic on the CPU


def test_dispatch_rule(monkeypatch):
    use = t_ln.use_fused_ln
    monkeypatch.delenv("MME_FUSED_LN", raising=False)
    assert not use(768, torch.bfloat16, 4096)            # default off
    monkeypatch.setenv("MME_FUSED_LN", "0")
    assert not use(768, torch.bfloat16, 4096)
    monkeypatch.setenv("MME_FUSED_LN", "1")
    assert use(768, torch.bfloat16, 4096) and use(512, torch.float32, 1024)
    assert not use(768, torch.bfloat16, 1023)            # rows < 1024: plain
    assert not use(768, torch.bfloat16, 560)             # text tower, batch 8
    assert not use(768, torch.bfloat16, 8)               # pooled [B, H]
    assert not use(100, torch.bfloat16, 4096)            # h % 8
    assert not use(768, torch.float16, 4096)
    assert not use(768, torch.bfloat16, 4096, "cpu")     # a CPU tensor
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    assert use(100, torch.bfloat16, 1, "cpu")            # lifts every gate
    # the module on the CPU with the knob at 1 stays on the plain path
    monkeypatch.setenv("MME_FUSED_LN", "1")
    mod = t_ln.FusedLayerNorm(64, device="cpu")
    monkeypatch.setattr(t_ln, "fused_layer_norm", None)  # would raise
    assert mod(torch.zeros(2048, 64)).shape == (2048, 64)


def test_fp32_input_in_a_bf16_module_gives_the_module_dtype(monkeypatch):
    """The TPU kernel returns x's dtype, the non-fused path of both packages
    the module's. The port's fused path follows the non-fused contract."""
    x, scale, bias, _ = _inputs(40, 128, seed=4)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    j_mod = j_ln.FusedLayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    mod = t_ln.FusedLayerNorm(128, 1e-5, torch.bfloat16, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    monkeypatch.setenv("MME_FUSED_LN", "0")
    j_plain = j_mod.apply(params, jnp.asarray(x))
    plain = mod(torch.from_numpy(x))
    assert j_plain.dtype == jnp.bfloat16 and plain.dtype == torch.bfloat16
    monkeypatch.setenv("MME_FUSED_LN", "interpret")
    j_fused = j_mod.apply(params, jnp.asarray(x))
    fused = mod(torch.from_numpy(x))
    assert j_fused.dtype == jnp.float32            # the reference's deviation
    assert fused.dtype == torch.bfloat16           # the port: module's dtype
    assert torch.equal(fused, plain)
    np.testing.assert_allclose(fused.detach().float().numpy(), _np(j_fused),
                               atol=2e-2, rtol=0)
    # and the gradient comes back in x's dtype
    tx = torch.from_numpy(x).requires_grad_()
    mod(tx).float().sum().backward()
    assert tx.grad.dtype == torch.float32


def test_a_device_without_a_kernel_raises():
    x = torch.zeros(4, 64, device="meta")
    w = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_ln.fused_layer_norm_fwd(x, w, w, 1e-6, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        t_ln.fused_layer_norm_bwd(x, x, w, 1e-6)
