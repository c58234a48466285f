"""The port's flash-attention backward (mme_tpu_torch/ops/flash_attention.py)
against the Pallas backward kernel of mme_tpu/ops/flash_attention.py, run in
interpret mode, and against autograd through the non-flash path.

On the CPU the port's wrapper runs its plain version, which is written from
the kernel's arithmetic; the CUDA kernel is held against that plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 gradients agree to 1e-5 absolute + relative (the two sides
sum the same fp32 products in other orders); bf16 to 2e-2 absolute + 1e-2
relative (P and dS are rounded to bf16 on both sides at fp32 values that
differ in the last place, and each gradient is rounded once more).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.ops import attention as j_attn
from mme_tpu.ops import flash_attention as j_flash

from mme_tpu_torch.ops import attention, kernels
from mme_tpu_torch.ops.flash_attention import (LSE_MASKED, FlashAttention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd_plain)

torch.set_num_threads(2)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """128-wide Pallas blocks, so a sequence of 200 has a ragged last block
    on both axes of the backward."""
    monkeypatch.setenv("MME_FLASH_BQ", "128")
    monkeypatch.setenv("MME_FLASH_BK", "128")
    monkeypatch.setenv("MME_FLASH_BK_BWD", "128")


def _inputs(seed, B, Sq, Sk, H, D, lengths):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32)
            for _ in range(2))
    bias_k = None
    if lengths is not None:
        keep = np.arange(Sk)[None, :] < np.asarray(lengths)[:, None]
        bias_k = ((1.0 - keep) * j_attn.NEG_INF).astype(np.float32)
    return q, k, v, do, bias_k


def _pallas_bwd(q, k, v, bias_k, out, lse, do, jdtype):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    pack = j_flash._pack_factor(H, D)
    flat = lambda x, S: jnp.asarray(x.reshape(B, S, H * D)).astype(jdtype)
    bias = jnp.zeros((B, Sk), jnp.float32) if bias_k is None \
        else jnp.asarray(bias_k)
    dq, dk, dv = j_flash._bwd_flat(
        flat(q, Sq), flat(k, Sk), flat(v, Sk), bias, flat(out, Sq),
        jnp.asarray(lse.reshape(B * (H // pack), pack, Sq)), flat(do, Sq),
        D, pack, True)
    return tuple(np.asarray(x.astype(jnp.float32)).reshape(B, -1, H, D)
                 for x in (dq, dk, dv))


CASES = {
    "d64_even_heads": (2, 200, 200, 2, 64, [200, 131]),
    "d128": (1, 200, 200, 1, 128, [170]),
    "ragged_sq_ne_sk": (2, 130, 200, 2, 64, [200, 57]),
    "no_bias": (2, 200, 200, 2, 64, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_pallas_bwd_kernel(case, dtype):
    B, Sq, Sk, H, D, lengths = CASES[case]
    q, k, v, do, bias_k = _inputs(1, B, Sq, Sk, H, D, lengths)
    tdtype = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdtype) for x in (q, k, v, do))
    tb = None if bias_k is None else torch.from_numpy(bias_k)
    out, lse = flash_attention_fwd_plain(tq, tk, tv, tb)
    got = flash_attention_bwd_plain(tq, tk, tv, tb, out, lse, tdo)
    want = _pallas_bwd(q, k, v, bias_k, out.float().numpy(), lse.numpy(), do,
                       getattr(jnp, dtype))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdtype
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])


def test_bwd_sentinel_row_gets_no_gradient_on_both_sides():
    """A row whose every score is -inf carries the sentinel LSE: P = 0 and
    every gradient of that batch row is zero, in the port and in JAX."""
    q, k, v, do, _ = _inputs(2, 2, 200, 200, 2, 64, None)
    bias_k = np.zeros((2, 200), np.float32)
    bias_k[1] = -np.inf
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, do, bias_k))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, tb)
    assert torch.all(lse[1] == LSE_MASKED) and torch.all(out[1] == 0)
    got = flash_attention_bwd_plain(tq, tk, tv, tb, out, lse, tdo)
    want = _pallas_bwd(q, k, v, bias_k, out.numpy(), lse.numpy(), do,
                       jnp.float32)
    for a, b in zip(got, want):
        assert torch.all(a[1] == 0) and torch.isfinite(a).all()
        np.testing.assert_array_equal(b[1], 0.0)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)


def _loss_grads_torch(fn, q, k, v):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fn(*leaves) ** 2).sum().backward()
    return [x.grad.numpy() for x in leaves]


def test_flash_autograd_matches_jax_grad_of_interpreted_kernel():
    """FlashAttention under torch.autograd against jax.grad through the
    Pallas forward and backward kernels, on the loss of
    tests/test_flash_attention.py."""
    q, k, v, _, bias_k = _inputs(3, 1, 192, 192, 2, 64, [150])
    jbias = jnp.asarray(bias_k)[:, None, None, :]

    def j_loss(q, k, v):
        return (j_flash.flash_attention_shd(q, k, v, jbias,
                                            interpret=True) ** 2).sum()

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tb = torch.from_numpy(bias_k)
    got = _loss_grads_torch(lambda a, b, c: FlashAttention.apply(a, b, c, tb),
                            q, k, v)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("lengths", [[77, 30], None])
def test_bwd_plain_matches_autograd_through_non_flash_path(lengths):
    """The hand-written backward against autograd's own through the plain
    attention path, in fp32."""
    q, k, v, _, bias_k = _inputs(4, 2, 77, 77, 3, 64, lengths)
    tb = None if bias_k is None else torch.from_numpy(bias_k)
    bias4 = None if tb is None else tb[:, None, None, :]
    want = _loss_grads_torch(
        lambda a, b, c: attention.dot_product_attention_shd(a, b, c, bias4),
        q, k, v)
    got = _loss_grads_torch(lambda a, b, c: FlashAttention.apply(a, b, c, tb),
                            q, k, v)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_row_masked_by_bias_follows_non_flash_gradient():
    """A query row whose every key carries the -0.7·f32max mask bias has
    the uniform P of the non-flash path, so its dV is not zero: the port
    equals the non-flash gradient (JAX's and its own). The JAX kernel pads
    its ragged last key block with a -1e30 bias that beats the mask, gives
    O = 0 there and zero gradients: a reference-side deviation the port
    does not copy. Both are recorded."""
    B, S, H, D = 2, 200, 2, 64
    q, k, v, _, bias_k = _inputs(5, B, S, S, H, D, [0, 150])
    jbias = jnp.asarray(bias_k)[:, None, None, :]
    args = tuple(map(jnp.asarray, (q, k, v)))

    def j_loss(use_flash):
        def f(q, k, v):
            out = (j_flash.flash_attention_shd(q, k, v, jbias, interpret=True)
                   if use_flash else j_attn.dot_product_attention_shd(
                       q, k, v, jbias, use_flash=False))
            return (out ** 2).sum()
        return f

    non_flash = jax.grad(j_loss(False), argnums=(0, 1, 2))(*args)
    pallas = jax.grad(j_loss(True), argnums=(0, 1, 2))(*args)
    tb = torch.from_numpy(bias_k)
    got = _loss_grads_torch(lambda a, b, c: FlashAttention.apply(a, b, c, tb),
                            q, k, v)
    for name, a, b, c in zip("qkv", got, non_flash, pallas):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")
        np.testing.assert_array_equal(np.asarray(c)[0], 0.0)
    assert np.abs(got[2][0]).max() > 1e-3           # dV of the masked row
    # the unmasked row agrees with the JAX kernel too
    for a, c in zip(got, pallas):
        np.testing.assert_allclose(a[1], np.asarray(c)[1], atol=1e-4,
                                   rtol=1e-5)


def test_strided_qkv_views_give_the_contiguous_result():
    """q, k, v as views of one fused [B, S, 3, H, D] tensor, as the model
    hands them over, and a dO with a non-unit last stride."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 50, 3, 2, 64)).astype(
        np.float32))
    bias = torch.from_numpy(_inputs(6, 2, 50, 50, 2, 64, [50, 20])[4])
    do = torch.from_numpy(rng.standard_normal((2, 50, 64, 2)).astype(
        np.float32)).permute(0, 1, 3, 2)
    views = [qkv[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous() and do.stride(-1) != 1
    out, lse = flash_attention_fwd_plain(*views, bias)
    before = kernels.LAUNCHES["flash_bwd"]
    got = flash_attention_bwd(*views, bias, out, lse, do)
    want = flash_attention_bwd_plain(*(x.contiguous() for x in views), bias,
                                     out, lse, do.contiguous())
    assert kernels.LAUNCHES["flash_bwd"] == before      # CPU: plain version
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
