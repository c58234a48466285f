"""The port's ops (mme_tpu_torch/ops) against mme_tpu/ops on the same
numpy-seeded inputs: attention and its flash kernel's plain version,
LayerNorm, the audio mask math and the video token ops.

Tolerances: fp32 results agree to a few fp32 ulps (1e-5 absolute at unit
scale, the two sides sum in different orders); integer and boolean results
agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mme_tpu.ops import attention as j_attn
from mme_tpu.ops import audio as j_audio
from mme_tpu.ops import flash_attention as j_flash
from mme_tpu.ops import video as j_video
from mme_tpu.ops.layer_norm import FusedLayerNorm as JLayerNorm

from mme_tpu_torch.ops import attention, audio, kernels, video
from mme_tpu_torch.ops.flash_attention import (LSE_MASKED,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain)
from mme_tpu_torch.ops.layer_norm import layer_norm

torch.set_num_threads(2)


def _qkv(rng, B, S, H, D):
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _keep(rng, B, S, lengths=None):
    lengths = rng.integers(1, S + 1, B) if lengths is None else lengths
    return (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)


def test_additive_mask_matches_jax():
    keep = _keep(np.random.default_rng(0), 3, 9, [9, 4, 0])
    ours = attention.additive_mask(torch.from_numpy(keep)).numpy()
    ref = np.asarray(j_attn.additive_mask(jnp.asarray(keep)))
    assert ours.shape == (3, 1, 1, 9)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_attention_matches_jax_non_flash(with_bias):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 37, 3, 16)
    bias = (j_attn.additive_mask(jnp.asarray(_keep(rng, 2, 37)))
            if with_bias else None)
    ref = np.asarray(j_attn.dot_product_attention_shd(
        *map(jnp.asarray, (q, k, v)), bias, use_flash=False))
    ours = attention.dot_product_attention_shd(
        *map(torch.from_numpy, (q, k, v)),
        None if bias is None else torch.from_numpy(np.asarray(bias)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_flash_plain_matches_pallas_kernel(monkeypatch):
    """The kernel's plain version against the TPU kernel itself, run in
    interpret mode through _fwd_flat (called directly: with 8 CPU devices
    the public entry routes through the SPMD wrapper). 128-wide blocks over
    S=200 leave a ragged last block on both axes."""
    monkeypatch.setenv("MME_FLASH_BQ", "128")
    monkeypatch.setenv("MME_FLASH_BK", "128")
    B, S, H, D = 2, 200, 2, 64
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, B, S, H, D)
    bias_k = (1.0 - _keep(rng, B, S, [200, 131])) * j_attn.NEG_INF
    bias_k = bias_k.astype(np.float32)
    out, lse = j_flash._fwd_flat(
        *(jnp.asarray(x.reshape(B, S, H * D)) for x in (q, k, v)),
        jnp.asarray(bias_k), D, j_flash._pack_factor(H, D), True)
    o, l = flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                     torch.from_numpy(bias_k))
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(out).reshape(B, S, H, D),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(lse).reshape(B, H, S),
                               atol=1e-5, rtol=1e-6)


def test_fully_masked_row_follows_non_flash_contract(monkeypatch):
    """A query row whose every key is masked gets the mean of v, as in the
    non-flash path. The JAX kernel pads its ragged last key block with a
    -1e30 bias that beats the -0.7·f32max mask, so it returns 0 there: a
    reference-side deviation the port does not copy."""
    monkeypatch.setenv("MME_FLASH_BQ", "128")
    monkeypatch.setenv("MME_FLASH_BK", "128")
    B, S, H, D = 2, 200, 2, 64
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, B, S, H, D)
    keep = _keep(rng, B, S, [0, 150])
    bias = j_attn.additive_mask(jnp.asarray(keep))
    ref = np.asarray(j_attn.dot_product_attention_shd(
        *map(jnp.asarray, (q, k, v)), bias, use_flash=False))
    o, lse = flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)),
        torch.from_numpy(np.asarray(bias)[:, 0, 0, :]))
    np.testing.assert_allclose(o.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(o[0].numpy(),
                               np.broadcast_to(v[0].mean(0), (S, H, D)),
                               atol=1e-5)
    assert np.isfinite(lse.numpy()).all()
    pallas, _ = j_flash._fwd_flat(
        *(jnp.asarray(x.reshape(B, S, H * D)) for x in (q, k, v)),
        jnp.asarray(np.asarray(bias)[:, 0, 0, :]), D, 2, True)
    np.testing.assert_array_equal(np.asarray(pallas)[0], 0.0)


def test_flash_fwd_plain_sentinel_for_all_neg_inf_row():
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(4),
                                         1, 5, 1, 64))
    bias = torch.full((1, 5), float("-inf"))
    o, lse = flash_attention_fwd_plain(q, k, v, bias)
    assert torch.all(o == 0) and torch.all(lse == LSE_MASKED)


def test_flash_fwd_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 33, 2, 64))
    bias = torch.from_numpy(rng.standard_normal((2, 33)).astype(np.float32))
    before = kernels.LAUNCHES["flash_fwd"]
    o, lse = flash_attention_fwd(q, k, v, bias)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert kernels.LAUNCHES["flash_fwd"] == before


def test_attention_dispatch_stays_plain_off_cuda(monkeypatch):
    monkeypatch.delenv("MME_FLASH", raising=False)
    q = torch.zeros(1, 500, 2, 64)
    assert not attention._decide_flash(q, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax_numerics(dtype):
    rng = np.random.default_rng(6)
    # a large common offset is where the fast variance E[x²]−E[x]² matters
    x = (rng.standard_normal((4, 7, 48)) * 3 + 20).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = JLayerNorm(epsilon=1e-5, dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x).astype(jdt))
    ours = layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w), torch.from_numpy(b), 1e-5,
                      getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype)
    # fp32: the fast variance cancels E[x²] ≈ 409 against E[x]² ≈ 400, so
    # the summation order alone moves the result by a few 1e-5; bf16: one
    # ulp of the final cast
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-4 if dtype == "float32" else 2e-2,
                               rtol=1e-5 if dtype == "float32" else 1e-2)


def test_audio_lengths_and_feature_mask_with_pad_rows():
    """Padded serving rows have audio_mask all 0: the conv lengths go
    negative and floor division must give an all-zero feature mask."""
    lengths = np.array([96000, 50000, 401, 0], np.int32)
    ours = audio.conv_output_lengths(torch.from_numpy(lengths)).numpy()
    ref = np.asarray(j_audio.conv_output_lengths(jnp.asarray(lengths)))
    np.testing.assert_array_equal(ours, ref)
    assert ours[-1] < 0 and ours[0] == 299
    am = (np.arange(96000)[None, :] < lengths[:, None]).astype(np.int32)
    fm = audio.feature_vector_attention_mask(299, torch.from_numpy(am))
    np.testing.assert_array_equal(
        fm.numpy(), np.asarray(j_audio.feature_vector_attention_mask(
            299, jnp.asarray(am))))
    assert fm.dtype == torch.int32 and fm[-1].sum() == 0


def test_masked_mean_pool_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    m = np.array([[1, 1, 1, 0, 0, 0], [1] * 6, [0] * 6], np.int32)
    for mask in (m, None):
        ours = audio.masked_mean_pool(
            torch.from_numpy(x), None if mask is None else torch.from_numpy(
                mask)).numpy()
        ref = np.asarray(j_audio.masked_mean_pool(
            jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_video_tables_and_uniform_mask_match_jax():
    np.testing.assert_array_equal(video.sinusoid_position_table(1568, 768),
                                  j_video.sinusoid_position_table(1568, 768))
    np.testing.assert_array_equal(
        video.uniform_keep_mask(3, 1568, 104).numpy(),
        np.asarray(j_video.uniform_keep_mask(3, 1568, 104)))


def test_gather_visible_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 40, 6)).astype(np.float32)
    keep = np.zeros((3, 40), bool)
    for r in range(3):
        keep[r, rng.choice(40, 9, replace=False)] = True
    keep_none = keep.copy()
    keep_none[2] = False      # a zero-padded serving row keeps nothing
    for kp in (keep, keep_none):
        np.testing.assert_array_equal(
            video.gather_visible(torch.from_numpy(x), torch.from_numpy(kp),
                                 9).numpy(),
            np.asarray(j_video.gather_visible(jnp.asarray(x),
                                              jnp.asarray(kp), 9)))


def test_balanced_keep_mask_contract():
    g = torch.Generator().manual_seed(0)
    m = video.balanced_keep_mask(16, 1568, 104, generator=g)
    assert m.dtype == torch.bool and m.shape == (16, 1568)
    assert (m.sum(-1) == 104).all()
    again = video.balanced_keep_mask(16, 1568, 104,
                                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(m, again)
    assert not torch.equal(m[0], m[1])
