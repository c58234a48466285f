"""The port's ring attention (mme_tpu_torch/ops/ring_attention.py) and the
sequence-parallel encoder (``EncoderSpec.seq_mesh``) against
mme_tpu/ops/ring_attention.py and JAX's sp encoder, on the same
numpy-seeded inputs and flax weights.

The port's side runs in one pool of four CPU ranks joined by gloo
(``parallel/launch.py::RankPool``, module fixture), reused by every check:
2 shards are a ("dp", "sp") = (2, 2) mesh whose two sp rings compute the
same thing (both are checked), 4 shards a (1, 4) mesh. JAX's side runs on
the virtual 8-device CPU mesh of tests/conftest.py, its flash path with
the Pallas kernels in interpret mode. The rank-side functions below import
no JAX: the workers import this file by path.

The hop arithmetic (the log-sum-exp merge, the backward's one global
pre-pass against a pre-pass per block) needs no ranks and runs here.

Tolerances are those of tests/test_ring_attention.py: outputs 2e-5,
dense gradients 5e-5, flash gradients 5e-4, the encoder's gradients
2e-4 relative plus 2e-5.
"""

import os

import numpy as np
import pytest
import torch

from mme_tpu_torch.ops import flash_attention as fa
from mme_tpu_torch.ops.attention import dot_product_attention_shd
from mme_tpu_torch.ops.ring_attention import finish_merge, merge_block
from mme_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
B, S, H, D = 2, 64, 2, 64
MASK_BIAS = -0.7 * float(np.finfo(np.float32).max)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
DENSE_GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
FLASH_GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


# ---------------- rank side (the pool's workers; no JAX) ----------------

_MESHES = {}


def _mesh(n):
    from mme_tpu_torch.parallel.mesh import make_mesh
    if n not in _MESHES:
        _MESHES[n] = make_mesh(4 // n, n, axis_names=("dp", "sp"))
    return _MESHES[n]


def _block(a, index, n):
    L = a.shape[1] // n
    return a[:, index * L:(index + 1) * L]


def rank_ring(n, q, k, v, key_mask, key_bias, w, use_flash):
    """This rank's block through ``ring_attention`` and the backward of
    sum(out · w): (dp, sp, out, dq, dk, dv) of its block."""
    from mme_tpu_torch.ops.ring_attention import ring_attention
    torch.set_num_threads(1)
    mesh = _mesh(n)
    i = mesh.coords["sp"]
    ql, kl, vl = (torch.from_numpy(_block(a, i, n)).requires_grad_()
                  for a in (q, k, v))
    out = ring_attention(
        ql, kl, vl, mesh, "sp",
        key_mask=None if key_mask is None else torch.from_numpy(
            _block(key_mask, i, n)),
        key_bias=None if key_bias is None else torch.from_numpy(
            _block(key_bias, i, n)),
        use_flash=use_flash)
    (out * torch.from_numpy(_block(w, i, n))).sum().backward()
    return (mesh.coords["dp"], i, out.detach().numpy(), ql.grad.numpy(),
            kl.grad.numpy(), vl.grad.numpy())


def rank_encoder(n, spec_kw, params, x, keep, proj, flash):
    """The port's TransformerEncoder with ``seq_mesh`` over sp = n: its
    output, dL/dx and the parameter gradients (flax layout) of
    L = sum(out · proj), and the transport the ring took."""
    import dataclasses

    from mme_tpu_torch.convert import from_flax, grads_to_flax
    from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
    from mme_tpu_torch.ops.attention import additive_mask
    torch.set_num_threads(1)
    mesh = _mesh(n)
    spec = dataclasses.replace(EncoderSpec(**spec_kw), seq_mesh=mesh,
                               seq_axis="sp")
    enc = TransformerEncoder(spec, device="cpu").eval()
    enc.load_state_dict(from_flax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    old = os.environ.get("MME_RING_FLASH")
    os.environ["MME_RING_FLASH"] = "1" if flash else "0"
    try:
        out = enc(xt, additive_mask(torch.from_numpy(keep)))
        (out * torch.from_numpy(proj)).sum().backward()
    finally:
        if old is None:
            os.environ.pop("MME_RING_FLASH")
        else:
            os.environ["MME_RING_FLASH"] = old
    return (out.detach().numpy(), xt.grad.numpy(), grads_to_flax(enc),
            mesh.axis("sp").transport(xt))


# ------------------------------ parent side ------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(4, timeout_s=240) as p:
        yield p


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, S, H, D).astype(np.float32)
                  for _ in range(4))
    return rng, q, k, v, w


def _masks(case, rng):
    """(key_mask, key_bias) of a case, [B, S]."""
    if case == "none":
        return None, None
    if case == "key_mask":
        m = rng.rand(B, S) > 0.3
        m[:, ::8] = True
        return m.astype(np.int32), None
    if case == "soft_bias":
        return None, (rng.randn(B, S) * 2.0).astype(np.float32)
    if case == "masked_block":      # shard 1 of 4 (half of shard 0 of 2)
        m = np.ones((B, S), np.int32)
        m[0, 16:32] = 0
        return m, None
    if case == "masked_row":        # batch row 1 sees no key at all
        m = np.ones((B, S), np.int32)
        m[1] = 0
        m[0, 40:] = 0
        return m, None
    raise ValueError(case)


_JAX_RINGS = {}


def _jax_ring(n, q, k, v, key_mask, key_bias, w, use_flash):
    """JAX's ring_attention over n devices: out, dq, dk, dv ([B, S, H, D])
    of sum(out · w). A key mask goes in as the -1e30 bias JAX's ring makes
    of it, so one jitted program per (n, path) serves every case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mme_tpu.ops.ring_attention import NEG_INF, ring_attention

    if (n, use_flash) not in _JAX_RINGS:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))

        def f(q_, k_, v_, kb, w_):
            out = ring_attention(q_, k_, v_, mesh, key_bias=kb,
                                 use_flash=use_flash, interpret=use_flash)
            return jnp.sum(out * w_), out

        _JAX_RINGS[n, use_flash] = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))
    if key_bias is None:
        key_bias = (np.zeros((B, S), np.float32) if key_mask is None else
                    np.where(key_mask > 0, 0.0, NEG_INF).astype(np.float32))
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    (_, out), grads = _JAX_RINGS[n, use_flash](t(q), t(k), t(v),
                                               jnp.asarray(key_bias), t(w))
    back = lambda a: np.asarray(a).transpose(0, 2, 1, 3)
    return (back(out),) + tuple(back(g) for g in grads)


def _assemble(results, n):
    """Every ring line's blocks put back in sequence order: a list (one per
    dp line) of (out, dq, dk, dv)."""
    lines = {}
    for dp, sp, *arrs in results:
        lines.setdefault(dp, {})[sp] = arrs
    return [tuple(np.concatenate([blocks[i][j] for i in range(n)], axis=1)
                  for j in range(4)) for _, blocks in sorted(lines.items())]


def _check(got_lines, want, grad_tol, what):
    for got in got_lines:
        np.testing.assert_allclose(got[0], want[0], err_msg=f"{what}: out",
                                   **OUT_TOL)
        for g, w_, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, w_, err_msg=f"{what}: {name}",
                                       **grad_tol)


def _single_device(q, k, v, bias, w):
    """The port's single-device non-flash attention with a per-key bias:
    out, dq, dk, dv of sum(out · w)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = dot_product_attention_shd(
        qt, kt, vt, torch.from_numpy(bias)[:, None, None, :],
        use_flash=False)
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
            vt.grad.numpy())


CASES = {"dense": [(2, "none"), (4, "none"), (2, "key_mask"),
                   (4, "key_mask"), (4, "soft_bias"), (4, "masked_block"),
                   (2, "masked_row"), (4, "masked_row")],
         "flash": [(2, "key_mask"), (4, "key_mask"), (4, "soft_bias"),
                   (4, "masked_block"), (2, "masked_row"),
                   (4, "masked_row")]}


@pytest.mark.parametrize("path", ["dense", "flash"])
def test_ring_matches_jax(pool, path):
    """Forward and dq/dk/dv of the port's ring against JAX's, at 2 and 4
    shards: no mask, a key mask, a soft key bias, a fully masked local
    block and a fully masked query row (batch row 1 sees no key). The
    flash path runs the Pallas kernels in interpret mode in JAX and K1/K2's
    plain versions here; for the masked row its reference is JAX's dense
    ring, the uniform mean of v, which is also the port's single-device
    contract (checked as well)."""
    flash = path == "flash"
    tol = FLASH_GRAD_TOL if flash else DENSE_GRAD_TOL
    for n, case in CASES[path]:
        rng, q, k, v, w = _inputs(seed=21 + n)
        key_mask, key_bias = _masks(case, rng)
        got = _assemble(pool.run(f"{HERE}:rank_ring", n, q, k, v, key_mask,
                                 key_bias, w, flash), n)
        want = _jax_ring(n, q, k, v, key_mask, key_bias, w,
                         flash and case != "masked_row")
        _check(got, want, tol, f"{path} {n} {case}")
        if case == "masked_row":
            bias = np.where(key_mask > 0, 0.0, -1e30).astype(np.float32)
            _check(got, _single_device(q, k, v, bias, w), tol,
                   f"{path} {n} single device")
            np.testing.assert_allclose(got[0][0][1], np.broadcast_to(
                v[1].mean(axis=0), v[1].shape), **OUT_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_flash_ring_masked_row_under_the_model_mask(pool, n):
    """The flash ring holds a fully masked row also under the model's
    -0.7·f32max mask bias: the port's single-device contract (the mean of
    v and its gradients). JAX's dense ring gives 0 there (its running max
    starts at -1e30); the port's dense ring follows JAX's."""
    rng, q, k, v, w = _inputs(seed=31 + n)
    key_mask, _ = _masks("masked_row", rng)
    mbias = np.where(key_mask > 0, 0.0, MASK_BIAS).astype(np.float32)
    got = _assemble(pool.run(f"{HERE}:rank_ring", n, q, k, v, None, mbias,
                             w, True), n)
    _check(got, _single_device(q, k, v, mbias, w), FLASH_GRAD_TOL,
           "flash, model mask")
    dense = _assemble(pool.run(f"{HERE}:rank_ring", n, q, k, v, None, mbias,
                               w, False), n)
    np.testing.assert_array_equal(dense[0][0][1], 0.0)


def _blocks(a, n):
    L = a.shape[1] // n
    return [a[:, i * L:(i + 1) * L] for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_merge_of_k1_blocks_is_the_whole_sequence(n):
    """K1 (plain) per key block, merged by ``merge_block``: the whole
    sequence's O and LSE, with a block whose every key is -inf (K1's
    sentinel LSE, mapped to -inf by the merge) and a row masked by the
    finite -0.7·f32max bias."""
    rng, q, k, v, _ = _inputs(seed=41)
    bias = np.zeros((B, S), np.float32)
    bias[0, :S // n] = -np.inf                     # block 0 of row 0
    bias[1] = MASK_BIAS                            # row 1: every key
    qt, kt, vt, bt = (torch.from_numpy(a) for a in (q, k, v, bias))
    m = torch.full((B, H, S), float("-inf"))
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, S, H, D))
    for kb, vb, bb in zip(_blocks(kt, n), _blocks(vt, n), _blocks(bt, n)):
        o_i, lse_i = fa.flash_attention_fwd_plain(qt, kb, vb, bb)
        m, l, acc = merge_block(m, l, acc, o_i, lse_i)
    out, lse = finish_merge(m, l, acc, qt.dtype)
    want_out, want_lse = fa.flash_attention_fwd_plain(qt, kt, vt, bt)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_per_block_correction_fails_fully_masked_row(n):
    """K2 per k/v block with the global O and LSE. With the pre-pass run
    once on the whole key-bias row (what the ring does), the summed
    gradients are the whole sequence's; with each block's own pre-pass
    (``flash_attention_bwd``'s default) the fully masked row's log n is
    that of one block, and its dV comes out n times too large."""
    rng, q, k, v, w = _inputs(seed=51)
    bias = np.zeros((B, S), np.float32)
    bias[1] = MASK_BIAS
    qt, kt, vt, bt, do = (torch.from_numpy(a) for a in (q, k, v, bias, w))
    out, lse = fa.flash_attention_fwd_plain(qt, kt, vt, bt)
    want = fa.flash_attention_bwd_plain(qt, kt, vt, bt, out, lse, do)
    rows = fa.flash_bwd_prepass(out, do, lse, bt)
    for once in (True, False):
        dq = torch.zeros_like(qt)
        dks, dvs = [], []
        for kb, vb, bb in zip(_blocks(kt, n), _blocks(vt, n),
                              _blocks(bt, n)):
            g = fa.flash_attention_bwd(qt, kb, vb, bb, out, lse, do,
                                       rows if once else None)
            dq += g[0]
            dks.append(g[1])
            dvs.append(g[2])
        dk, dv = torch.cat(dks, 1), torch.cat(dvs, 1)
        if once:
            for a, b_, name in ((dq, want[0], "dq"), (dk, want[1], "dk"),
                                (dv, want[2], "dv")):
                np.testing.assert_allclose(a.numpy(), b_.numpy(),
                                           err_msg=name, **DENSE_GRAD_TOL)
        else:
            # row 0 is untouched; row 1's dV is n times the true one
            np.testing.assert_allclose(dv[0].numpy(), want[2][0].numpy(),
                                       **DENSE_GRAD_TOL)
            np.testing.assert_allclose(dv[1].numpy(),
                                       n * want[2][1].numpy(), rtol=1e-4,
                                       atol=1e-4)
            assert not np.allclose(dv[1].numpy(), want[2][1].numpy(),
                                   rtol=0.1, atol=0.1)


ENC = dict(hidden=128, heads=2, layers=2, intermediate=64, ln_style="pre",
           ln_eps=1e-6)


@pytest.fixture(scope="module")
def jax_encoder():
    """JAX's encoder at ENC with seq_mesh over 4 devices: the parameters,
    input, keep-mask, projection, and the output and gradients of
    sum(out · proj) (30 tokens: the ring pads them)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mme_tpu.models.layers import EncoderSpec, TransformerEncoder
    from mme_tpu.ops.attention import additive_mask

    rng = np.random.RandomState(12)
    x = rng.randn(2, 30, ENC["hidden"]).astype(np.float32)
    keep = np.ones((2, 30), np.int32)
    keep[:, -5:] = 0
    proj = rng.randn(2, 30, ENC["hidden"]).astype(np.float32)
    spec = EncoderSpec(**ENC)
    params = jax.jit(TransformerEncoder(spec).init)(
        jax.random.PRNGKey(0), jnp.asarray(x),
        additive_mask(jnp.asarray(keep)))["params"]
    enc = TransformerEncoder(dataclasses.replace(
        spec, seq_mesh=Mesh(np.asarray(jax.devices()[:4]), ("sp",)),
        seq_axis="sp"))

    def loss(p, x_):
        y = enc.apply({"params": p}, x_, additive_mask(jnp.asarray(keep)))
        return jnp.sum(y * jnp.asarray(proj)), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (jax.tree.map(np.asarray, params), x, keep, proj,
            (np.asarray(y), np.asarray(gx), jax.tree.map(np.asarray, gp)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("flash", [False, True])
def test_sp_encoder_matches_jax(pool, jax_encoder, flash):
    """The port's sp encoder at 2 and 4 shards (30 tokens padded to a
    multiple of sp, a per-key mask, the dense or the flash ring) against
    JAX's sp encoder: output, dL/dx and every parameter gradient on every
    rank, so no gradient comes out sp times too large."""
    params, x, keep, proj, ref = jax_encoder
    results = (pool.run(f"{HERE}:rank_encoder", 2, ENC, params, x, keep,
                        proj, flash)
               + pool.run(f"{HERE}:rank_encoder", 4, ENC, params, x, keep,
                          proj, flash))
    leaves = dict(_flat(ref[2]))
    for out, gx, grads, transport in results:
        assert transport == "gloo"
        np.testing.assert_allclose(out, ref[0], rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(gx, ref[1], rtol=2e-4, atol=2e-5)
        got = dict(_flat(grads))
        assert got.keys() == leaves.keys()
        for path, b in leaves.items():
            np.testing.assert_allclose(got[path], b, rtol=2e-4, atol=2e-5,
                                       err_msg=str(path))
