"""The fused bf16-moment Adam update of the port
(mme_tpu_torch/ops/adam_update.py) on the CPU: its Philox dither, its
multi-leaf plain version, the leaf table its kernel reads, and the
optimizer's grouped path under ``MME_FUSED_ADAM=interpret``.

Tolerances: the generator and the table exactly; the multi-leaf plain
version bit for bit against the one-leaf plain version fed the same words;
the optimizer's bf16-moment trajectory within 3e-2 of fp32 AdamW and its
loss within 2 % (``test_torch_optim.py`` holds the unfused path to the
same), and with the same seed to the same bits.
"""

import re

import numpy as np
import pytest
import torch

from mme_tpu_torch.ops import adam_update, kernels
from mme_tpu_torch.train import optim

torch.set_num_threads(2)

KW = dict(b1=0.9, b2=0.999, eps=1e-8)


def _philox_python(counter, key):
    """Philox4x32-10 on Python integers, from its definition."""
    m, w = (0xD2511F53, 0xCD9E8D57), (0x9E3779B9, 0xBB67AE85)
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + w[0]) & 0xFFFFFFFF, (k[1] + w[1]) & 0xFFFFFFFF]
        p0, p1 = m[0] * c[0], m[1] * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


# Random123's known-answer vectors for Philox4x32-10
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = adam_update.philox4x32_10_plain(torch.tensor(counter),
                                          torch.tensor(key))
    assert got.tolist() == list(want)
    assert _philox_python(counter, key) == list(want)


@pytest.mark.parametrize("n", [1, 5, 4097])
def test_dither_words_match_a_python_loop(n):
    """Word e % 4 of the block at counter (e // 4, 0, 0, 0), key (seed low,
    seed high), for a seed with both halves set."""
    seed = (0x1234_5678 << 32) | 0x9ABC_DEF0 | (n << 20)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    want = [_philox_python((e // 4, 0, 0, 0), key)[e % 4] for e in range(n)]
    got = adam_update.dither_words_plain(seed, n)
    assert got.dtype == torch.int64 and got.tolist() == want


def _leaves(seed=0):
    """Leaves of the sizes the model has (7 to 5 120 here) and odd ones,
    fp32 and bf16 gradients."""
    rng = np.random.default_rng(seed)
    shapes = [(1,), (7,), (768,), (17, 3), (5120,), (9, 455)]
    gs, mus, nus = [], [], []
    for k, shape in enumerate(shapes):
        g = torch.from_numpy((rng.standard_normal(shape) * 1e-3
                              ).astype(np.float32))
        gs.append(g.bfloat16() if k % 2 else g)
        mus.append(torch.from_numpy((rng.standard_normal(shape) * 1e-3
                                     ).astype(np.float32)).bfloat16())
        nus.append(torch.from_numpy((rng.random(shape) * 1e-6
                                     ).astype(np.float32)).bfloat16())
    seeds = [int(s) for s in rng.integers(0, 1 << 62, len(shapes))]
    return gs, mus, nus, seeds


@pytest.mark.parametrize("aliased", [False, True], ids=["fresh", "aliased"])
def test_leaves_plain_equals_one_leaf_plain_on_the_same_words(aliased):
    gs, mus, nus, seeds = _leaves()
    want = [adam_update.adam_update_leaf_plain(
        g, mu, nu, 0.271, 0.003,
        noise=adam_update.dither_words_plain(s, g.numel()).view(g.shape),
        **KW) for g, mu, nu, s in zip(gs, mus, nus, seeds)]
    if aliased:
        gs2, mus2, nus2 = ([x.clone() for x in xs] for xs in (gs, mus, nus))
        ptrs = [x.data_ptr() for x in gs2 + mus2 + nus2]
        got = adam_update.adam_update_leaves_plain(
            gs2, mus2, nus2, 0.271, 0.003, seeds, outs=gs2, mu_outs=mus2,
            nu_outs=nus2, **KW)
        assert [x.data_ptr() for xs in got for x in xs] == ptrs
    else:
        got = adam_update.adam_update_leaves_plain(gs, mus, nus, 0.271,
                                                   0.003, seeds, **KW)
    for k, w in enumerate(want):
        for ours, theirs in zip((got[0][k], got[1][k], got[2][k]), w):
            assert ours.dtype == theirs.dtype
            assert torch.equal(ours, theirs)
    # the dither is on: some moment was rounded up, not truncated
    m32 = 0.9 * mus[2].float() + (1.0 - 0.9) * gs[2].float()
    assert not torch.equal(got[1][2], m32.bfloat16())


def test_leaves_on_the_cpu_take_the_plain_version():
    gs, mus, nus, seeds = _leaves(1)
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    got = adam_update.adam_update_leaves(gs, mus, nus, 0.5, 0.25, seeds,
                                         **KW)
    want = adam_update.adam_update_leaves_plain(gs, mus, nus, 0.5, 0.25,
                                                seeds, **KW)
    assert (kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
            ) == before
    for ours, theirs in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    with pytest.raises(ValueError):
        adam_update.adam_update_leaves([], [], [], 0.5, 0.25, [], **KW)


def test_kernel_constants_match_the_source():
    """CHUNK and the record size are fixed in the CUDA source too."""
    with open(f"{kernels.CSRC_DIR}/adam_update.cu") as fh:
        src = fh.read()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == \
        adam_update.CHUNK
    assert f"sizeof(Leaf) == {8 * adam_update.RECORD_WORDS}" in src
    assert "mme_adam_update" in src


def test_entry_argument_types_match_the_source():
    """The ctypes argument list is the C entry point's, type by type: a
    pointer where the source takes one, and no host table pointer left."""
    import ctypes
    with open(f"{kernels.CSRC_DIR}/adam_update.cu") as fh:
        src = fh.read()
    params = re.search(r'extern "C" int mme_adam_update\(([^)]*)\)',
                       src).group(1)
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int": ctypes.c_int, "long long": ctypes.c_longlong,
               "float": ctypes.c_float}
    got = [c_types[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert got == adam_update._ARGTYPES


def test_plain_needs_words_unless_zero_noise():
    g = torch.ones(5)
    mu = nu = torch.zeros(5, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        adam_update.adam_update_leaf_plain(g, mu, nu, 0.5, 0.5, **KW)
    out, mu2, _ = adam_update.adam_update_leaf_plain(g, mu, nu, 0.5, 0.5,
                                                     zero_noise=True, **KW)
    assert out.dtype == torch.float32 and mu2.dtype == torch.bfloat16


def test_one_leaf_form_is_the_leaf_list_of_one():
    """adam_update_leaf draws the words of its seed on every device: on the
    CPU it equals the plain version fed dither_words_plain of that seed."""
    gs, mus, nus, seeds = _leaves(8)
    got = adam_update.adam_update_leaf(gs[4], mus[4], nus[4], 0.271, 0.003,
                                       seeds[4], **KW)
    want = adam_update.adam_update_leaf_plain(
        gs[4], mus[4], nus[4], 0.271, 0.003,
        noise=adam_update.dither_words_plain(seeds[4], gs[4].numel()
                                             ).view(gs[4].shape), **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_leaf_table_layout():
    """Eight words per leaf (six pointers, the seed, n with g's type in bit
    32), then every leaf's first chunk; outputs that are their inputs reuse
    their pointers."""
    gs, mus, nus, seeds = _leaves(2)
    gs[3] = torch.zeros(adam_update.CHUNK + 1)          # two chunks
    mus[3] = torch.zeros(adam_update.CHUNK + 1, dtype=torch.bfloat16)
    nus[3] = torch.zeros(adam_update.CHUNK + 1, dtype=torch.bfloat16)
    words, chunks = adam_update._table(gs, mus, nus, gs, mus, nus, seeds, -1)
    n = len(gs)
    assert len(words) == n * (adam_update.RECORD_WORDS + 1)
    assert chunks == 8                  # 5 120 elements take two chunks too
    for k in range(n):
        rec = words[8 * k:8 * k + 8]
        ptr = [gs[k].data_ptr(), mus[k].data_ptr(), nus[k].data_ptr()]
        assert list(rec[:6]) == ptr + ptr
        assert rec[6] == seeds[k]
        assert rec[7] == gs[k].numel() | (gs[k].dtype == torch.bfloat16) << 32
    assert list(words[8 * n:]) == [0, 1, 2, 3, 5, 7]


def test_leaf_table_refuses_what_the_kernel_does_not_take():
    gs, mus, nus, seeds = _leaves(3)

    def table(**change):
        args = dict(gs=list(gs), mus=list(mus), nus=list(nus), seeds=seeds)
        for name, (k, x) in change.items():
            if name == "seeds":
                args["seeds"] = list(seeds)
                args["seeds"][k] = x
            else:
                args[name][k] = x
        adam_update._table(args["gs"], args["mus"], args["nus"], args["gs"],
                           args["mus"], args["nus"], args["seeds"], -1)

    table()
    with pytest.raises(TypeError):
        table(gs=(0, gs[0].half()))
    for bad in (dict(mus=(2, mus[2].float())),            # fp32 moment
                dict(nus=(5, nus[5].reshape(455, 9))),     # other shape
                dict(mus=(5, torch.zeros(455, 9, dtype=torch.bfloat16).t())),
                dict(gs=(1, torch.zeros(0, dtype=torch.bfloat16)),
                     mus=(1, torch.zeros(0, dtype=torch.bfloat16)),
                     nus=(1, torch.zeros(0, dtype=torch.bfloat16))),
                dict(seeds=(0, -1)), dict(seeds=(0, 1 << 63))):
        with pytest.raises(ValueError):
            table(**bad)
    # a separate output of the wrong type is refused too
    with pytest.raises(ValueError):
        adam_update._table(gs, mus, nus, [g.double() for g in gs], mus, nus,
                           seeds, -1)


def test_bounds_count_each_byte_once():
    sizes = [7, 768, 5120]
    flops, nbytes, ms, by = adam_update.bounds(sizes)
    assert (flops, nbytes, by) == (12 * 5895, 16 * 5895, "bytes")
    assert adam_update.bounds(sizes, g_bytes=2)[1] == 12 * 5895
    assert ms == pytest.approx(16 * 5895 / 3.35e12 * 1e3)


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = [(64,), (7,), (16, 12), (12, 16)]
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]
    # the last parameter is a transposed view, and so is its gradient (as
    # autograd lays it out): the kernel does not take it
    params[3] = params[3].t()
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes] for _ in range(4)]
    for g in grads:
        g[3] = g[3].t()
    return params, grads


def test_interpreted_fused_optimizer_updates_moments_in_place(monkeypatch):
    """Every contiguous leaf goes through one call of the grouped update:
    its moments keep their storage, and the same seed gives the same bits;
    the transposed leaf takes the unfused update and new moments."""
    monkeypatch.setenv("MME_FUSED_ADAM", "interpret")
    runs = []
    for _ in range(2):
        params, grads = _params_and_grads(4)
        tx = optim.adamw_lowmem(lambda s: 1e-2, 1e-4, 1.0)
        gen = torch.Generator().manual_seed(1)
        state = tx.init(params, gen)
        ptrs = [m.data_ptr() for m in state.mu[:3] + state.nu[:3]]
        calls = []
        real = adam_update.adam_update_leaves
        monkeypatch.setattr(adam_update, "adam_update_leaves",
                            lambda gs, *a, **k: calls.append(len(gs))
                            or real(gs, *a, **k))
        for g in grads:
            tx.update(params, g, state, gen)
        monkeypatch.setattr(adam_update, "adam_update_leaves", real)
        assert calls == [3] * len(grads)
        assert [m.data_ptr() for m in state.mu[:3] + state.nu[:3]] == ptrs
        assert all(m.dtype == torch.bfloat16 for m in state.mu + state.nu)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for a, b in zip(p1 + s1.mu + s1.nu, p2 + s2.mu + s2.nu):
        assert torch.equal(a, b)
    # and a moment is not its truncation: the dither is on
    assert s1.count == 4 and s1.mu[0].abs().sum() > 0


def _quadratic_run(tx, steps=200):
    target = torch.from_numpy(np.random.RandomState(0).randn(64).astype(
        np.float32))
    p = [torch.zeros(64)]
    gen = torch.Generator().manual_seed(1)
    state = tx.init(p, gen)
    for _ in range(steps):
        tx.update(p, [2 * (p[0] - target)], state, gen)
    return p[0], float(((p[0] - target) ** 2).sum())


def test_interpreted_fused_trajectory_tracks_fp32_adamw(monkeypatch):
    """200 steps on a quadratic (clip out of the way) through the grouped
    update with Philox dither: the parameters stay within 3e-2 of fp32
    AdamW's and the loss within 2 %."""
    p_ref, l_ref = _quadratic_run(optim.adamw(lambda s: 1e-2, 1e-4, 1e9))
    monkeypatch.setenv("MME_FUSED_ADAM", "interpret")
    p_low, l_low = _quadratic_run(optim.adamw_lowmem(lambda s: 1e-2, 1e-4,
                                                     1e9))
    np.testing.assert_allclose(p_low.numpy(), p_ref.numpy(), atol=3e-2)
    assert abs(l_low - l_ref) / max(l_ref, 1e-9) < 0.02
