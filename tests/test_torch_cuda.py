"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test here skips (the fixture
decides, so every pytest worker collects the same tests). On a machine with
a card: ``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.

Tolerances (elementwise |O - O_plain| <= atol + rtol |O_plain|): fp32 sums
fp32 products in another order, a few fp32 ulps; bf16 rounds the
unnormalised probabilities (the plain version the normalised ones) and O
itself to bf16, a bf16 ulp or two. LSE is fp32 on both sides. The backward's
gradients are sums of up to Sq or Sk such terms and are held relative to
each tensor's largest element: 1e-5 in fp32, 2e-2 in bf16 (P and dS are
rounded to bf16 on both sides, at slightly different fp32 values, and the
result is rounded to bf16 once more).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import additive_mask, dot_product_attention_shd
from mme_tpu_torch.ops import adam_update
from mme_tpu_torch.ops.adam_update import (adam_update_leaf,
                                           adam_update_leaf_plain,
                                           adam_update_leaves,
                                           adam_update_leaves_plain)
from mme_tpu_torch.ops.flash_attention import (FlashAttention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain,
                                               flash_bwd_prepass,
                                               flash_bwd_prepass_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # of max |gradient|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, Sq, Sk, H, D, dtype, lengths, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kv = torch.randn(B, Sk, 3, H, D, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, Sq, 3, H, D, generator=g, device="cuda").to(dtype)
    keep = (torch.arange(Sk, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])
    return q[:, :, 0], kv[:, :, 1], kv[:, :, 2], additive_mask(keep)[:, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk,lengths", [
    (64, 64, [64, 1]),            # one exact tile
    (70, 70, [70, 0]),            # ragged tiles, a fully masked row
    (130, 333, [333, 200]),       # Sq != Sk, several key tiles
    (5, 1, [1, 1]),               # a single key
])
@pytest.mark.parametrize("with_bias", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, D, Sq, Sk, lengths,
                                    with_bias):
    q, k, v, bias = _inputs(2, Sq, Sk, 3, D, dtype, lengths)
    bias = bias if with_bias else None
    before = kernels.LAUNCHES["flash_fwd"]
    o, lse = flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
    atol, rtol = TOL[dtype]
    assert o.dtype == dtype and o.shape == (2, Sq, 3, D)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, bias = _inputs(1, 8, 8, 2, 64, torch.bfloat16, [8])
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):          # head_dim 32
        flash_attention_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):          # last stride != 1
        flash_attention_fwd(q.transpose(2, 3), k.transpose(2, 3),
                            v.transpose(2, 3))
    with pytest.raises(ValueError):          # bias not fp32 [B, Sk]
        flash_attention_fwd(q, k, v, bias.to(torch.bfloat16))
    with pytest.raises(ValueError):          # q on the CPU, k on the card
        flash_attention_fwd(q, k.cpu(), v)


def test_dispatcher_takes_kernel_unless_disabled(cuda, monkeypatch):
    q, k, v, bias = _inputs(2, 40, 40, 2, 64, torch.bfloat16, [40, 9])
    bias4 = bias[:, None, None, :]
    monkeypatch.delenv("MME_FLASH", raising=False)
    before = kernels.LAUNCHES["flash_fwd"]
    out = dot_product_attention_shd(q, k, v, bias4)
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    monkeypatch.setenv("MME_FLASH", "0")
    ref = dot_product_attention_shd(q, k, v, bias4)
    assert kernels.LAUNCHES["flash_fwd"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=1e-2)


def test_encoder_on_cuda_matches_cpu(cuda):
    """A head_dim-64 encoder through the kernel on the card against the same
    weights on the CPU (plain attention)."""
    spec = EncoderSpec(hidden=128, heads=2, layers=2, intermediate=256,
                       ln_style="pre", qkv_bias="qv", final_ln=True)
    cpu = TransformerEncoder(spec, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    gpu = TransformerEncoder(spec, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 77, 128, generator=g)
    bias = additive_mask(torch.arange(77)[None, :]
                         < torch.tensor([77, 30, 0])[:, None])
    before = kernels.LAUNCHES["flash_fwd"]
    with torch.inference_mode():
        want = cpu(x, bias)
        got = gpu(x.to(cuda), bias.to(cuda)).cpu()
    assert kernels.LAUNCHES["flash_fwd"] == before + 2
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _assert_grads_close(got, want, dtype):
    # a gradient that is zero but for cancellation (dq with a single key:
    # dP = delta) is held to a twentieth of the largest gradient's scale
    floor = 0.05 * max(b.float().abs().max().item() for b in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(b.abs().max().item(), floor), (
            name, err, b.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk,lengths", [
    (64, 64, [64, 1]),            # one exact tile
    (70, 70, [70, 0]),            # ragged tiles, a row masked by bias
    (130, 333, [333, 200]),       # Sq != Sk, several tiles on both axes
    (5, 1, [1, 1]),               # a single key
])
@pytest.mark.parametrize("with_bias", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, D, Sq, Sk, lengths,
                                        with_bias):
    q, k, v, bias = _inputs(2, Sq, Sk, 3, D, dtype, lengths)
    bias = bias if with_bias else None
    g = torch.Generator(device="cuda").manual_seed(7)
    do = torch.randn(2, Sq, 3, D, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention_fwd_plain(q, k, v, bias)
    before = kernels.LAUNCHES["flash_bwd"]
    got = flash_attention_bwd(q, k, v, bias, out, lse, do)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, bias, out, lse, do)
    _assert_grads_close(got, want, dtype)
    if with_bias and 0 in lengths:
        # the row masked by bias keeps the uniform P: its dV is not zero
        assert got[2][1].abs().max() > 0


def test_flash_bwd_sentinel_row_gets_no_gradient(cuda):
    q, k, v, _ = _inputs(2, 40, 40, 2, 64, torch.float32, [40, 40])
    bias = torch.zeros(2, 40, device="cuda")
    bias[1] = float("-inf")
    do = torch.randn(2, 40, 2, 64, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, bias)
    assert torch.all(lse[1] == 1e30)
    dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, do)
    for x in (dq, dk, dv):
        assert torch.all(x[1] == 0) and torch.isfinite(x).all()
    _assert_grads_close((dq, dk, dv), flash_attention_bwd_plain(
        q, k, v, bias, out, lse, do), torch.float32)


def test_flash_autograd_matches_non_flash_path(cuda, monkeypatch):
    """FlashAttention under autograd (both kernels) against autograd
    through the plain attention path, fp32, with a row masked by bias and a
    non-contiguous output gradient."""
    q, k, v, bias = _inputs(2, 77, 77, 2, 64, torch.float32, [77, 0])
    w = torch.randn(2, 77, 64, 2, device="cuda")

    def grads(use_flash):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = dot_product_attention_shd(*leaves, bias[:, None, None, :],
                                        use_flash=use_flash)
        # the permute hands backward a dO whose last stride is not 1
        (out.permute(0, 1, 3, 2) * w).sum().backward()
        return [x.grad for x in leaves]

    fwd, bwd = kernels.LAUNCHES["flash_fwd"], kernels.LAUNCHES["flash_bwd"]
    got = grads(True)
    assert kernels.LAUNCHES["flash_fwd"] == fwd + 1
    assert kernels.LAUNCHES["flash_bwd"] == bwd + 1
    _assert_grads_close(got, grads(False), torch.float32)
    assert kernels.LAUNCHES["flash_bwd"] == bwd + 1
    leaf = q.detach().clone().requires_grad_()
    FlashAttention.apply(leaf, k, v, None).sum().backward()   # expanded dO
    assert torch.isfinite(leaf.grad).all()


def _check_fwd_bwd(q, k, v, bias, do, dtype):
    """Both kernels against their plain versions on the same inputs; the
    backward from the kernel's own O and LSE. Returns the kernels' results."""
    o, lse = flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, bias)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    got = flash_attention_bwd(q, k, v, bias, o, lse, do)
    torch.cuda.synchronize()
    _assert_grads_close(got, flash_attention_bwd_plain(q, k, v, bias, o, lse,
                                                       do), dtype)
    return o, lse, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(1, 473), (127, 129), (128, 299),
                                   (129, 1), (299, 128), (473, 127)])
def test_flash_kernels_at_tile_edges(cuda, dtype, D, Sq, Sk):
    """Lengths on both sides of the 64- and 128-row tiles, Sq != Sk, a
    ragged key mask in one batch row."""
    q, k, v, bias = _inputs(2, Sq, Sk, 3, D, dtype, [Sk, max(1, Sk // 3)],
                            seed=Sq + Sk)
    g = torch.Generator(device="cuda").manual_seed(11)
    do = torch.randn(2, Sq, 3, D, generator=g, device="cuda").to(dtype)
    _check_fwd_bwd(q, k, v, bias, do, dtype)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_row_masked_by_bias(cuda, D):
    """A bf16 row whose every key carries the -0.7 f32max mask bias: the
    softmax must subtract the row maximum before its scale by log2(e), or
    the bias overflows to -inf and the row turns into a sentinel row. The
    non-flash contract: O is the mean of v, the LSE is finite, dV is not
    zero."""
    q, k, v, bias = _inputs(2, 150, 150, 3, D, torch.bfloat16, [150, 0])
    g = torch.Generator(device="cuda").manual_seed(12)
    do = torch.randn(2, 150, 3, D, generator=g, device="cuda").to(
        torch.bfloat16)
    o, lse, (dq, dk, dv) = _check_fwd_bwd(q, k, v, bias, do, torch.bfloat16)
    mean_v = v[1].float().mean(dim=0)                         # [H, D]
    torch.testing.assert_close(o[1].float(),
                               mean_v.expand_as(o[1]).contiguous(),
                               atol=2e-2, rtol=1e-2)
    assert torch.isfinite(lse[1]).all() and (lse[1] < -1e30).all()
    assert dv[1].abs().max() > 0


def test_flash_bwd_bf16_two_runs_bit_equal(cuda):
    q, k, v, bias = _inputs(2, 300, 300, 4, 64, torch.bfloat16, [300, 123])
    do = torch.randn(2, 300, 4, 64, device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, bias)
    first = flash_attention_bwd(q, k, v, bias, out, lse, do)
    second = flash_attention_bwd(q, k, v, bias, out, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bwd_non_contiguous_do(cuda, dtype):
    """dO as a strided view (read in place) and with a last stride that is
    not 1 (copied once), against the plain version on a contiguous dO."""
    q, k, v, bias = _inputs(2, 90, 90, 2, 64, dtype, [90, 33])
    out, lse = flash_attention_fwd(q, k, v, bias)
    g = torch.Generator(device="cuda").manual_seed(13)
    wide = torch.randn(2, 90, 2, 2, 64, generator=g, device="cuda").to(dtype)
    transposed = torch.randn(2, 90, 64, 2, generator=g, device="cuda").to(
        dtype).transpose(2, 3)
    for do in (wide[:, :, 1], transposed):
        assert not do.is_contiguous()
        got = flash_attention_bwd(q, k, v, bias, out, lse, do)
        _assert_grads_close(got, flash_attention_bwd_plain(
            q, k, v, bias, out, lse, do.contiguous()), dtype)


@pytest.mark.parametrize("B,H,S", [(1, 1, 200), (2, 12, 1464)],
                         ids=["2_blocks", "288_blocks"])
def test_flash_grids_under_and_over_one_wave(cuda, B, H, S):
    """Grids far below and above the card's 132 SMs, bf16."""
    q, k, v, bias = _inputs(B, S, S, H, 64, torch.bfloat16,
                            [S, S // 2][:B])
    do = torch.randn(B, S, H, 64, device="cuda").to(torch.bfloat16)
    _check_fwd_bwd(q, k, v, bias, do, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_flash_bwd_prepass_matches_plain(cuda, dtype, with_bias):
    """delta and the masked-row correction of the backward's first launch,
    with a row masked by bias and a sentinel row (every score -inf)."""
    q, k, v, bias = _inputs(3, 333, 333, 5, 64, dtype, [333, 0, 100])
    bias[2] = float("-inf")
    bias = bias if with_bias else None
    out, lse = flash_attention_fwd(q, k, v, bias)
    do = torch.randn(3, 333, 5, 64, device="cuda").to(dtype)
    before = kernels.LAUNCHES["flash_bwd_prepass"]
    delta, corr = flash_bwd_prepass(out, do, lse, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_prepass"] == before + 1
    want_delta, want_corr = flash_bwd_prepass_plain(out, do, lse, bias)
    torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-5)
    if with_bias:
        torch.testing.assert_close(corr, want_corr, atol=1e-6, rtol=1e-6)
        assert (corr[1] > 0).all() and (corr[0] == 0).all()
        assert (corr[2] == 0).all()
    else:
        assert corr is None and want_corr is None


def _ulps(a, b):
    """Distance in fp32 units in the last place."""
    ia = a.float().view(torch.int32).long()
    ib = b.float().view(torch.int32).long()
    return (ia - ib).abs().max().item()


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16],
                         ids=["g_fp32", "g_bf16"])
@pytest.mark.parametrize("shape", [(3072, 768), (70001,), (512, 64, 10)])
def test_adam_kernel_zero_noise_matches_plain_exactly(cuda, gdtype, shape):
    g = torch.Generator(device="cuda").manual_seed(1)
    grad = (torch.randn(shape, generator=g, device="cuda") * 1e-3).to(gdtype)
    mu = (torch.randn(shape, generator=g, device="cuda") * 1e-3).bfloat16()
    nu = (torch.rand(shape, generator=g, device="cuda") * 1e-6).bfloat16()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, zero_noise=True)
    before = kernels.LAUNCHES["adam_update"]
    out, mu2, nu2 = adam_update_leaf(grad, mu, nu, 0.271, 0.003, 5, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adam_update"] == before + 1
    o_ref, mu_ref, nu_ref = adam_update_leaf_plain(grad, mu, nu, 0.271,
                                                   0.003, **kw)
    assert out.dtype == gdtype and mu2.dtype == nu2.dtype == torch.bfloat16
    assert torch.equal(mu2, mu_ref) and torch.equal(nu2, nu_ref)
    if gdtype == torch.float32:
        assert _ulps(out, o_ref) <= 1
    else:
        assert torch.equal(out, o_ref)


def test_adam_kernel_noise_brackets_is_unbiased_and_seeded(cuda):
    n = 1 << 22
    g = torch.Generator(device="cuda").manual_seed(2)
    grad = torch.randn(n, generator=g, device="cuda") * 1e-3
    mu = (torch.randn(n, generator=g, device="cuda") * 1e-3).bfloat16()
    nu = (torch.rand(n, generator=g, device="cuda") * 1e-6).bfloat16()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    m32 = 0.9 * mu.float() + (1.0 - 0.9) * grad
    lo = (m32.view(torch.int32) & -65536).view(torch.float32)   # truncated
    hi = ((m32.view(torch.int32) & -65536) + 65536).view(torch.float32)
    _, a, _ = adam_update_leaf(grad, mu, nu, 1.0, 1.0, 11, **kw)
    _, b, _ = adam_update_leaf(grad, mu, nu, 1.0, 1.0, 11, **kw)
    _, c, _ = adam_update_leaf(grad, mu, nu, 1.0, 1.0, 12, **kw)
    af = a.float()
    assert torch.all((af == lo) | (af == hi))        # one of the neighbours
    assert torch.equal(a, b) and not torch.equal(a, c)
    # unbiased: the mean error is within 5 standard errors; a bf16 step at
    # |m| ~ 1e-3 is ~8e-6, so one draw's error is below that
    err = (af - m32).double()
    assert abs(err.mean().item()) < 5 * err.std().item() / n ** 0.5
    # truncation, by contrast, shrinks every magnitude
    trunc = (lo.abs() - m32.abs()).double().mean().item()
    assert trunc < -20 * err.std().item() / n ** 0.5


def _adam_leaves(specs, seed):
    """(gs, mus, nus, seeds) on the card: one leaf per (shape, g dtype,
    offset in elements), each tensor a view starting ``offset`` elements
    into its storage (1: not 16-byte aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    gs, mus, nus = [], [], []
    for shape, gdtype, offset in specs:
        n = 1
        for d in shape:
            n *= d

        def at(x, dtype):
            buf = torch.empty(n + offset, dtype=dtype, device="cuda")
            buf[offset:] = x.reshape(-1)
            return buf[offset:].view(shape)

        gs.append(at(torch.randn(n, generator=g, device="cuda") * 1e-3,
                     gdtype))
        mus.append(at(torch.randn(n, generator=g, device="cuda") * 1e-3,
                      torch.bfloat16))
        nus.append(at(torch.rand(n, generator=g, device="cuda") * 1e-6,
                      torch.bfloat16))
    seeds = [(seed << 40) + (k << 20) + 3 for k in range(len(specs))]
    return gs, mus, nus, seeds


# every size class of the model's leaves (1 to a whole embedding), fp32 and
# bf16 gradients, and leaves that are not 16-byte aligned
ADAM_MIXED = [((1,), torch.float32, 0), ((7,), torch.bfloat16, 0),
              ((768,), torch.float32, 0), ((70001,), torch.bfloat16, 0),
              ((3072, 768), torch.float32, 0), ((4099,), torch.float32, 1),
              ((5120,), torch.bfloat16, 1), ((50265, 768), torch.float32, 0)]


def _adam_equal(got, want):
    """Moments bit-equal; out within one fp32 ulp (equal in bf16)."""
    for k in range(len(want[0])):
        assert torch.equal(got[1][k], want[1][k]), k
        assert torch.equal(got[2][k], want[2][k]), k
        if want[0][k].dtype == torch.float32:
            assert _ulps(got[0][k], want[0][k]) <= 1, k
        else:
            assert torch.equal(got[0][k], want[0][k]), k


@pytest.mark.parametrize("zero_noise", [False, True],
                         ids=["noise", "zero_noise"])
def test_adam_leaves_one_launch_matches_plain_bit_for_bit(cuda, zero_noise):
    """One launch over a mixed list equals the plain version drawing the
    same Philox words; the launch and leaf counters move by one and by the
    number of leaves."""
    gs, mus, nus, seeds = _adam_leaves(ADAM_MIXED, 4)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, zero_noise=zero_noise)
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    got = adam_update_leaves(gs, mus, nus, 0.271, 0.003, seeds, **kw)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED) == (
        before[0] + 1, before[1] + len(gs))
    want = adam_update_leaves_plain(gs, mus, nus, 0.271, 0.003, seeds, **kw)
    _adam_equal(got, want)
    if not zero_noise:      # the words differ between leaves and seeds
        other = adam_update_leaves(gs[-1:], mus[-1:], nus[-1:], 0.271, 0.003,
                                   [seeds[-1] + 1], **kw)
        assert not torch.equal(other[1][0], got[1][-1])


@pytest.mark.parametrize("n_leaves", [100, 1100])
def test_adam_leaves_many_leaves_match_plain_bit_for_bit(cuda, n_leaves):
    """More leaves than one round of warp 0's 32-way search (two rounds at
    100, three past 1 024), sizes, g dtypes and offsets mixed: every block
    finds its leaf and chunk, so each leaf equals the plain version on the
    same words."""
    sizes = (1, 7, 512, 768, 3072, 4099, 5120, 8193, 70001)
    specs = [((sizes[k % len(sizes)],),
              (torch.float32, torch.bfloat16)[k % 2], (k // 3) % 2)
             for k in range(n_leaves)]
    gs, mus, nus, seeds = _adam_leaves(specs, 7)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    before = kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED
    got = adam_update_leaves(gs, mus, nus, 0.271, 0.003, seeds, **kw)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["adam_update"], adam_update.LEAVES_FUSED) == (
        before[0] + 1, before[1] + n_leaves)
    want = adam_update_leaves_plain(gs, mus, nus, 0.271, 0.003, seeds, **kw)
    _adam_equal(got, want)


def test_adam_leaves_in_place_equals_fresh_outputs(cuda):
    """out into g and the moments into themselves, as the optimizer calls
    it: the same bits as new outputs, in the same storage."""
    gs, mus, nus, seeds = _adam_leaves(ADAM_MIXED[:-1], 5)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    fresh = adam_update_leaves(gs, mus, nus, 0.5, 0.25, seeds, **kw)
    gs2, mus2, nus2 = ([x.clone() for x in xs] for xs in (gs, mus, nus))
    ptrs = [x.data_ptr() for x in gs2 + mus2 + nus2]
    got = adam_update_leaves(gs2, mus2, nus2, 0.5, 0.25, seeds, outs=gs2,
                             mu_outs=mus2, nu_outs=nus2, **kw)
    torch.cuda.synchronize()
    assert [x.data_ptr() for xs in got for x in xs] == ptrs
    for ours, theirs in zip(got, fresh):
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))


def test_adam_leaves_refuse_what_the_kernel_does_not_take(cuda):
    gs, mus, nus, seeds = _adam_leaves(ADAM_MIXED[:3], 6)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    before = kernels.LAUNCHES["adam_update"]
    with pytest.raises(TypeError):
        adam_update_leaves([gs[0].half()] + gs[1:], mus, nus, 0.5, 0.5,
                           seeds, **kw)
    strided = torch.zeros(768, 2, dtype=torch.bfloat16, device="cuda")[:, 0]
    for bad in ([mus[0].cpu()] + mus[1:], [mus[0].float()] + mus[1:],
                mus[:2] + [strided]):
        with pytest.raises(ValueError):
            adam_update_leaves(gs, bad, nus, 0.5, 0.5, seeds, **kw)
    assert kernels.LAUNCHES["adam_update"] == before


def test_encoder_remat_on_cuda_recomputes_through_the_kernels(cuda):
    """Training mode on the card with dropout on: remat recomputes each
    block through K1 in the backward pass, with the dropout masks of the
    first pass, so the gradients equal the unremat'd encoder's."""
    spec = EncoderSpec(hidden=128, heads=2, layers=2, intermediate=256,
                       ln_style="pre", dropout=0.1, attention_dropout=0.1)
    plain = TransformerEncoder(spec, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
    remat = TransformerEncoder(dataclasses.replace(spec, remat=True),
                               device=cuda)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(3, 77, 128, generator=g, device="cuda")
    bias = additive_mask(torch.arange(77, device="cuda")[None, :]
                         < torch.tensor([77, 30, 5], device="cuda")[:, None])

    def grads(model):
        fwd, bwd = kernels.LAUNCHES["flash_fwd"], kernels.LAUNCHES["flash_bwd"]
        rng = torch.Generator(device="cuda").manual_seed(3)
        out = model(x, bias, rng)
        got = torch.autograd.grad((out ** 2).sum(), list(model.parameters()))
        return got, (kernels.LAUNCHES["flash_fwd"] - fwd,
                     kernels.LAUNCHES["flash_bwd"] - bwd)

    want, count = grads(plain)
    got, count_remat = grads(remat)
    assert count == (2, 2) and count_remat == (4, 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# --- fused LayerNorm (K4a, K4b) and fused MLP (K5a, K5b) -------------------
# LayerNorm: both sides compute in fp32 and differ by an ulp or so before
# the cast (atol, rtol as TOL); dscale and dbias are fp32 sums over the rows
# in another order, 1e-4 of their largest element. MLP: each tensor within
# 2e-5 (fp32: sums in another order) or 2e-2 (bf16: `a`, `dh` and the result
# rounded to bf16) of its largest element.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h", [(1, 128), (300, 96), (2392, 1024),
                                 (11712, 768), (153592, 512), (3001, 768),
                                 (1031, 520), (517, 1032), (1024, 8192)])
def test_layer_norm_kernels_match_plain(cuda, dtype, n, h):
    from mme_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device="cuda").manual_seed(n)
    x = (torch.randn(n, h, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
    b = 0.2 * torch.randn(h, generator=g, device="cuda")
    gy = torch.randn(n, h, generator=g, device="cuda").to(dtype)
    before = dict(kernels.LAUNCHES)
    y = ln.fused_layer_norm_fwd(x, w, b, 1e-5, dtype)
    got = ln.fused_layer_norm_bwd(gy, x, w, 1e-5)
    again = ln.fused_layer_norm_bwd(gy, x, w, 1e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert kernels.LAUNCHES["layer_norm_bwd"] == before["layer_norm_bwd"] + 2
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(
        y.float(), ln.fused_layer_norm_fwd_plain(x, w, b, 1e-5, dtype).float(),
        atol=atol, rtol=rtol)
    want = ln.fused_layer_norm_bwd_plain(gy, x, w, 1e-5)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    for a, r in zip(got[1:], want[1:]):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max().clamp(min=1e-6)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def _ln_inputs(n, h, xdt, gdt, seed=0, offset=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n + offset, h, generator=g, device="cuda") * 2
         + 0.5).to(xdt)[offset:]
    w = 1 + 0.3 * torch.randn(h, generator=g, device="cuda")
    b = 0.2 * torch.randn(h, generator=g, device="cuda")
    return x, w, b, torch.randn(n, h, generator=g, device="cuda").to(gdt)


@pytest.mark.parametrize("xdt,ydt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["fp32-bf16", "bf16-fp32"])
def test_layer_norm_mixed_types_and_row_offset_view(cuda, xdt, ydt):
    """y in another type than x, g in y's type (a bf16 module fed fp32, and
    the reverse), and x a row-offset view of a larger tensor; bf16 weights
    in the forward read as the fp32 ones rounded."""
    from mme_tpu_torch.ops import layer_norm as ln
    x, w, b, gy = _ln_inputs(2392, 768, xdt, ydt, seed=1, offset=8)
    assert x.data_ptr() != x.untyped_storage().data_ptr()
    y = ln.fused_layer_norm_fwd(x, w, b, 1e-5, ydt)
    got = ln.fused_layer_norm_bwd(gy, x, w, 1e-5)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    y_bf = ln.fused_layer_norm_fwd(x, wb, bb, 1e-5, ydt)
    torch.cuda.synchronize()
    assert y.dtype == ydt and got[0].dtype == xdt
    for out, ref in ((y, ln.fused_layer_norm_fwd_plain(x, w, b, 1e-5, ydt)),
                     (y_bf, ln.fused_layer_norm_fwd_plain(x, wb.float(),
                                                          bb.float(), 1e-5,
                                                          ydt))):
        atol, rtol = TOL[ydt]
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    want = ln.fused_layer_norm_bwd_plain(gy, x, w, 1e-5)
    atol, rtol = TOL[xdt]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    for a, r in zip(got[1:], want[1:]):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()


def test_layer_norm_rejects_misaligned_rows_and_repeats_bits(cuda):
    """A pointer off 16 bytes raises ValueError in both directions (no
    fallback, no launch); two runs of the forward and of the backward give
    the same bits, and each call counts one launch."""
    from mme_tpu_torch.ops import layer_norm as ln
    x, w, b, gy = _ln_inputs(1024, 768, torch.bfloat16, torch.bfloat16)
    flat = torch.zeros(1024 * 768 + 1, dtype=torch.bfloat16, device="cuda")
    off = flat[1:].view(1024, 768)
    assert off.is_contiguous() and off.data_ptr() % 16
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        ln.fused_layer_norm_fwd(off, w, b, 1e-5, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ln.fused_layer_norm_bwd(gy, off, w, 1e-5)
    with pytest.raises(ValueError, match="16-byte"):
        ln.fused_layer_norm_bwd(off, x, w, 1e-5)
    assert kernels.LAUNCHES == before
    runs = [(ln.fused_layer_norm_fwd(x, w, b, 1e-5, torch.bfloat16),
             *ln.fused_layer_norm_bwd(gy, x, w, 1e-5)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(*runs))
    assert kernels.LAUNCHES["layer_norm_fwd"] == before["layer_norm_fwd"] + 2
    assert kernels.LAUNCHES["layer_norm_bwd"] == before["layer_norm_bwd"] + 2


def test_layer_norm_module_dispatch_on_cuda(cuda, monkeypatch):
    from mme_tpu_torch.ops.layer_norm import FusedLayerNorm
    mod = FusedLayerNorm(768, 1e-5, torch.bfloat16, device=cuda)
    x = torch.randn(8, 473, 768, device="cuda", requires_grad=True)
    monkeypatch.delenv("MME_FUSED_LN", raising=False)
    before = kernels.LAUNCHES["layer_norm_fwd"]
    ref = mod(x)
    assert kernels.LAUNCHES["layer_norm_fwd"] == before      # default off
    monkeypatch.setenv("MME_FUSED_LN", "1")
    out = mod(x)                    # fp32 in, bf16 module: the module's dtype
    assert kernels.LAUNCHES["layer_norm_fwd"] == before + 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=1e-2)
    out.float().sum().backward()
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
    mod(x[:1])                                   # 473 rows: the plain path
    assert kernels.LAUNCHES["layer_norm_fwd"] == before + 1
    with pytest.raises(TypeError):
        from mme_tpu_torch.ops.layer_norm import fused_layer_norm_fwd
        fused_layer_norm_fwd(x.reshape(-1, 768).half(), mod.weight, mod.bias,
                             1e-5, torch.float32)


def _gemm_operand(rows, cols, mn, g):
    """A [rows, cols] bf16 operand contracted along `cols`: stored with
    `rows` contiguous when `mn`, else `cols`, in storage padded past the
    extent, so the row stride is not the extent."""
    inner, outer = (rows, cols) if mn else (cols, rows)
    store = torch.randn(outer, (inner + 7) // 8 * 8 + 8, generator=g,
                        device="cuda").to(torch.bfloat16)
    t = store[:, :inner]
    return t.t() if mn else t


@pytest.mark.parametrize("a_mn,b_mn", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("m,n,k", [(5, 3, 7), (200, 136, 328),
                                   (300, 520, 1000), (4000, 1100, 136)])
def test_gemm_core_matches_fp32_matmul(cuda, a_mn, b_mn, m, n, k):
    """The wgmma/TMA core of the bf16 MLP kernels against an fp32 product
    of the same bf16 operands, both operand orders, every extent ragged
    against the 128 x 128 x 64 tiles, the last case on more tiles than the
    card has SMs; held like the MLP (2e-2 of the largest element: the
    result is rounded to bf16)."""
    from mme_tpu_torch.ops import fused_mlp as fm
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = _gemm_operand(m, k, a_mn, g)                  # [M, K]
    b = _gemm_operand(n, k, b_mn, g).t()              # [K, Nc]
    assert fm.gemm_operand_major(a, 1) == a_mn
    assert fm.gemm_operand_major(b, 0) == b_mn
    before = kernels.LAUNCHES["gemm_bf16"]
    c = fm.gemm_bf16(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gemm_bf16"] == before + 1
    ref = torch.matmul(a.float(), b.float())
    assert c.shape == (m, n) and c.dtype == torch.bfloat16
    err = (c.float() - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


def _mlp_inputs(n, h, f, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    return ((r(n + 8, h).to(dtype))[8:], (r(f, h) * h ** -0.5).to(dtype),
            r(f) * 0.1, (r(h, f) * f ** -0.5).to(dtype), r(h) * 0.1,
            r(n, h).to(dtype))


@pytest.mark.parametrize("n,h,f,dtype,act", [
    (1, 256, 64, torch.float32, "gelu"),
    (100, 256, 128, torch.float32, "gelu_new"),
    (100, 512, 128, torch.bfloat16, "relu"),
    (100, 256, 128, torch.bfloat16, "tanh"),
    (300, 768, 3072, torch.float32, "gelu"),
    (560, 768, 3072, torch.bfloat16, "gelu"),
    (2392, 1024, 4096, torch.bfloat16, "gelu"),
    (3784, 768, 3072, torch.bfloat16, "gelu"),
    (11712, 768, 3072, torch.bfloat16, "gelu"),
    (1, 256, 64, torch.bfloat16, "gelu"),
    (17, 512, 192, torch.bfloat16, "gelu_new"),
    (129, 768, 320, torch.bfloat16, "relu"),
    (129, 1024, 256, torch.bfloat16, "tanh"),
    (17, 1024, 4096, torch.bfloat16, "gelu"),
])
def test_fused_mlp_kernels_match_plain(cuda, n, h, f, dtype, act):
    from mme_tpu_torch.ops import fused_mlp as fm
    x, w1, b1, w2, b2, do = _mlp_inputs(n, h, f, dtype)
    before = dict(kernels.LAUNCHES)
    out = fm.fused_mlp_fwd(x, w1, b1, w2, b2, act)
    got = fm.fused_mlp_bwd(x, w1, b1, w2, do, act)
    again = fm.fused_mlp_bwd(x, w1, b1, w2, do, act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_mlp_fwd"] == before["fused_mlp_fwd"] + 1
    assert kernels.LAUNCHES["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 2
    want = (fm.fused_mlp_fwd_plain(x, w1, b1, w2, b2, act),
            *fm.fused_mlp_bwd_plain(x, w1, b1, w2, do, act))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for name, a, r in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                          (out, *got), want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (name, err)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_mlp_module_dispatch_and_autograd_on_cuda(cuda, monkeypatch):
    """Mlp with MME_FUSED_MLP=1 goes through both kernels; a width outside
    the shape rule takes the unfused path, decided before any launch; a
    direct call with such a width raises."""
    from mme_tpu_torch.models.layers import Mlp
    from mme_tpu_torch.ops.fused_mlp import fused_mlp
    spec = EncoderSpec(hidden=256, heads=4, layers=1, intermediate=512,
                       dtype=torch.bfloat16)
    mlp = Mlp(spec, device=cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.05)
    x = torch.randn(3, 77, 256, generator=g, device="cuda")

    def run():
        leaf = x.clone().requires_grad_()
        out = mlp(leaf)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [leaf, *mlp.parameters()])
        return out, grads

    monkeypatch.setenv("MME_FUSED_MLP", "0")
    ref, ref_grads = run()
    monkeypatch.setenv("MME_FUSED_MLP", "1")
    fwd, bwd = (kernels.LAUNCHES["fused_mlp_fwd"],
                kernels.LAUNCHES["fused_mlp_bwd"])
    out, grads = run()
    assert kernels.LAUNCHES["fused_mlp_fwd"] == fwd + 1
    assert kernels.LAUNCHES["fused_mlp_bwd"] == bwd + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    for a, r in zip(grads, ref_grads):
        assert a.dtype == r.dtype
        assert (a - r).abs().max() <= 3e-2 * r.abs().max()
    narrow = Mlp(EncoderSpec(hidden=128, heads=4, layers=1, intermediate=256),
                 device=cuda)
    with torch.no_grad():
        for p in narrow.parameters():
            p.normal_(std=0.05)
    narrow(torch.randn(2, 5, 128, device="cuda"))          # unfused
    assert kernels.LAUNCHES["fused_mlp_fwd"] == fwd + 1
    z = torch.zeros(4, 128, device="cuda")
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp(z, torch.zeros(256, 128, device="cuda"),
                  torch.zeros(256, device="cuda"),
                  torch.zeros(128, 256, device="cuda"),
                  torch.zeros(128, device="cuda"))
    with pytest.raises(ValueError, match="stride"):        # rows not aligned
        wide = torch.zeros(4, 260, device="cuda")[:, 2:258]
        fused_mlp(wide, torch.zeros(64, 256, device="cuda"),
                  torch.zeros(64, device="cuda"),
                  torch.zeros(256, 64, device="cuda"),
                  torch.zeros(256, device="cuda"))


# --- the forward kernels as operators, and a bundle exported on the card ---
# Each operator against its plain version on the card (TOL, or the MLP's
# share of the largest element) and against its fake implementation
# (shapes, dtypes, strides: torch.library.opcheck). The bundle: a small
# encoder classifier exported with both knobs on, served through the three
# operators, against the live model within SERVE_TOL[bf16] of chip_smoke.py
# (bf16 differences carried through two layers; measured far below).

def _operator_cases(dtype):
    from mme_tpu_torch.ops.fused_mlp import (fused_mlp_fwd_op,
                                             fused_mlp_fwd_plain)
    from mme_tpu_torch.ops.layer_norm import (fused_layer_norm_fwd_plain,
                                              layer_norm_fwd_op)
    from mme_tpu_torch.ops.flash_attention import flash_fwd_op
    q, k, v, bias = _inputs(2, 70, 70, 3, 64, dtype, [70, 31])
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1100, 256, generator=g, device="cuda").to(dtype)
    w = torch.randn(256, generator=g, device="cuda")
    w1 = (torch.randn(512, 256, generator=g, device="cuda") * 0.05).to(dtype)
    w2 = (torch.randn(256, 512, generator=g, device="cuda") * 0.05).to(dtype)
    b1 = torch.randn(512, generator=g, device="cuda")
    return {
        "flash_fwd": (flash_fwd_op, (q, k, v, bias),
                      flash_attention_fwd_plain),
        "layer_norm_fwd": (layer_norm_fwd_op, (x, w, w * 0.5, 1e-6, dtype),
                           fused_layer_norm_fwd_plain),
        "fused_mlp_fwd": (fused_mlp_fwd_op, (x, w1, b1, w2, w, "gelu"),
                          fused_mlp_fwd_plain)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["flash_fwd", "layer_norm_fwd",
                                  "fused_mlp_fwd"])
def test_forward_operator_matches_plain_and_fake(cuda, name, dtype):
    op, args, plain = _operator_cases(dtype)[name]
    before = kernels.LAUNCHES[name]
    got = op(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = plain(*args)
    for a, r in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert a.is_contiguous() and a.device.type == "cuda"
        if name == "fused_mlp_fwd":
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            assert ((a.float() - r.float()).abs().max()
                    <= tol * r.float().abs().max())
        else:
            atol, rtol = TOL[dtype]
            torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                       rtol=rtol)
    result = torch.library.opcheck(
        op, args, test_utils=("test_schema", "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result


class _EncoderClassifier(torch.nn.Module):
    def __init__(self, spec, device):
        super().__init__()
        self.encoder = TransformerEncoder(spec, device=device)
        self.head = torch.nn.Linear(spec.hidden, 5, device=device)

    def forward(self, batch):
        keep = batch["mask"]
        h = self.encoder(batch["x"], additive_mask(keep))
        pooled = (h.float() * keep[..., None]).sum(1) / keep.sum(1,
                                                                 keepdim=True)
        return self.head(pooled)


def test_bundle_exported_on_card_serves_through_the_operators(
        cuda, tmp_path, monkeypatch):
    """A two-layer bf16 encoder classifier (hidden 256, 4 heads, 4 x 300
    rows per chunk) exported on the card with MME_FUSED_LN=1
    MME_FUSED_MLP=1: its program calls the three operators, the bundle
    serves on the card with K1, K4a and K5a launched per chunk as the live
    model launches them, and matches the live model."""
    import numpy as np
    from mme_tpu_torch.serve import Predictor, export_bundle, load_bundle
    spec = EncoderSpec(hidden=256, heads=4, layers=2, intermediate=512,
                       ln_style="pre", dtype=torch.bfloat16)
    model = _EncoderClassifier(spec, cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((6, 300, 256), dtype=np.float32),
             "mask": (np.arange(300)[None, :]
                      < np.array([300, 200, 5, 300, 1, 90])[:, None]
                      ).astype(np.float32)}
    monkeypatch.setenv("MME_FUSED_LN", "1")
    monkeypatch.setenv("MME_FUSED_MLP", "1")
    live = Predictor(model, batch_size=4, device="cuda")
    names = ("flash_fwd", "layer_norm_fwd", "fused_mlp_fwd")
    before = {k: kernels.LAUNCHES[k] for k in names}
    preds, probs = live(batch)
    live_count = {k: kernels.LAUNCHES[k] - before[k] for k in names}
    assert live_count["flash_fwd"] == 4 and live_count["fused_mlp_fwd"] == 4
    # 2 chunks x 2 layers x (ln1, ln2)
    assert live_count["layer_norm_fwd"] == 8
    info = export_bundle(model, batch, str(tmp_path / "b"), batch_size=4,
                         device="cuda")
    assert info["bytes"] > 0
    monkeypatch.delenv("MME_FUSED_LN")
    monkeypatch.delenv("MME_FUSED_MLP")
    served = load_bundle(str(tmp_path / "b"), device="cuda")
    assert served.platforms == ("cuda",)
    before = {k: kernels.LAUNCHES[k] for k in names}
    b_preds, b_probs = served(batch)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in names} == live_count
    np.testing.assert_allclose(b_probs, probs, atol=5e-2)
    margin = np.sort(probs, -1)[:, -1] - np.sort(probs, -1)[:, -2]
    sure = margin > 5e-2
    np.testing.assert_array_equal(b_preds[sure], preds[sure])
    with pytest.raises(ValueError, match="cannot serve on cpu"):
        load_bundle(str(tmp_path / "b"), device="cpu")


# --- the fusion family: the MoE FFN and the four trunks at full width ------

def test_moe_mlp_on_card_matches_cpu(cuda):
    """``MoEMlp`` at the fusion trunk's shape [8, 473, 768], E = 4, top-2,
    in fp32 on the card against the same module on the CPU: every token
    whose CPU router margin (k-th minus (k+1)-th probability) is 1e-4 or
    more routes alike (the two routers' logits differ by fp32 rounding, so
    only a near-tie may flip), and the tokens routed alike agree within
    1e-4 relative (fp32 products summed in other orders)."""
    import copy
    from mme_tpu_torch.models.moe import MoEMlp, MoESpec, router_gates
    spec = EncoderSpec(hidden=768, intermediate=3072)
    moe = MoEMlp(spec, MoESpec(), device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p, fan_in in ((moe.router.weight, 768), (moe.w1, 4 * 768),
                          (moe.w2, 4 * 3072), (moe.b1, 50), (moe.b2, 50)):
            p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
        x = torch.randn(8, 473, 768, generator=g)
        card = copy.deepcopy(moe).to(cuda)
        want, want_aux = moe(x)
        got, aux = card(x.to(cuda))
        logits = moe.router(x)
        routes = router_gates(logits, 2)[0] > 0
        card_routes = router_gates(card.router(x.to(cuda)), 2)[0].cpu() > 0
    top = torch.softmax(logits, -1).topk(3, -1).values
    margin = top[..., 1] - top[..., 2]
    same = (routes == card_routes).all(-1)
    assert same[margin >= 1e-4].all()
    assert same.float().mean().item() > 0.999
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu()[same], want[same], rtol=1e-4,
                               atol=1e-4 * scale)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name,flash", [("TAVFormer", 12),
                                        ("TAVForMAE2Tower", 18),
                                        ("TAVForW2V2", 12), ("TAVMoE", 12)])
def test_fusion_model_full_width_flash_matches_plain(cuda, name, flash,
                                                     monkeypatch):
    """One fp32 forward of each fusion trunk at full width (70 tokens,
    96 000 samples, a 16x224x224 clip, batch 2, weights from
    ``init_params(model=name)``): one K1 launch per attention layer, and
    the logits within 1e-4 of the same model's with MME_FLASH=0."""
    from mme_tpu_torch.convert import from_flax, init_params
    from mme_tpu_torch.models.fusion import FUSION_MODELS, TAVSpec
    from mme_tpu_torch.train.build_tav import example_tav_batch
    spec = TAVSpec(output_dim=7)
    model = FUSION_MODELS[name](spec, device=cuda)
    model.load_state_dict(from_flax(init_params(spec, 0, model=name)))
    b = example_tav_batch(spec, 2, 70, 96000, seed=1)
    b["text_mask"][1, 40:] = 0
    b["audio_mask"][1, 60000:] = 0
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    model.eval()

    def logits():
        before = kernels.LAUNCHES["flash_fwd"]
        with torch.no_grad():
            out = model(batch)
        out = out[0] if isinstance(out, tuple) else out
        return out.cpu(), kernels.LAUNCHES["flash_fwd"] - before

    got, count = logits()
    monkeypatch.setenv("MME_FLASH", "0")
    want, count_plain = logits()
    assert count == flash and count_plain == 0
    assert got.shape == (2, 7) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# --- the audio classifier and the BatchNorm models -------------------------

def test_wav2vec2_base_full_width_kernels_match_plain(cuda, monkeypatch):
    """``Wav2Vec2Classifier(Wav2Vec2Spec.base(), 7)`` at full width in fp32
    (batch 4 over 96 000-sample waveforms with ragged keep-masks, weights
    from ``init_variables``): eval logits with K1 (12 launches) within 1e-4
    of MME_FLASH=0's; with MME_FUSED_LN=1 MME_FUSED_MLP=1, 26 K4a and 12
    K5a launches and the logits within 1e-4 of the knobs-off ones; the
    training-mode loss and gradient norm with K1/K2 and the knobs (12 K2,
    26 K4b, 12 K5b) within 1e-5 and 1e-3 relative of the plain path's."""
    from mme_tpu_torch.convert import from_flax, init_variables
    from mme_tpu_torch.data.synthetic import synthetic_audio_dataset
    from mme_tpu_torch.models.audio import Wav2Vec2Classifier, Wav2Vec2Spec
    from mme_tpu_torch.train.losses import cross_entropy
    from mme_tpu_torch.train.optim import global_norm_f32
    spec = Wav2Vec2Spec.base()
    spec = dataclasses.replace(spec, mask_time_prob=0.0,
                               encoder=dataclasses.replace(spec.encoder,
                                                           dropout=0.0))
    model = Wav2Vec2Classifier(spec, 7, 0.0, device=cuda)
    model.load_state_dict(from_flax(**init_variables(model, 0)))
    ds = synthetic_audio_dataset(4, 96000, 7, seed=3)
    wave, mask = (torch.from_numpy(ds.features[k]).to(cuda)
                  for k in ("waveform", "audio_mask"))
    labels = torch.from_numpy(ds.labels).to(cuda)
    names = ("flash_fwd", "flash_bwd", "layer_norm_fwd", "layer_norm_bwd",
             "fused_mlp_fwd", "fused_mlp_bwd")

    def run(train):
        before = {k: kernels.LAUNCHES[k] for k in names}
        model.train(train)
        with torch.set_grad_enabled(train):
            logits = model(wave, mask)
        out = logits
        if train:
            loss = cross_entropy(logits, labels, torch.ones(7, device=cuda),
                                 torch.ones(4, dtype=torch.int32,
                                            device=cuda))
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True)
            out = (loss.item(), global_norm_f32(
                [g for g in grads if g is not None]).item())
        torch.cuda.synchronize()
        return out, {k: kernels.LAUNCHES[k] - before[k] for k in names
                     if kernels.LAUNCHES[k] != before[k]}

    got, count = run(False)
    monkeypatch.setenv("MME_FLASH", "0")
    want, count_plain = run(False)
    (loss0, norm0), _ = run(True)
    monkeypatch.delenv("MME_FLASH")
    assert count == {"flash_fwd": 12} and not count_plain
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    monkeypatch.setenv("MME_FUSED_LN", "1")
    monkeypatch.setenv("MME_FUSED_MLP", "1")
    fused, count_f = run(False)
    assert count_f == {"flash_fwd": 12, "layer_norm_fwd": 26,
                       "fused_mlp_fwd": 12}
    torch.testing.assert_close(fused, got, atol=1e-4, rtol=0)
    (loss, norm), count_t = run(True)
    assert count_t == {k: 26 if k.startswith("layer_norm") else 12
                       for k in names}
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    assert abs(norm - norm0) <= 1e-3 * norm0


def test_batchnorm_update_on_card_matches_biased_recomputation(cuda):
    """``models/norm.py::BatchNorm`` in training mode on a
    [8, 64, 16, 28, 28] fp32 tensor: outputs as ``F.batch_norm``'s
    (which also normalises by the biased variance) within 1e-5, running
    mean and variance as 0.9 · init + 0.1 · (mean, ``var(unbiased=False)``)
    within 1e-6 + 1e-5 relative; ``torch.nn.BatchNorm3d``'s running
    variance, the unbiased one, differs. Eval mode normalises with the
    buffers."""
    import torch.nn.functional as F
    from mme_tpu_torch.models.norm import BatchNorm
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 64, 16, 28, 28, generator=g, device="cuda") * 3 + 1
    bn = BatchNorm(64, device=cuda)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(64, generator=g, device="cuda") + 0.5)
        bn.bias.copy_(torch.randn(64, generator=g, device="cuda"))
        bn.train()
        y = bn(x)
    dims = (0, 2, 3, 4)
    want_y = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                          eps=1e-5)
    torch.testing.assert_close(y, want_y, atol=1e-5, rtol=0)
    torch.testing.assert_close(bn.mean, 0.1 * x.mean(dims), atol=1e-6,
                               rtol=1e-5)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * x.var(dims,
                                                          unbiased=False),
                               atol=1e-6, rtol=1e-5)
    ref = torch.nn.BatchNorm3d(64, momentum=0.1, device=cuda)
    ref(x[:2, :, :1, :2, :2])              # 8 values per channel
    small = BatchNorm(64, device=cuda)
    small(x[:2, :, :1, :2, :2])
    assert (ref.running_var - small.var).abs().max().item() > 1e-3
    bn.eval()
    with torch.no_grad():
        y = bn(x)
    want = F.batch_norm(x, bn.mean, bn.var, bn.weight, bn.bias,
                        training=False, eps=1e-5)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=0)


def test_batchnorm_bundle_round_trip_on_card(cuda, tmp_path):
    """A (1, 1, 1, 1)-block SlowR50 with random running statistics, exported
    on the card: the bundle holds the statistics and serves the live
    Predictor's probabilities within 1e-5 (fp32, the same cuDNN
    convolutions)."""
    import numpy as np
    from mme_tpu_torch.cli.common import BatchModel
    from mme_tpu_torch.convert import from_flax, init_variables
    from mme_tpu_torch.models.norm import BatchNorm
    from mme_tpu_torch.models.video import SlowR50
    from mme_tpu_torch.serve import Predictor, export_bundle, load_bundle
    net = SlowR50(5, stage_sizes=(1, 1, 1, 1), device=cuda)
    v = init_variables(net, 1)
    rng = np.random.RandomState(0)
    for bn in v["batch_stats"].values():
        for stats in (bn.values() if "mean" not in bn else [bn]):
            stats["mean"] = rng.rand(*stats["mean"].shape).astype("f") - 0.5
            stats["var"] = rng.rand(*stats["var"].shape).astype("f") + 0.5
    net.load_state_dict(from_flax(**v))
    model = BatchModel(net, ("video",))
    x = {"video": rng.rand(6, 4, 64, 64, 3).astype(np.float32)}
    preds, probs = Predictor(model, batch_size=4, device="cuda")(x)
    export_bundle(model, x, str(tmp_path / "b"), batch_size=4, device="cuda")
    served = load_bundle(str(tmp_path / "b"), device="cuda")
    b_preds, b_probs = served(x)
    np.testing.assert_allclose(b_probs, probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b_preds, preds)
    held = {k for k in served.module.state_dict()
            if k.endswith((".mean", ".var"))}
    assert len(held) == 2 * sum(isinstance(m, BatchNorm)
                                for m in net.modules())


# --- the text and two-modality classifiers ----------------------------------

# bf16 probabilities, kernels against their plain versions
ZOO_PROB_TOL = 1e-2

def _zoo_case(name, dtype):
    """(BatchModel at a small width computing in ``dtype``, requests of 4
    rows, K1 launches per forward, the model's spec for its LayerNorm
    sites): hidden 256 in 4 heads of 64 and intermediate 1024, the widths
    the flash and fused-MLP kernels take, 2 layers per tower."""
    from mme_tpu_torch.cli import text_audio_nn, text_video_nn, visual_bert_nn
    from mme_tpu_torch.cli.common import BatchModel
    from mme_tpu_torch.data.synthetic import synthetic_text_dataset
    from mme_tpu_torch.models import text, text_audio, text_video, video
    from mme_tpu_torch.models import visualbert

    def enc(e):
        return dataclasses.replace(e, hidden=256, heads=4, layers=2,
                                   intermediate=1024, dtype=dtype)

    t = text.TextEncoderSpec()
    t = dataclasses.replace(t, vocab_size=1000, encoder=enc(t.encoder))
    v = video.VideoMAESpec()
    v = dataclasses.replace(v, image_size=112, encoder=enc(v.encoder))
    a = text_audio.TextAudioSpec().audio
    a = dataclasses.replace(a, conv_dims=(32, 32, 32),
                            conv_kernels=(10, 3, 3), conv_strides=(5, 2, 2),
                            mask_time_prob=0.0, encoder=enc(a.encoder))
    if name == "BertClassifier":
        net, spec = text.BertClassifier(t, 7, device="cuda"), t
        feats = synthetic_text_dataset(1000, 4, 70, 7, 1).features
        inputs, flash = ("input_ids", "text_mask"), 2
    elif name == "BertAudioClassifier":
        spec = text_audio.TextAudioSpec(text=t, audio=a, hidden=256)
        net = text_audio.BertAudioClassifier(spec, device="cuda")
        feats = text_audio_nn.synthetic_ta(spec, 4, 70, 24000, 7, 1).features
        inputs, flash = text_audio_nn.INPUTS, 4
    elif name == "VBertClassifier":
        spec = dataclasses.replace(visualbert.VisualBertSpec(),
                                   vocab_size=1000,
                                   encoder=enc(visualbert.VisualBertSpec()
                                               .encoder))
        net = visualbert.VBertClassifier(spec, 2, device="cuda")
        feats = visual_bert_nn.synthetic_vbert(4, 70, 1024, 1000, 2,
                                               1).features
        inputs, flash = visual_bert_nn.INPUTS, 2
    else:
        spec = text_video.TextVideoSpec(text=t, video=v, hidden=256)
        feats = text_video_nn.synthetic_tv(spec, 4, 70, 7, 1).features
        if name == "VideoMAEClassifier":
            net, spec = video.VideoMAEClassifier(v, 7, device="cuda"), v
            inputs, flash = ("video",), 2
        else:
            net = getattr(text_video, name)(spec, device="cuda")
            inputs, flash = text_video_nn.INPUTS, 4
            if name == "BertVideoMAEMTLShared":
                feats["task_id"] = np.array([0, 1, 0, 1], np.int32)
                inputs += ("task_id",)
    return net, BatchModel(net, inputs), feats, flash, spec


@pytest.mark.parametrize("name", ["BertClassifier", "BertAudioClassifier",
                                  "BertVideoMAEMTLShared",
                                  "BertVideoMAELateFusion", "VBertClassifier",
                                  "VideoMAEClassifier"])
def test_zoo_classifier_bf16_kernels_match_plain(cuda, name, monkeypatch):
    """Each text or two-modality classifier in bf16 at a small width
    (batch 4, 70 tokens, 24 000 samples, 16x112x112 clips, weights from
    ``init_variables``), served by ``Predictor``: one K1 launch per
    attention layer and the probabilities within ZOO_PROB_TOL of
    MME_FLASH=0's; with MME_FUSED_LN=1 MME_FUSED_MLP=1, one K5a launch per
    layer, the K4a count of ``classifier_ln_sites`` and the probabilities
    within ZOO_PROB_TOL of the knobs-off ones."""
    from mme_tpu_torch.convert import from_flax, init_variables
    from mme_tpu_torch.serve import Predictor
    from mme_tpu_torch.time_layer_norm import (classifier_ln_sites,
                                               fused_ln_sites)
    net, model, feats, flash, spec = _zoo_case(name, torch.bfloat16)
    net.load_state_dict(from_flax(**init_variables(net, 0)), strict=True)
    pred = Predictor(model, batch_size=4, device=cuda)
    names = ("flash_fwd", "layer_norm_fwd", "fused_mlp_fwd")

    def serve():
        before = {k: kernels.LAUNCHES[k] for k in names}
        probs = pred(feats)[1]
        return probs, {k: kernels.LAUNCHES[k] - before[k] for k in names
                       if kernels.LAUNCHES[k] != before[k]}

    got, count = serve()
    monkeypatch.setenv("MME_FLASH", "0")
    want, count_plain = serve()
    monkeypatch.delenv("MME_FLASH")
    assert count == {"flash_fwd": flash} and not count_plain
    assert np.isfinite(got).all() and got.shape[0] == 4
    assert np.abs(got - want).max() <= ZOO_PROB_TOL
    monkeypatch.setenv("MME_FUSED_LN", "1")
    monkeypatch.setenv("MME_FUSED_MLP", "1")
    fused, count_f = serve()
    n_ln = sum(fused_ln_sites(classifier_ln_sites(
        spec, 4, text_len=70, samples=24000)).values())
    want_f = {"flash_fwd": flash, "fused_mlp_fwd": flash}
    if n_ln:
        want_f["layer_norm_fwd"] = n_ln
    assert count_f == want_f
    assert np.abs(fused - got).max() <= ZOO_PROB_TOL
