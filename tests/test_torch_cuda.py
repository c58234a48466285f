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

import pytest
import torch

from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import additive_mask, dot_product_attention_shd
from mme_tpu_torch.ops.adam_update import (adam_update_leaf,
                                           adam_update_leaf_plain)
from mme_tpu_torch.ops.flash_attention import (FlashAttention,
                                               flash_attention_bwd,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd,
                                               flash_attention_fwd_plain)

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
                                 (11712, 768), (153592, 512)])
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
