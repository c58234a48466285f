"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test here skips (the fixture
decides, so every pytest worker collects the same tests). On a machine with
a card: ``python -m pytest tests/test_torch_cuda.py -m cuda``.

Tolerances (elementwise |O - O_plain| <= atol + rtol |O_plain|): fp32 sums
fp32 products in another order, a few fp32 ulps; bf16 rounds the
unnormalised probabilities (the plain version the normalised ones) and O
itself to bf16, a bf16 ulp or two. LSE is fp32 on both sides.
"""

import pytest
import torch

from mme_tpu_torch.models.layers import EncoderSpec, TransformerEncoder
from mme_tpu_torch.ops import kernels
from mme_tpu_torch.ops.attention import additive_mask, dot_product_attention_shd
from mme_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                               flash_attention_fwd_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


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
