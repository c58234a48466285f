"""benchmark/flops.py against hand counts."""

import pytest

import flops
from conftest import tiny


def test_one_encoder_layer_by_hand():
    e = {"hidden": 768, "heads": 12, "intermediate": 3072}
    B, S = 8, 1464
    t = B * S
    by_hand = (2 * t * 768 * 2304 + 2 * t * 768 * 768 + 2 * t * 768 * 3072
               + 2 * t * 3072 * 768 + 4 * B * 12 * S * S * 64)
    assert flops.encoder_layer(B, S, e) == by_hand


def test_flash_bounds_at_the_video_shape():
    """PERF.md's kernel table: video S = 1 464, 12 heads, batch 8, bf16:
    K1 0.0533 ms and K2 0.1331 ms, both bound by operations."""
    k1, k2 = flops.flash_bounds(8, 1464, 1464, 12, 64, "bfloat16", False)
    assert k1 * 1e3 == pytest.approx(0.0533, abs=5e-5)
    assert k2 * 1e3 == pytest.approx(0.1331, abs=5e-5)
    f1, _ = flops.flash_bounds(8, 1464, 1464, 12, 64, "float32", False)
    assert f1 == pytest.approx(k1 * 989 / 67)


def test_step_counts_three_forwards_and_every_attention():
    from harness.common import load, model
    c = load("configs", "tav")
    assert model(c).shapes(c) == {"text": 70, "video": 1464, "audio": 299,
                                  "fusion": 473}
    assert flops.train_flops(c, 8) == 3 * flops.forward_flops(c, 8)
    assert len(flops.attention_sites(c, 8)) == 54
    tv = load("configs", "text_video")
    assert len(flops.attention_sites(tv, 8)) == 18
    assert flops.forward_flops(tv, 8) / 1e12 == pytest.approx(2.93, abs=0.01)


def test_tiny_counts_are_positive():
    for name in ("tav", "text_video"):
        assert flops.forward_flops(tiny(name), 2) > 0
