"""The port's transforms (mme_tpu_torch/ops/transforms.py) against
mme_tpu/ops/transforms.py.

Tolerances: exact. ``pool`` and ``crop_video`` compute the same values
(mean over 5 fp32 rows: 1e-6); ``random_flip`` cannot reproduce JAX's RNG
stream, so it is held at p = 0 and p = 1, where the draws do not matter,
and on masks passed in against JAX's flips of the same rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mme_tpu.ops import transforms as j_tf

from mme_tpu_torch.ops import transforms as tf

VIDEO = np.random.RandomState(0).rand(4, 3, 6, 5, 3).astype(np.float32)


def test_boxes_are_jax_boxes():
    assert tf.IEMOCAP_LEFT_BOX == j_tf.IEMOCAP_LEFT_BOX
    assert tf.IEMOCAP_RIGHT_BOX == j_tf.IEMOCAP_RIGHT_BOX


@pytest.mark.parametrize("rows", [5, 6])
@pytest.mark.parametrize("mode", ["mean", "max", "median"])
def test_pool_matches_jax(mode, rows):
    x = np.random.RandomState(rows).randn(rows, 7, 3).astype(np.float32)
    got = tf.pool(torch.from_numpy(x), mode).numpy()
    np.testing.assert_allclose(got, np.asarray(j_tf.pool(jnp.asarray(x),
                                                         mode)),
                               atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        tf.pool(torch.from_numpy(x), "min")


def test_crop_video_matches_jax():
    v = np.random.RandomState(1).rand(2, 400, 720, 3).astype(np.float32)
    for box in (tf.IEMOCAP_LEFT_BOX, tf.IEMOCAP_RIGHT_BOX, (1, 2, 3, 4)):
        got = tf.crop_video(torch.from_numpy(v), box).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            j_tf.crop_video(jnp.asarray(v), box)))


@pytest.mark.parametrize("p_h,p_v", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0),
                                     (1.0, 1.0)])
def test_random_flip_at_certain_probabilities_matches_jax(p_h, p_v):
    want = np.asarray(j_tf.random_flip(jax.random.PRNGKey(3),
                                       jnp.asarray(VIDEO), p_h, p_v))
    got = tf.random_flip(torch.Generator().manual_seed(3),
                         torch.from_numpy(VIDEO), p_h, p_v).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_flip_on_given_masks_matches_jax_per_row():
    do_h = torch.tensor([True, False, True, False])
    do_v = torch.tensor([True, True, False, False])
    got = tf.random_flip(None, torch.from_numpy(VIDEO),
                         masks=(do_h, do_v)).numpy()
    for i in range(4):
        want = np.asarray(j_tf.random_flip(
            jax.random.PRNGKey(0), jnp.asarray(VIDEO[i:i + 1]),
            float(do_h[i]), float(do_v[i])))
        np.testing.assert_array_equal(got[i:i + 1], want)
    # drawn masks: every row is one of its four flips
    drawn = tf.random_flip(torch.Generator().manual_seed(0),
                           torch.from_numpy(VIDEO)).numpy()
    for i in range(4):
        v = VIDEO[i]
        assert any(np.array_equal(drawn[i], c) for c in (
            v, v[:, :, ::-1], v[:, ::-1], v[:, ::-1, ::-1]))
