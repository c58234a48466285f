"""The port's resampler (mme_tpu_torch/ops/resample.py) against
mme_tpu/ops/resample.py.

Tolerances: the sinc kernel exactly (the same numpy construction);
``resample_numpy`` exactly (the same numpy products); ``resample_waveform``
(one fp32 convolution) within 1e-5 of JAX's on waves in [-1, 1].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mme_tpu.ops import resample as j_resample

from mme_tpu_torch.ops import resample

torch.set_num_threads(2)

RATES = [(44100, 16000), (48000, 16000), (8000, 16000), (16000, 8000),
         (22050, 16000), (16000, 16000)]


@pytest.mark.parametrize("orig,new", RATES)
def test_kernel_is_jax_bit_for_bit(orig, new):
    want = j_resample.sinc_resample_kernel(orig, new)
    got = resample.sinc_resample_kernel(orig, new)
    assert got[1:] == want[1:]
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("orig,new", RATES)
def test_waveform_and_numpy_paths_match_jax(orig, new):
    rng = np.random.RandomState(orig % 97)
    x = np.clip(rng.randn(3, 2 * orig // 10 + 7) * 0.3, -1, 1).astype(
        np.float32)
    want = np.asarray(j_resample.resample_waveform(jnp.asarray(x), orig, new))
    got = resample.resample_waveform(torch.from_numpy(x), orig, new)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    one = resample.resample_waveform(torch.from_numpy(x[1]), orig, new)
    np.testing.assert_allclose(one.numpy(), want[1], atol=1e-5, rtol=0)
    for row in x:
        np.testing.assert_array_equal(
            resample.resample_numpy(row, orig, new),
            j_resample.resample_numpy(row, orig, new))
