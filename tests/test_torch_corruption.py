"""The port's corruption ops against the JAX package's
``data/corruption.py``: noise mixing equal with the same rng, and the
pyramid blur within one level at rates 2, 4 and 8 on odd frame sizes."""

import numpy as np
import pytest
import torch

from mertools_tpu.data import corruption as jc
from mertools_tpu_torch.data import corruption as tc

torch.set_num_threads(1)


@pytest.mark.parametrize("int16_range", [True, False])
def test_mix_noise_equals_jax(int16_range):
    rng = np.random.default_rng(0)
    clean = rng.normal(size=12000) * (9000 if int16_range else 0.3)
    pool = [rng.normal(size=n) * 3000 for n in (5000, 7000, 3000)]
    got, info = tc.mix_noise(clean, pool, 5.0, rng=np.random.default_rng(7),
                             int16_range=int16_range)
    ref, rinfo = jc.mix_noise(clean, pool, 5.0, rng=np.random.default_rng(7),
                              int16_range=int16_range)
    np.testing.assert_array_equal(got, ref)
    assert info == rinfo
    assert tc.rms(clean) == jc.rms(clean)
    assert tc.adjusted_noise_rms(100.0, 20.0) == jc.adjusted_noise_rms(100.0, 20.0)


@pytest.mark.parametrize("rate", [1, 2, 4, 8])
def test_blur_frames_matches_jax_on_odd_sizes(rate):
    """Halving with floor division, then doubling: 37 x 50 comes back as
    36 x 50 at rate 2, 36 x 48 at rate 4 and 32 x 48 at rate 8, as in the
    JAX package; levels within one (rounding of float32 resizes)."""
    frames = np.random.default_rng(rate).integers(0, 256, (3, 37, 50, 3), np.uint8)
    ref = jc.blur_frames(frames, rate)
    got = tc.blur_frames(frames, rate, device="cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref).max() <= 1
    if rate == 1:
        assert got is frames
