"""The port's Kaldi fbank frontend (``mertools_tpu_torch/ops/fbank.py``)
against the JAX package's: the log-mels at several lengths (shorter than
one frame included), the ImageBind mel images (padded and cut to 204
frames), the clip sampler and the numpy tables, on seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mertools_tpu.ops import fbank as jf
from mertools_tpu_torch.ops import fbank as tf

torch.set_num_threads(1)

TOL = 2e-4   # max |port - JAX| / max |JAX| (ROADMAP "Tolerances")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def _wavs(n, b=2, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n,bins", [(300, 40), (400, 40), (561, 128), (8000, 40),
                                    (32000, 128)])
def test_kaldi_fbank_matches_jax(n, bins):
    """Frames ``1 + (n - 400) // 160``: none below one frame, one at 400."""
    w = _wavs(n, seed=n)
    got = tf.kaldi_fbank(torch.from_numpy(w), bins).numpy()
    want = np.asarray(jf.kaldi_fbank(jnp.asarray(w), bins))
    assert got.shape == (2, max(1 + (n - 400) // 160, 0), bins)
    _close(got, want)


@pytest.mark.parametrize("n", [300, 32000, 36000])
def test_imagebind_melspec_pads_and_cuts_like_jax(n):
    """198 frames of a 2 s clip pad to 204; a 2.25 s clip's 223 are cut;
    a clip shorter than one frame is all padding."""
    w = _wavs(n, b=3, seed=n + 1)
    got = tf.imagebind_melspec(torch.from_numpy(w)).numpy()
    want = np.asarray(jf.imagebind_melspec(jnp.asarray(w)))
    assert got.shape == (3, 128, 204)
    _close(got, want)


def test_tables_and_clip_sampler_equal_jax():
    np.testing.assert_array_equal(tf.kaldi_mel_banks(128), jf.kaldi_mel_banks(128))
    np.testing.assert_array_equal(tf._hann_symmetric(400), jf._hann_symmetric(400))
    for dur in (0.5, 2.0, 6.0, 37.3):
        assert tf.constant_clip_timepoints(dur) == jf.constant_clip_timepoints(dur)
    rng = np.random.default_rng(3)
    for n in (10000, 32000, 50000, 720000):
        w = rng.normal(size=n).astype(np.float32)
        np.testing.assert_array_equal(tf.sample_audio_clips(w), jf.sample_audio_clips(w))


def test_clip_sampler_keeps_a_window_one_sample_too_long():
    """At 50,001 samples float rounding makes a reference window 32,001
    samples long; the JAX copy raises, the port keeps its first 32,000 and
    its mel image equals the reference window's (whose extra sample lies
    past the last frame)."""
    w = np.random.default_rng(4).normal(size=50001).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jf.sample_audio_clips(w)
    got = tf.sample_audio_clips(w)
    windows = [w[int(s * 16000): int(e * 16000)]
               for s, e in tf.constant_clip_timepoints(50001 / 16000)]
    assert max(len(x) for x in windows) == 32001
    for clip, win in zip(got, windows):
        np.testing.assert_array_equal(clip, win[:32000])
        ref = tf.imagebind_melspec(torch.from_numpy(win[None])).numpy()
        _close(tf.imagebind_melspec(torch.from_numpy(clip[None])).numpy(), ref, 1e-5)
