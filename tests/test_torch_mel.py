"""The port's Whisper log-mel frontend and the plain side of kernel B2
against the JAX package: the filterbank exactly, the FFT path within 1e-4 in
the log domain, ``mel_power_ref`` against ``mel_power_pallas`` run in
interpret mode (as tests/test_mel_pallas.py runs it), and the wrapper's
argument checks and CPU dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.ops import mel as jm
from mertools_tpu.ops import mel_pallas as jp
from mertools_tpu_torch.ops import mel as tm
from mertools_tpu_torch.ops import mel_fused as tf

torch.set_num_threads(1)

N = tm.CHUNK_SAMPLES
LOG_TOL = 1e-4     # abs, log domain: both sides fp32 FFTs (measured 2e-5)
POWER_TOL = 1e-5   # of max |ref|: FFT vs dense DFT at HIGHEST (measured 3e-7)
FUSED_TOL = 1e-4   # abs, log domain, FFT vs DFT (JAX's own test allows 2e-3)


@pytest.fixture(scope="module")
def wavs():
    """B = 2 x 480000: a 4 s 440 Hz sine, then 2 s of noise (zero-padded)."""
    wav = np.zeros((2, N), np.float32)
    t = np.arange(64000) / 16000.0
    wav[0, :64000] = 0.4 * np.sin(2 * np.pi * 440 * t)
    wav[1, :32000] = np.random.default_rng(0).normal(size=32000) * 0.1
    return wav


def test_filter_bank_matches_jax_exactly():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tm.mel_filter_bank(n_mels=n_mels),
                                      jm.mel_filter_bank(n_mels=n_mels))
    np.testing.assert_array_equal(tm.filter_bank(80), jm._get_fb(80))


def test_pad_or_trim_matches_jax():
    for n in (100, N, N + 7):
        w = np.arange(n, dtype=np.float32)
        np.testing.assert_array_equal(tm.pad_or_trim(w), jm.pad_or_trim(w))


def test_log_mel_matches_jax(wavs):
    ref = np.asarray(jm.log_mel_spectrogram(jnp.asarray(wavs)))
    got = tm.log_mel_spectrogram(torch.from_numpy(wavs)).numpy()
    assert got.shape == ref.shape == (2, 80, 3000)
    assert np.abs(got - ref).max() <= LOG_TOL


def test_mel_power_ref_and_fused_match_jax_pallas(wavs):
    """The Pallas kernel in interpret mode: its mel power against the plain
    version, and JAX's fused log-mel against the port's on the CPU."""
    ref = np.asarray(jp.mel_power_pallas(jnp.asarray(wavs), interpret=True))
    x = torch.from_numpy(wavs)
    got = tf.mel_power_ref(x).numpy()
    assert got.shape == ref.shape == (2, 3000, 80)
    assert np.abs(got - ref).max() <= POWER_TOL * np.abs(ref).max()

    log_ref = np.asarray(jp.log_mel_spectrogram_fused(jnp.asarray(wavs),
                                                      interpret=True))
    log_got = tf.log_mel_spectrogram_fused(x).numpy()
    assert np.abs(log_got - log_ref).max() <= FUSED_TOL


def test_shared_tail_is_the_whole_fft_path(wavs):
    x = torch.from_numpy(wavs)
    torch.testing.assert_close(tm.log_mel_from_power(tf.mel_power_ref(x)),
                               tm.log_mel_spectrogram(x), rtol=0, atol=0)


@pytest.mark.parametrize("wav,n_mels,match", [
    (torch.zeros(2, 16000), 80, "480000"),
    (torch.zeros(N), 80, "480000"),
    (torch.zeros(2, N, dtype=torch.float64), 80, "float32"),
    (torch.zeros(N, 2).T, 80, "contiguous"),
    (torch.zeros(2, N), 128, "128"),
    (torch.zeros(2 * N + 1)[1:].view(2, N), 80, "8-byte"),
])
def test_check_kernel_args_rejects(wav, n_mels, match):
    with pytest.raises(ValueError, match=match):
        tf.check_kernel_args(wav, n_mels)
    with pytest.raises(ValueError, match=match):
        tf.mel_power(wav, n_mels)


def test_mel_bands_cover_every_nonzero_and_nothing_else():
    """The kernel's banded mel product: each filter's band runs from its
    first to its last nonzero bin, holds no zero, and the weights rebuild
    the filterbank exactly, so the product is the dense one's function."""
    fb = tm.filter_bank()
    bands, w = tf.mel_bands(fb)
    lo, n, off = bands
    assert bands.dtype == np.int32 and w.dtype == np.float32
    assert n.sum() == np.count_nonzero(fb) == len(w)
    assert (off == np.concatenate([[0], np.cumsum(n)[:-1]])).all()
    rebuilt = np.zeros_like(fb)
    for m in range(fb.shape[0]):
        rebuilt[m, lo[m]:lo[m] + n[m]] = w[off[m]:off[m] + n[m]]
        assert (w[off[m]:off[m] + n[m]] != 0).all()
    np.testing.assert_array_equal(rebuilt, fb)
    # an all-zero filter gets an empty band
    z = fb.copy()
    z[3] = 0
    assert tf.mel_bands(z)[0][1, 3] == 0 and len(tf.mel_bands(z)[1]) == len(w) - n[3]


def test_cpu_tensor_takes_plain_version_without_a_launch():
    wav = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, N)).astype(np.float32) * 0.1)
    before = tf.mel_power.launches
    out = tf.mel_power(wav)
    assert tf.mel_power.launches == before
    torch.testing.assert_close(out, tf.mel_power_ref(wav), rtol=0, atol=0)
    assert tf.select_log_mel(torch.device("cpu")) is tm.log_mel_spectrogram
    assert tf.select_log_mel(torch.device("cuda")) is tf.log_mel_spectrogram_fused
