"""The port's librosa features and set dispatchers
(``mertools_tpu_torch/ops/handcrafted.py``) against the JAX package's, on
one seeded batch: vibrato tones at 20 dB SNR with a silent gap, a
noise-only clip, and clips of one frame and shorter than one, ragged in
one (6, 32000) buffer, so each JAX function compiles once. The batch and
the comparison are shared with the IS09, eGeMAPS and CLI files."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import handcrafted as jh
from mertools_tpu_torch.ops import handcrafted as th

torch.set_num_threads(1)

SR = 16000
T = 2 * SR                      # the CLI's 2 s bucket
LENGTHS = (T, 27531, 16000, 960, 400, 300)
TOL = 2e-4   # max |port - JAX| <= TOL * max |JAX| of each column, or 1e-6


def tone(f0, n, seed, snr_db=20.0, vibrato=0.02):
    """A harmonic tone (8 partials at 0.6^k) with 5 Hz vibrato and white
    noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + vibrato * np.sin(2 * np.pi * 5 * t))) / SR
    x = sum(0.6 ** k * np.sin((k + 1) * phase) for k in range(8))
    x = 0.3 * x / np.abs(x).max()
    noise = rng.normal(size=n) * np.sqrt(np.mean(x ** 2) / 10 ** (snr_db / 10))
    return (x + noise).astype(np.float32)


def clip_batch(seed=0):
    """(6, T) float32 and (6,) lengths: a 2 s tone at 140 Hz with 0.3 s of
    silence inside, a ragged tone at 380 Hz, 1 s of noise only, then clips
    of one eGeMAPS frame (960), one IS09 frame (400) and 300 samples. IS09's
    voicing (ACF ratio > 0.55) holds the 140 Hz tone unvoiced and the 380
    Hz one voiced, each at least 0.1 from the cutoff."""
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(LENGTHS), T), np.float32)
    wav[0] = tone(140.0, T, seed)
    wav[0, 12000:16800] = 0.0
    wav[1, :LENGTHS[1]] = tone(380.0, LENGTHS[1], seed + 1)
    for i in (2, 3, 4, 5):
        wav[i, :LENGTHS[i]] = rng.normal(size=LENGTHS[i]) * 0.05
    return wav, np.asarray(LENGTHS, np.int64)


def assert_columns_close(got, want, tol=TOL, floor=None):
    """Each column (last axis) within ``tol`` of its max |JAX| (or of
    ``floor[column]``, a dict, where that is larger), and never held
    tighter than 1e-6."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    for c in range(w.shape[1]):
        scale = max(float(np.abs(w[:, c]).max()), (floor or {}).get(c, 0.0))
        err = float(np.abs(g[:, c] - w[:, c]).max())
        assert err <= max(tol * scale, 1e-6), (c, err, scale)


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def batch():
    return clip_batch()


def test_tables_equal_jax():
    for n in (400, 401, 2048):
        np.testing.assert_array_equal(th.hann(n), jh.hann(n))
        np.testing.assert_array_equal(th.hann(n, periodic=False), jh.hann(n, periodic=False))
    for sr, n_fft, n_mels in ((16000, 2048, 128), (22050, 2048, 128), (16000, 512, 40)):
        np.testing.assert_array_equal(th.mel_filter_bank_librosa(sr, n_fft, n_mels),
                                      jh.mel_filter_bank_librosa(sr, n_fft, n_mels))
    np.testing.assert_array_equal(th.dct_matrix(40, 128), jh.dct_matrix(40, 128))


@pytest.mark.parametrize("n,pad", [(32000, 1024), (300, 1024), (5, 3), (2, 7), (1, 4)])
def test_reflect_padding_is_numpys(n, pad):
    """The centre padding repeats its reflection where the buffer is
    shorter than the pad, as ``jnp.pad(mode="reflect")`` does."""
    x = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(x[th.reflect_index(n, pad)], np.pad(x, pad, mode="reflect"))


@pytest.mark.parametrize("fn", ["mel_spec_librosa", "mfcc_librosa"])
def test_librosa_features_match_jax(batch, fn):
    wav, _ = batch
    want = np.asarray(getattr(jh, fn)(jnp.asarray(wav), SR))
    got = getattr(th, fn)(*to_torch(wav), SR).numpy()
    assert got.shape == (len(wav), T // 160 + 1, 128 if fn == "mel_spec_librosa" else 120)
    assert_columns_close(got, want)


def test_delta_and_framing_helpers_match_jax():
    x = np.random.default_rng(5).normal(size=(3, 17, 4)).astype(np.float32)
    assert_columns_close(th.delta_sg(*to_torch(x), dim=1).numpy(),
                         jax.jit(jh.delta_sg, static_argnames="axis")(jnp.asarray(x), axis=1))
    w = np.random.default_rng(6).normal(size=(2, 1000)).astype(np.float32)
    frames = jax.jit(jh.frame_signal, static_argnums=(1, 2))
    for n, L, hop in ((1000, 400, 160), (1000, 1200, 160), (1000, 1000, 100)):
        np.testing.assert_array_equal(th.frame_signal(*to_torch(w[:, :n]), L, hop).numpy(),
                                      np.asarray(frames(jnp.asarray(w[:, :n]), L, hop)))
    lengths = np.array([0, 399, 400, 560, 1000])
    np.testing.assert_array_equal(
        th.frame_mask(*to_torch(lengths), 5, 400, 160).numpy(),
        np.asarray(jax.jit(jh.frame_mask, static_argnums=(1, 2, 3))(jnp.asarray(lengths),
                                                                   5, 400, 160)))


def test_mfcc_floor_is_the_batch_max_in_both_packages(batch):
    """``power_to_db`` floors at the whole batch's max - 80 dB: a quiet
    clip's MFCCs change when a loud clip shares its batch, in the JAX
    package and in the port alike (librosa floors each clip alone)."""
    wav, _ = batch
    quiet = np.zeros_like(wav)
    quiet[0] = wav[2] * 1e-3            # noise at -66 dB of the loud tone
    loud = quiet.copy()
    loud[1] = wav[0]
    outs = {}
    for name, w in (("alone", quiet), ("beside", loud)):
        want = np.asarray(jh.mfcc_librosa(jnp.asarray(w), SR))
        got = th.mfcc_librosa(*to_torch(w), SR).numpy()
        assert_columns_close(got, want)
        outs[name] = got[0]
    assert np.abs(outs["alone"] - outs["beside"]).max() > 1.0


def test_dispatchers_route_the_sets_and_name_a10b(batch):
    """Every openSMILE set routes to its chain, IS10 and IS13 (ROADMAP A10b)
    included, at the reference's frame and utterance widths; an unknown set
    or another rate is refused."""
    wav, lengths = batch
    x, n = to_torch(wav[:2, :4000], np.minimum(lengths[:2], 4000))
    for fs in ("IS09", "IS10", "IS13", "eGeMAPS"):
        f, mask = th.handcrafted_frame(x, n, 16000, fs)
        assert f.shape[-1] == th.FRAME_DIMS[fs] and mask.shape == f.shape[:2]
        assert th.handcrafted_utt(x, n, 16000, fs).shape == (2, th.UTT_DIMS[fs])
    assert th.FRAME_DIMS == jh.FRAME_DIMS and th.UTT_DIMS == jh.UTT_DIMS
    with pytest.raises(ValueError, match="IS11"):
        th.handcrafted_frame(x, n, 16000, "IS11")
    with pytest.raises(ValueError, match="16000 Hz"):
        th.handcrafted_utt(x, n, 22050, "IS09")
