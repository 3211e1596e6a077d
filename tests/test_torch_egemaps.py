"""The port's eGeMAPS chain (``mertools_tpu_torch/ops/egemaps.py``) against
the JAX package's: the tables, the SHS scores, the Viterbi F0 path (a tone
with an octave jump, ragged rows), the functionals on the same contours,
and both levels on the shared seeded batch
(``test_torch_handcrafted.clip_batch``) through the set dispatcher the CLI
calls, so each JAX function compiles once at one (B, T)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import egemaps as je
from mertools_tpu.ops import handcrafted as jh
from mertools_tpu_torch.ops import egemaps as te
from mertools_tpu_torch.ops import handcrafted as th
from test_torch_handcrafted import TOL, T, assert_columns_close, clip_batch, to_torch, tone

torch.set_num_threads(1)

F0_COL = te.LLD_NAMES.index("F0semitone")
# The formant widths are 2 sqrt(3 / a), the curvature a of the LPC envelope
# (dB) at a peak floored at 1e-6, so a width stops at 3,464 Hz. The
# curvature is a second difference of an order-12 float32 Levinson envelope,
# ill-conditioned on harmonic spectra: most widths move by up to ~1e-2 of
# the column's max between the two FFT libraries, and at a flat envelope
# bump the curvature sits within the envelope's error (~3e-4 dB) of the
# floor, so one package clamps where the other does not and three smoothed
# frames move by up to a third of the cap (ROADMAP C3,
# test_formant_width_clamp_is_a_decision_without_margin). So F1bandwidth's
# frames are held at BW_TOL of its max on all but BW_FRAME_OFF of them (6 of
# 332 nonzero frames here, float or PCM16: two clamps), and the six width
# functionals at BW_UTT_TOL of their max.
BW_FRAME = te.LLD_NAMES.index("F1bandwidth")
BW_TOL = 1e-2
BW_FRAME_OFF = 0.03
BW_UTT = tuple(i for i, n in enumerate(te.EGEMAPS_NAMES) if "bandwidth" in n)
BW_UTT_TOL = 5e-2


@pytest.fixture(scope="module")
def runs():
    wav, lengths = clip_batch()
    x, n = to_torch(wav, lengths)
    jw, jn = jnp.asarray(wav), jnp.asarray(lengths)
    jf, jm = jh.handcrafted_frame(jw, jn, 16000, "eGeMAPS")
    return {"wav": wav, "lengths": lengths,
            "jax_frame": (np.asarray(jf), np.asarray(jm)),
            "jax_utt": np.asarray(jh.handcrafted_utt(jw, jn, 16000, "eGeMAPS")),
            "port_frame": tuple(a.numpy() for a in te.egemaps_frame(x, n)),
            "port_utt": te.egemaps_utt(x, n).numpy()}


def assert_frames_close(got, want):
    """(N, 23) valid frames: every column at TOL but F1bandwidth, held at
    BW_TOL on all but BW_FRAME_OFF of its nonzero frames (C3)."""
    rest = [c for c in range(want.shape[-1]) if c != BW_FRAME]
    assert_columns_close(got[:, rest], want[:, rest])
    w = want[:, BW_FRAME]
    off = np.abs(got[:, BW_FRAME] - w) > max(BW_TOL * float(np.abs(w).max()), 1e-6)
    assert off.sum() <= BW_FRAME_OFF * max((w != 0).sum(), 1), (int(off.sum()), len(off))


def assert_utt_close(got, want):
    rest = [c for c in range(want.shape[-1]) if c not in BW_UTT]
    assert_columns_close(got[:, rest], want[:, rest])
    assert_columns_close(got[:, BW_UTT], want[:, BW_UTT], tol=BW_UTT_TOL)


def test_tables_and_names_equal_jax():
    np.testing.assert_array_equal(te._gauss_win(te.WIN_P), je._gauss_win(je.WIN_P))
    np.testing.assert_array_equal(te._CAND_FREQS, je._CAND_FREQS)
    assert te.EGEMAPS_NAMES == je.EGEMAPS_NAMES and len(te.EGEMAPS_NAMES) == 88
    assert te.LLD_NAMES == je.LLD_NAMES and len(te.LLD_NAMES) == 23
    assert te.NZ_LLDS == je.NZ_LLDS
    # the SHS index and weight tables, as the matrix the JAX gather applies:
    # its scores of each unit spectrum are that matrix's rows, bit for bit
    eye = jnp.eye(te.NFFT_P // 2 + 1, dtype=jnp.float32)[None]
    np.testing.assert_array_equal(te.shs_matrix(), np.asarray(jax.jit(je._shs_scores)(eye))[0])


def test_semitone_table_is_the_reference_formula():
    """The F0 table equals ``12 log2(max(f, 1) / 27.5)`` as XLA fuses it to
    within one float32 ulp at every candidate, and to the bit at most."""
    want = np.asarray(jax.jit(lambda f: 12.0 * jnp.log2(jnp.maximum(f, 1.0) / 27.5))(
        jnp.asarray(je._CAND_FREQS)))
    got = te._cand_semitones()[:-1]
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.9, np.unique(ulps, return_counts=True)


def test_shs_scores_match_jax(runs):
    mag = np.abs(np.fft.rfft(runs["wav"][:2, :4 * 960].reshape(2, 4, 960),
                             n=te.NFFT_P)).astype(np.float32)
    assert_columns_close(te._shs_scores(*to_torch(mag)).numpy(),
                         jax.jit(je._shs_scores)(jnp.asarray(mag)))


def _pitch_inputs():
    """(shs, p_voiced, mask) of two tones through the port's 60 ms front end:
    150 Hz that jumps an octave to 300 Hz halfway, and 140 Hz ragged at
    1.2 s; the JAX Viterbi is fed the same arrays."""
    n = T
    jump = np.concatenate([tone(150.0, n // 2, 7), tone(300.0, n - n // 2, 8)])
    wav = np.stack([jump, np.pad(tone(140.0, 19200, 9), (0, n - 19200))])
    x = torch.from_numpy(wav)
    nF = te.n_frames(n)
    fr = te.frame_signal(x, nF, te.WIN_P, te.HOP) * torch.from_numpy(te._gauss_win(te.WIN_P))
    mag = torch.fft.rfft(fr, n=te.NFFT_P).abs()
    acf = torch.fft.irfft(mag ** 2, n=te.NFFT_P)
    p = (acf[..., 16:291] / (acf[..., :1] + 1e-12)).amax(-1).clamp(0, 1)
    mask = te.valid_frames(torch.tensor([n, 19200]), nF, te.WIN_P)
    return te._shs_scores(mag).numpy(), p.numpy(), mask.numpy()


def test_viterbi_path_matches_jax_across_an_octave_jump():
    shs, p, mask = _pitch_inputs()
    state = te._viterbi_f0(*to_torch(shs, p, mask)).numpy()
    want = np.asarray(jax.jit(je._viterbi_f0)(jnp.asarray(shs), jnp.asarray(p),
                                             jnp.asarray(mask)))
    np.testing.assert_array_equal(te._cand_hz()[state], want)
    f0 = want[0][mask[0]]
    half = len(f0) // 2
    assert abs(np.median(f0[:half - 5]) / 150.0 - 1) < 0.03
    assert abs(np.median(f0[half + 5:]) / 300.0 - 1) < 0.03
    # a row's frames past its mask point each state at itself
    last = int(mask[1].sum())
    assert (state[1, last:] == state[1, last - 1]).all()


def test_frame_level_matches_jax(runs):
    """23 LLDs on the valid frames; the mask and the voicing (F0 > 0) and
    the F0 contour equal."""
    (got, gmask), (want, wmask) = runs["port_frame"], runs["jax_frame"]
    assert got.shape == (6, te.n_frames(T), 23)
    np.testing.assert_array_equal(gmask, wmask)
    np.testing.assert_array_equal(gmask.sum(1), [195, 167, 95, 1, 1, 1])
    np.testing.assert_array_equal(got[..., F0_COL], want[..., F0_COL])
    assert (want[0][wmask[0]][:, F0_COL] > 0).mean() > 0.6
    assert_frames_close(got[gmask], want[wmask])


def test_utterance_level_matches_jax(runs):
    got, want = runs["port_utt"], runs["jax_utt"]
    assert got.shape == (6, 88) and np.isfinite(got).all()
    assert_utt_close(got, want)


def test_formant_width_clamp_is_a_decision_without_margin():
    """C3: a flat envelope bump whose curvature lies just above the 1e-6
    floor; moving one envelope point by 2e-4 dB (less than the envelope's
    error between FFT libraries) takes the reference's own width to the
    3,464 Hz cap, and the port's with it."""
    g = np.arange(te.ENV_GRID, dtype=np.float64)
    step = te.FMT_MAX_HZ / (te.ENV_GRID - 1)
    env = np.stack([-0.5 * 1.1e-3 * (g - 3) ** 2] * 2).astype(np.float32)[None]
    env[0, 1, 4] += 2e-4
    widths = [np.asarray(jax.jit(je._formant_peaks)(jnp.asarray(env))[1])[0, :, 0],
              te._formant_peaks(*to_torch(env))[1].numpy()[0, :, 0]]
    for w in widths:
        assert w[0] < 3400.0 and abs(w[1] - 2 * np.sqrt(3 / 1e-6)) < 1.0, (w, step)
    np.testing.assert_allclose(widths[1], widths[0], rtol=1e-5)


def test_lpc_and_formant_stages_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 320)).astype(np.float32)
    acf = np.fft.irfft(np.abs(np.fft.rfft(x, 512)) ** 2, 512)[:, :13].astype(np.float32)
    assert_columns_close(te._lpc_batched(*to_torch(acf)).numpy(),
                         jax.jit(je._lpc_batched)(jnp.asarray(acf)))
    env = rng.normal(size=(2, 30, te.ENV_GRID)).cumsum(-1).astype(np.float32)
    for got, want in zip(te._formant_peaks(*to_torch(env)),
                         jax.jit(je._formant_peaks)(jnp.asarray(env))):
        assert_columns_close(got.numpy(), want)


def test_functionals_match_jax():
    """Percentiles (masked sort, +inf past the mask), slopes, segment
    statistics and the run lengths' closed form, on seeded contours with
    ragged masks, a row with one valid frame and a row with none."""
    rng = np.random.default_rng(3)
    F = 60
    x = rng.normal(size=(4, F)).astype(np.float32).cumsum(1)
    x[:, 20:30] = 0.0
    mask = np.arange(F)[None] < np.array([[F], [41], [1], [0]])
    seg = (rng.random((4, F)) > 0.4) & mask
    m = mask.astype(np.float32)
    xt, mt, segt, maskt = to_torch(x, m, seg, mask)

    @jax.jit
    def reference(x, m, seg, mask):
        return (je._percentiles(x, m, (0.2, 0.5, 0.8)), je._slope_stats(x, m) + je._mean_cv(x, m),
                je._run_length(seg), je._seg_stats(seg, mask))

    pct, stats, runs, segs = reference(x, m, seg, mask)
    for got, want in zip(te._percentiles(xt, mt, (0.2, 0.5, 0.8)), pct):
        assert_columns_close(got.numpy()[:, None], np.asarray(want)[:, None])
    for got, want in zip(te._slope_stats(xt, mt) + te._mean_cv(xt, mt), stats):
        assert_columns_close(got.numpy()[:, None], np.asarray(want)[:, None])
    np.testing.assert_array_equal(te.run_length(segt).numpy(), np.asarray(runs))
    for got, want in zip(te._seg_stats(segt, maskt), segs):
        assert_columns_close(got.numpy()[:, None], np.asarray(want)[:, None])


def test_a_padded_row_equals_the_clip_alone(runs):
    """Pad-length invariance for clips of at least one 60 ms frame."""
    wav, lengths = runs["wav"], runs["lengths"]
    frame, mask = runs["port_frame"]
    for i in np.flatnonzero(lengths >= te.WIN_P):
        x, n = to_torch(wav[i:i + 1, :lengths[i]], lengths[i:i + 1])
        f, m = te.egemaps_frame(x, n)
        np.testing.assert_array_equal(f[0, :, F0_COL].numpy(), frame[i][mask[i]][:, F0_COL])
        assert_frames_close(f[0][m[0]].numpy(), frame[i][mask[i]])
        assert_utt_close(te.egemaps_utt(x, n).numpy(), runs["port_utt"][i:i + 1])


def test_dispatcher_is_the_chain(runs):
    x, n = to_torch(runs["wav"], runs["lengths"])
    np.testing.assert_array_equal(th.handcrafted_frame(x, n, 16000, "eGeMAPS")[0].numpy(),
                                  runs["port_frame"][0])
    np.testing.assert_array_equal(th.handcrafted_utt(x, n, 16000, "eGeMAPS").numpy(),
                                  runs["port_utt"])
