"""The port's openSMILE IS09 chain (``mertools_tpu_torch/ops/
opensmile_is09.py``) against the JAX package's on the shared seeded batch
(``test_torch_handcrafted.clip_batch``: tones, silence, noise, one frame,
less than a frame), through the set dispatcher the CLI calls, so each JAX
function compiles once at one (B, T)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import handcrafted as jh
from mertools_tpu.ops import opensmile_is09 as j9
from mertools_tpu_torch.ops import handcrafted as th
from mertools_tpu_torch.ops import opensmile_is09 as t9
from test_torch_handcrafted import assert_columns_close, clip_batch, to_torch

torch.set_num_threads(1)

FUNCS = len(t9.FUNCTIONALS)
# the discrete outputs: voiceProb > 0.55 decides F0 (column 3 of the 16
# LLDs, before smoothing); maxPos / minPos are frame indices
POS_COLS = [c * FUNCS + f for c in range(32) for f in (3, 4)]
# skewness and kurtosis are ratios of central moments: on a near-constant
# contour (a steady tone's F0, from a few discrete lags) x - mean cancels,
# so a 1-ulp difference in x or in the order of a sum moves them by ~1e-4
# (3.3e-5 on the 380 Hz tone's F0 from the same contours); they are held
# on their own unit scale, |moment| floored at 1
MOMENTS = {c * FUNCS + f: 1.0 for c in range(32) for f in (10, 11)}


@pytest.fixture(scope="module")
def runs():
    wav, lengths = clip_batch()
    x, n = to_torch(wav, lengths)
    jf, jm = jh.handcrafted_frame(jnp.asarray(wav), jnp.asarray(lengths), 16000, "IS09")
    return {"wav": wav, "lengths": lengths,
            "jax_frame": (np.asarray(jf), np.asarray(jm)),
            "jax_utt": np.asarray(jh.handcrafted_utt(jnp.asarray(wav), jnp.asarray(lengths),
                                                     16000, "IS09")),
            "port_frame": tuple(a.numpy() for a in t9.is09_frame(x, n)),
            "port_utt": t9.is09_utt(x, n).numpy()}


def test_tables_equal_jax():
    np.testing.assert_array_equal(t9.hamming(400), j9.hamming(400))
    np.testing.assert_array_equal(t9.htk_mel_bank(), j9.htk_mel_bank())
    np.testing.assert_array_equal(t9.htk_mel_bank(16000, 512, 26, 20.0, 8000.0),
                                  j9.htk_mel_bank(16000, 512, 26, 20.0, 8000.0))
    np.testing.assert_array_equal(t9.htk_dct_lifter(), j9.htk_dct_lifter())
    np.testing.assert_array_equal(t9.htk_dct_lifter(4, 26), j9.htk_dct_lifter(4, 26))
    assert t9.LLD_NAMES == j9.LLD_NAMES and t9.FUNCTIONALS == j9.FUNCTIONALS


def test_names_count_the_csv_columns():
    assert len(t9.FRAME_NAMES) == 32 and len(set(t9.FRAME_NAMES)) == 32
    assert len(t9.UTT_NAMES) == 384 and len(set(t9.UTT_NAMES)) == 384
    assert t9.FRAME_NAMES[3] == "F0_sma" and t9.FRAME_NAMES[16] == "pcm_RMSenergy_sma_de"
    assert t9.UTT_NAMES[:2] == ("pcm_RMSenergy_sma_max", "pcm_RMSenergy_sma_min")


def test_frame_level_matches_jax(runs):
    """32 contours within 2e-4 of each column's max; the frame mask
    (complete frames, at least one) and the voicing decision equal."""
    (got, gmask), (want, wmask) = runs["port_frame"], runs["jax_frame"]
    assert got.shape == (6, 1 + (32000 - 400) // 160, 32)
    np.testing.assert_array_equal(gmask, wmask)
    np.testing.assert_array_equal(gmask.sum(1), [198, 170, 98, 4, 1, 1])
    np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
    assert (want[1][wmask[1]][:, 3] > 0).mean() > 0.9     # the 380 Hz tone is voiced
    assert_columns_close(got[gmask], want[wmask])


def test_utterance_level_matches_jax(runs):
    """384 functionals within 2e-4 of each column's max; maxPos / minPos
    (first occurrence, frame indices) equal."""
    got, want = runs["port_utt"], runs["jax_utt"]
    assert got.shape == (6, 384) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, POS_COLS], want[:, POS_COLS])
    assert_columns_close(got, want, floor=MOMENTS)


def test_functionals_on_the_same_contours_match_jax(runs):
    """The functional grid alone, fed JAX's own frame contours."""
    want_frame, mask = runs["jax_frame"]
    got = t9.functionals_12(*to_torch(want_frame, mask)).numpy()
    want = np.asarray(jax.jit(j9.functionals_12)(jnp.asarray(want_frame), jnp.asarray(mask)))
    np.testing.assert_array_equal(got[:, POS_COLS], want[:, POS_COLS])
    assert_columns_close(got, want, floor=MOMENTS)


def test_a_padded_row_equals_the_clip_alone(runs):
    """Pad-length invariance: each clip of at least one frame, run alone
    at its exact length, gives the rows the bucket gave it. (A clip shorter
    than a frame reads its buffer past its end, zeros in a bucket and its
    last sample alone, in both packages.)"""
    wav, lengths = runs["wav"], runs["lengths"]
    frame, mask = runs["port_frame"]
    for i in np.flatnonzero(lengths >= t9.FRAME_LEN):
        L = lengths[i]
        x, n = to_torch(wav[i:i + 1, :L], lengths[i:i + 1])
        f, m = t9.is09_frame(x, n)
        assert int(m.sum()) == int(mask[i].sum())
        np.testing.assert_allclose(f[0][m[0]].numpy(), frame[i][mask[i]], rtol=0, atol=1e-5 * max(
            1.0, float(np.abs(frame[i][mask[i]]).max())))
        np.testing.assert_allclose(t9.is09_utt(x, n)[0].numpy(), runs["port_utt"][i], rtol=1e-4,
                                   atol=1e-5)


def test_dispatcher_is_the_chain(runs):
    x, n = to_torch(runs["wav"], runs["lengths"])
    f, m = th.handcrafted_frame(x, n, 16000, "IS09")
    np.testing.assert_array_equal(f.numpy(), runs["port_frame"][0])
    np.testing.assert_array_equal(th.handcrafted_utt(x, n, 16000, "IS09").numpy(),
                                  runs["port_utt"])
