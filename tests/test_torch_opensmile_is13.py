"""The port's openSMILE IS13 ComParE chain (``mertools_tpu_torch/ops/
opensmile_is13.py``) against the JAX package's on the shared seeded batch
(``test_torch_handcrafted.clip_batch``), so each JAX function compiles once
at one (B, T): the names and RASTA, the 120 frame columns, the functional
engine on JAX's own contours, the 6,372 functionals (held by
``hc_gates.hc_explain``, the rule ``chip_smoke.py`` holds the card to), a
ragged batch against each clip alone, and the dispatcher."""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import handcrafted as jh
from mertools_tpu.ops import opensmile_is09 as j9
from mertools_tpu.ops import opensmile_is13 as j13
from mertools_tpu_torch.ops import handcrafted as th
from mertools_tpu_torch.ops import opensmile_is09 as t9
from mertools_tpu_torch.ops import opensmile_is13 as t13
from hc_gates import HC_LP_FUNCS, HC_RAGGED_TOL, hc_block_accounts, hc_explain, hc_gate
from test_torch_handcrafted import TOL, assert_columns_close, clip_batch, to_torch

torch.set_num_threads(1)

_JCF = jax.jit(j13.contour_functionals, static_argnums=2)


def jax_engine(x, mask, funcs):
    """The JAX package's IS13 functionals of one block of contours."""
    return np.asarray(_JCF(jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()), funcs))


@pytest.fixture(scope="module")
def runs():
    wav, lengths = clip_batch()
    x, n = to_torch(wav, lengths)
    jw, jn = jnp.asarray(wav), jnp.asarray(lengths)
    llds, voiced, mask = j13._lld_core(jw, jn)
    # is13_frame: the 60 contours, then their deltas
    x60 = jnp.stack([llds[k] for k in j13.FRAME_LLDS], -1)
    de = jax.jit(j9._delta2)(x60, jnp.sum(mask.astype(jnp.int32), 1))
    parts = t13._lld_core(x, n)
    return {"wav": wav, "lengths": lengths,
            "jax_frame": (np.concatenate([np.asarray(x60), np.asarray(de)], -1), np.asarray(mask)),
            "jax_utt": np.asarray(jh.handcrafted_utt(jw, jn, 16000, "IS13")),
            "jax_parts": ({k: torch.from_numpy(np.array(v)) for k, v in llds.items()},
                          torch.from_numpy(np.array(voiced)), torch.from_numpy(np.array(mask))),
            "port_parts": parts,
            "port_frame": tuple(a.numpy() for a in t13.is13_frame(x, n)),
            "port_utt": t13.utt_functionals(*parts).numpy()}


def test_names_semitones_and_rasta_match_jax(runs):
    assert t13.IS13_NAMES == j13.IS13_NAMES and len(t13.IS13_NAMES) == 6372
    assert (t13.FUNCS_A, t13.FUNCS_A_DE, t13.FUNCS_B, t13.FUNCS_B_DE, t13.TEMPORAL_22) == (
        j13.FUNCS_A, j13.FUNCS_A_DE, j13.FUNCS_B, j13.FUNCS_B_DE, j13.TEMPORAL_22)
    assert t13.FRAME_LLDS == j13.FRAME_LLDS and t13.VOICING_LLDS == j13.VOICING_LLDS
    # the semitones of the smoothed F0 as XLA fuses 12 log2(max(f, 1) / 27.5):
    # within two float32 ulps (the two libraries' ln), most to the bit
    f = np.linspace(40.0, 700.0, 4001).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: 12.0 * jnp.log2(jnp.maximum(v, 1.0) / 27.5))(f))
    ulps = np.abs(t13.semitones(torch.from_numpy(f)).numpy().view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.5, np.unique(ulps, return_counts=True)
    # RASTA on the batch's log auditory bands, masked (its frame loop)
    llds = runs["port_parts"][0]
    logaud = np.random.default_rng(3).normal(size=(6, 198, 26)).astype(np.float32) - 10.0
    mask = runs["jax_frame"][1]
    assert_columns_close(t13._rasta(*to_torch(logaud, mask)).numpy(),
                         jax.jit(j13._rasta)(jnp.asarray(logaud), jnp.asarray(mask)))
    assert set(llds) == set(t13.ENERGY_LLDS + t13.SPECTRAL_LLDS + t13.VOICING_LLDS)


def test_frame_level_matches_jax(runs):
    """120 columns within 2e-4 of each column's max; the masks equal."""
    (got, gmask), (want, wmask) = runs["port_frame"], runs["jax_frame"]
    assert got.shape == (6, 1 + (32000 - 400) // 160, 120)
    np.testing.assert_array_equal(gmask, wmask)
    assert_columns_close(got[gmask], want[wmask])


def test_contour_functionals_match_jax_on_the_same_contours(runs):
    """The functional engine fed JAX's own contours: every column within
    2e-4 of its max, or off it by an account of ``hc_explain``: 154 order-5
    LP coefficients of near-singular Toeplitz systems ("lp": within
    HC_LP_SLACK kappa eps32 of JAX's), and an upleveltime tie, which the two
    engines round apart (XLA fuses min + q range)."""
    accounts = []
    for block in t13.functional_blocks(*runs["jax_parts"]):
        x, mask, funcs = block
        got = t13.block_functionals(x, mask, funcs).numpy()
        want = jax_engine(x, mask, funcs)
        allowed = np.broadcast_to(np.maximum(TOL * np.abs(want).max(0), 1e-6), want.shape)
        accounts += [(funcs[j % len(funcs)], how) for _, j, how, _ in hc_block_accounts(
            got, want, block, block, jax_engine, allowed, "engine")]
    lp = {f: sum(1 for a in accounts if a == (f, "lp")) for f in HC_LP_FUNCS}
    assert lp == {"lpgain": 0, "lpc0": 21, "lpc1": 35, "lpc2": 46, "lpc3": 26, "lpc4": 26}
    # jitterLocal's delta on the 380 Hz tone takes a few levels
    assert [a for a in accounts if a[1] != "lp"] == [("upleveltime75", "tie")]


# IS13 utterance entries off 2e-4 of JAX's, with their accounts. Clip 0 is
# the 140 Hz tone with 0.3 s of digital silence: there the MFCCs are a DCT
# of a constant log floor, rounding noise whose sign and log decide
# posamean and flatness (as the spectral slope's), and the slopes and
# curvtime of quantized deltas split on float32 zeros. The engines agree
# on each of these given the port's contours ("contours"); the LP columns
# are "lp" or "contours"; one upleveltime tie.
_MFCC_POSAMEAN = (3, 4, 5, 8, 9, 10, 11, 12, 13)
UTT_CONTOURS = {
    0: ({f"pcm_fftMag_mfcc{k}_sma_flatness" for k in range(1, 15)}
        | {f"pcm_fftMag_mfcc{k}_sma_posamean" for k in _MFCC_POSAMEAN}
        | {"spectralSlope_sma_flatness", "spectralSlope_sma_posamean",
           "F0final_sma_de_stddevRisingSlope", "pcm_zcr_sma_de_curvtime",
           "pcm_zcr_sma_de_stddevFallingSlope", "spectralRollOff25.0_sma_de_stddevFallingSlope",
           "spectralRollOff25.0_sma_de_stddevRisingSlope",
           "spectralRollOff50.0_sma_de_stddevFallingSlope",
           "spectralRollOff90.0_sma_de_stddevRisingSlope",
           "audSpec_Rfilt0_sma_lpc0", "audSpec_Rfilt10_sma_lpc0", "audSpec_Rfilt10_sma_lpc1",
           "audSpec_Rfilt16_sma_lpc0", "audSpec_Rfilt17_sma_lpc0", "audSpec_Rfilt17_sma_lpc4",
           "audspec_lengthL1norm_sma_lpc2", "spectralCentroid_sma_lpc1",
           "spectralEntropy_sma_lpc1", "spectralEntropy_sma_lpc2"}),
    1: {"pcm_fftMag_mfcc3_sma_de_flatness", "spectralEntropy_sma_de_flatness",
        "spectralHarmonicity_sma_de_flatness", "spectralRollOff25.0_sma_de_stddevFallingSlope",
        "spectralRollOff25.0_sma_de_stddevRisingSlope",
        "spectralRollOff50.0_sma_de_stddevFallingSlope",
        "spectralRollOff50.0_sma_de_stddevRisingSlope", "spectralRollOff90.0_sma_de_curvtime",
        "audSpec_Rfilt16_sma_lpc3", "audSpec_Rfilt24_sma_lpc4", "spectralEntropy_sma_lpc2",
        "spectralHarmonicity_sma_lpc2"},
    2: {"spectralRollOff50.0_sma_de_curvtime", "spectralRollOff90.0_sma_de_stddevRisingSlope",
        "audSpec_Rfilt22_sma_lpc4"}}
UTT_LP = {0: 126, 1: 7, 2: 8}     # "lp" entries a clip
# sha256 of the sorted (column, clip, account) entries: the set exactly
UTT_DIGEST = "dcff1b42474afacd572e632a18e029fd1a4a488f5189f3ab59d035a7b14cc4f8"


def test_utterance_level_matches_jax(runs):
    """6,372 functionals within 2e-4 of each column's max (skewness and
    kurtosis on their unit scale), or off it, on the entries pinned above,
    for an account of ``hc_explain``: JAX's engine gives the port's value on
    the port's contours, an LP column within HC_LP_SLACK kappa eps32 of
    JAX's, or an upleveltime tie; the contours within 2e-4 first."""
    got, want = runs["port_utt"], runs["jax_utt"]
    assert got.shape == (6, 6372) and np.isfinite(got).all()
    worst, explained = hc_explain(
        "IS13", got, want, t13.functional_blocks(*runs["port_parts"]),
        t13.functional_blocks(*runs["jax_parts"]), jax_engine, TOL, "port vs JAX")
    assert worst <= 1.0
    entries = sorted((name, clip, how) for name, clip, how, *_ in explained)
    for clip, names in UTT_CONTOURS.items():
        assert {n for n, c, how in entries if c == clip and how == "contours"} == names, clip
    assert {c: sum(1 for e in entries if e[1:] == (c, "lp")) for c in range(6)} == {
        **dict.fromkeys(range(6), 0), **UTT_LP}
    assert all(n.rsplit("_", 1)[1] in HC_LP_FUNCS for n, _, how in entries if how == "lp")
    assert [e for e in entries if e[2] not in ("contours", "lp")] == [
        ("jitterLocal_sma_de_upleveltime75", 1, "tie")]
    assert hashlib.sha256(repr(entries).encode()).hexdigest() == UTT_DIGEST


def test_a_padded_row_equals_the_clip_alone(runs):
    """Each clip of at least one frame, run alone at its exact length, gives
    the rows the bucket gave it: frames and functionals within 1e-5 of the
    clip's max |value| (phase 21's ragged gate)."""
    wav, lengths = runs["wav"], runs["lengths"]
    frame, mask = runs["port_frame"]
    utt = runs["port_utt"]
    for i in np.flatnonzero(lengths >= t9.FRAME_LEN):
        x, n = to_torch(wav[i:i + 1, :lengths[i]], lengths[i:i + 1])
        f, m = t13.is13_frame(x, n)
        alone = f[0][m[0]].numpy()
        hc_gate("IS13", "FRAME", {"c": frame[i][mask[i]]}, {"c": alone}, HC_RAGGED_TOL,
                "ragged", float(np.abs(alone).max()))
        alone = t13.is13_utt(x, n)[0].numpy()
        hc_gate("IS13", "UTTERANCE", {"c": utt[i]}, {"c": alone}, HC_RAGGED_TOL, "ragged",
                float(np.abs(alone).max()))


def test_dispatcher_is_the_chain(runs):
    """Each level, and both from one contour pass, bit for bit."""
    x, n = to_torch(runs["wav"], runs["lengths"])
    f, _ = th.handcrafted_frame(x, n, 16000, "IS13")
    np.testing.assert_array_equal(f.numpy(), runs["port_frame"][0])
    np.testing.assert_array_equal(th.handcrafted_utt(x, n, 16000, "IS13").numpy(),
                                  runs["port_utt"])
    utt, f, m = th.handcrafted_levels(x, n, 16000, "IS13")
    np.testing.assert_array_equal(utt.numpy(), runs["port_utt"])
    np.testing.assert_array_equal(f.numpy(), runs["port_frame"][0])
    np.testing.assert_array_equal(m.numpy(), runs["port_frame"][1])
    with pytest.raises(ValueError, match="16000 Hz"):
        th.handcrafted_frame(x, n, 8000, "IS13")
