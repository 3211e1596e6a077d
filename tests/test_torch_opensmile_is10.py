"""The port's openSMILE IS10 chain (``mertools_tpu_torch/ops/
opensmile_is10.py``) against the JAX package's on the shared seeded batch
(``test_torch_handcrafted.clip_batch``), so each JAX function compiles once
at one (B, T): the tables and names, the frame contours, the voicing
decision's margins, the 1,582 functionals (held by ``hc_gates.hc_explain``,
the rule ``chip_smoke.py`` holds the card to), a ragged batch against each
clip alone, and the dispatcher."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import egemaps as je
from mertools_tpu.ops import handcrafted as jh
from mertools_tpu.ops import opensmile_is10 as j10
from mertools_tpu_torch.ops import egemaps as te
from mertools_tpu_torch.ops import handcrafted as th
from mertools_tpu_torch.ops import opensmile_is09 as t9
from mertools_tpu_torch.ops import opensmile_is10 as t10
from hc_gates import HC_RAGGED_TOL, hc_explain, hc_gate
from test_torch_handcrafted import TOL, assert_columns_close, clip_batch, to_torch

torch.set_num_threads(1)

# min |voicing - 0.70| over each clip's valid frames, and its voiced frames:
# every decision of the batch sits at least 0.0136 from the cutoff
MARGINS = (0.0736, 0.163, 0.1076, 0.3794, 0.0136, 0.0278)
VOICED = (166, 170, 0, 0, 0, 1)


def jax_engine(x, mask, funcs):
    """The JAX package's IS10 functionals of one block of contours."""
    return np.asarray(_J21(jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()),
                           funcs == j10.FUNCTIONALS_19))


_J21 = jax.jit(j10.functionals_21, static_argnums=2)


def as_torch(parts):
    return tuple(torch.from_numpy(np.array(a)) for a in parts)


@pytest.fixture(scope="module")
def runs():
    wav, lengths = clip_batch()
    x, n = to_torch(wav, lengths)
    jw, jn = jnp.asarray(wav), jnp.asarray(lengths)
    jax_parts = j10._lld_core(jw, jn)        # is10_frame is its first 32 contours
    parts = t10._lld_core(x, n)
    return {"wav": wav, "lengths": lengths,
            "jax_frame": (np.asarray(jax_parts[0])[..., :32], np.asarray(jax_parts[3])),
            "jax_utt": np.asarray(jh.handcrafted_utt(jw, jn, 16000, "IS10")),
            "jax_parts": as_torch(jax_parts),
            "port_parts": parts,
            "port_frame": tuple(a.numpy() for a in t10.is10_frame(x, n)),
            "port_utt": t10.utt_functionals(*parts).numpy()}


def test_tables_and_names_equal_jax():
    assert t10.IS10_NAMES == j10.IS10_NAMES and len(t10.IS10_NAMES) == 1582
    assert t10.FUNCTIONALS_21 == j10.FUNCTIONALS_21 and t10.LLD_STD == j10.LLD_STD
    assert t10.LLD_PITCH == j10.LLD_PITCH and t10.LLD_FRAME == j10.LLD_FRAME
    np.testing.assert_array_equal(te.cand_freqs(t10.GRID), j10._CAND)
    # the SHS matrix on IS10's grid is the JAX gather's rows, bit for bit
    eye = jnp.eye(t10.NFFT_P // 2 + 1, dtype=jnp.float32)[None]
    shs = jax.jit(lambda m: je._shs_scores(m, cand_freqs=j10._CAND, nfft=j10.NFFT_P))
    np.testing.assert_array_equal(te.shs_matrix(t10.GRID), np.asarray(shs(eye))[0])
    # the sample-and-hold equals the frame-by-frame hold
    f0 = np.array([[0, 0, 110, 0, 0, 120, 130, 0], [90, 0, 0, 0, 0, 0, 0, 95]], np.float32)
    hold, e = np.zeros_like(f0), np.zeros(2, np.float32)
    for t in range(f0.shape[1]):
        e = np.where(f0[:, t] > 0, f0[:, t], e)
        hold[:, t] = e
    np.testing.assert_array_equal(t10.sample_and_hold(torch.from_numpy(f0)).numpy(), hold)


def test_frame_level_matches_jax(runs):
    """32 contours within 2e-4 of each column's max; the masks equal."""
    (got, gmask), (want, wmask) = runs["port_frame"], runs["jax_frame"]
    assert got.shape == (6, 1 + (32000 - 400) // 160, 32)
    np.testing.assert_array_equal(gmask, wmask)
    assert_columns_close(got[gmask], want[wmask])


def test_voicing_decision_has_margin(runs):
    """The voicing cutoff (0.70 on the unclipped 60 ms ACF maximum) sits at
    least 0.0136 from every valid frame's value, so no decision of the batch
    is within float error; the voiced frames equal JAX's."""
    wav, lengths = runs["wav"], runs["lengths"]
    x, n = to_torch(wav, lengths)
    mask = t9.valid_frames(n, t9.n_frames(x.shape[1]), t9.FRAME_LEN)
    _, voiced, p, *_ = t10.pitch_branch(x, n, mask)
    for b in range(len(lengths)):
        margin = float((p[b][mask[b]] - t10.VOICING_CUTOFF).abs().min())
        assert margin == pytest.approx(MARGINS[b], abs=1e-4), (b, margin)
    np.testing.assert_array_equal(voiced.sum(1).numpy(), VOICED)
    # after smoothing, the pitch group's voiced frames are JAX's
    np.testing.assert_array_equal(runs["port_parts"][2].numpy(), runs["jax_parts"][2].numpy())


def test_utterance_level_matches_jax(runs):
    """1,582 functionals within 2e-4 of each column's max (skewness and
    kurtosis on their unit scale), or off it for an account of
    ``hc_explain`` (JAX's engine gives the port's value on the port's
    contours, an upleveltime tie); the contours within 2e-4 first."""
    got, want = runs["port_utt"], runs["jax_utt"]
    assert got.shape == (6, 1582) and np.isfinite(got).all()
    worst, explained = hc_explain(
        "IS10", got, want, t10.functional_blocks(*runs["port_parts"]),
        t10.functional_blocks(*runs["jax_parts"]), jax_engine, TOL, "port vs JAX")
    assert worst <= 1.0
    # the one decision at a tie: jitterLocal's delta on the 380 Hz tone
    # takes a few levels, and min + 0.75 range lands on one of them
    assert [e[:3] for e in explained] == [("jitterLocal_sma_de_upleveltime75", 1, "tie")]


def test_a_padded_row_equals_the_clip_alone(runs):
    """Each clip of at least one frame, run alone at its exact length, gives
    the rows the bucket gave it: frames and functionals within 1e-5 of the
    clip's max |value| (phase 21's ragged gate)."""
    wav, lengths = runs["wav"], runs["lengths"]
    frame, mask = runs["port_frame"]
    utt = runs["port_utt"]
    for i in np.flatnonzero(lengths >= t9.FRAME_LEN):
        x, n = to_torch(wav[i:i + 1, :lengths[i]], lengths[i:i + 1])
        f, m = t10.is10_frame(x, n)
        alone = f[0][m[0]].numpy()
        hc_gate("IS10", "FRAME", {"c": frame[i][mask[i]]}, {"c": alone}, HC_RAGGED_TOL,
                "ragged", float(np.abs(alone).max()))
        alone = t10.is10_utt(x, n)[0].numpy()
        hc_gate("IS10", "UTTERANCE", {"c": utt[i]}, {"c": alone}, HC_RAGGED_TOL, "ragged",
                float(np.abs(alone).max()))


def test_dispatcher_is_the_chain(runs):
    """Each level, and both from one contour pass, bit for bit."""
    x, n = to_torch(runs["wav"], runs["lengths"])
    f, _ = th.handcrafted_frame(x, n, 16000, "IS10")
    np.testing.assert_array_equal(f.numpy(), runs["port_frame"][0])
    np.testing.assert_array_equal(th.handcrafted_utt(x, n, 16000, "IS10").numpy(),
                                  runs["port_utt"])
    utt, f, m = th.handcrafted_levels(x, n, 16000, "IS10")
    np.testing.assert_array_equal(utt.numpy(), runs["port_utt"])
    np.testing.assert_array_equal(f.numpy(), runs["port_frame"][0])
    np.testing.assert_array_equal(m.numpy(), runs["port_frame"][1])
    with pytest.raises(ValueError, match="16000 Hz"):
        th.handcrafted_utt(x, n, 22050, "IS10")
