"""The port's generic LLD bank and functional grid (``mertools_tpu_torch/
ops/handcrafted.py``: ``_lpc_levinson``, ``_lsp_from_lpc``,
``extract_lld_bank``, ``apply_functional_grid``, ``_egemaps_88``) against
the JAX package's on the shared seeded batch
(``test_torch_handcrafted.clip_batch``), each JAX function compiled once."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.ops import handcrafted as jh
from mertools_tpu_torch.ops import handcrafted as th
from test_torch_handcrafted import TOL, assert_columns_close, clip_batch, to_torch

torch.set_num_threads(1)

SR = 16000
K = 513                       # bins of the bank's 1024-point spectrum


@pytest.fixture(scope="module")
def runs():
    wav, lengths = clip_batch()
    jl, jm = jh.extract_lld_bank(jnp.asarray(wav), jnp.asarray(lengths))
    tl, tm = th.extract_lld_bank(*to_torch(wav, lengths))
    return {"wav": wav, "jax": ({k: np.asarray(v) for k, v in jl.items()}, np.asarray(jm)),
            "port": ({k: v.numpy() for k, v in tl.items()}, tm.numpy())}


def test_tables_and_selections_equal_jax():
    for name in ("FUNCTIONALS_IS09", "FUNCTIONALS_21", "FUNCTIONALS_19", "FUNCTIONALS_EXTRA11",
                 "FUNCTIONALS_42", "LLD_IS09", "LLD_IS10", "LLD_IS10_PITCH", "LLD_IS13",
                 "LLD_EGEMAPS", "FRAME_DIMS", "UTT_DIMS", "F0_MIN", "F0_MAX"):
        assert getattr(th, name) == getattr(jh, name), name
    assert len(th.FUNCTIONALS_42) == 42 and len(th.LLD_IS13) == 60


def test_lpc_and_lsp_match_jax(runs):
    """Levinson (order 8) and the line spectral pairs of the batch's
    windowed 25 ms frames: the port's and JAX's on the same autocorrelation,
    within 2e-4 of each column's max."""
    frames = th.frame_signal(torch.from_numpy(runs["wav"][:2]), 400, 160)
    frames = frames * torch.from_numpy(th.hann(400)).to(torch.float32)
    r = th._autocorr_fft(frames, 1024)[..., :9].reshape(-1, 9)
    lpc = th._lpc_levinson(r, 8)
    jr = jnp.asarray(r.numpy())
    assert_columns_close(lpc.numpy(), jax.jit(jh._lpc_levinson, static_argnums=1)(jr, 8))
    lsp = th._lsp_from_lpc(lpc, 8).numpy()
    want = np.asarray(jax.jit(jh._lsp_from_lpc, static_argnums=1)(jnp.asarray(lpc.numpy()), 8))
    assert_columns_close(lsp, want)
    assert (np.diff(lsp, axis=-1) >= 0).all() and lsp.max() <= np.pi


def test_lld_bank_matches_jax(runs):
    """Every LLD on the valid frames within 2e-4 of its max, but a formant
    amplitude read at a bin that the LSP midpoint's truncation puts one bin
    over: those frames' midpoints sit within 1e-3 of a bin edge (a decision
    without margin), and there are at most two."""
    (jl, jm), (tl, tm) = runs["jax"], runs["port"]
    assert sorted(tl) == sorted(jl)
    np.testing.assert_array_equal(tm, jm)
    edge_frames = 0
    for k in sorted(jl):
        got, want = tl[k][jm], jl[k][jm]
        if k in ("F1amplitude", "F2amplitude", "F3amplitude"):
            j = int(k[1]) - 1
            mid = (jl[f"F{j + 1}frequency"][jm]) / (SR / 2.0) * (K - 1)
            off = np.abs(got - want) > max(TOL * np.abs(want).max(), 1e-6)
            edge = np.abs(mid - np.round(mid)) < 1e-3
            assert not (off & ~edge).any(), k
            edge_frames += int(off.sum())
            got, want = got[~off], want[~off]
        assert_columns_close(got[:, None], want[:, None])
    assert edge_frames <= 2


def test_functional_grid_matches_jax(runs):
    """The 42-functional grid over JAX's own IS13 selection of the bank."""
    jl, jm = runs["jax"]
    x = np.stack([jl[k] for k in jh.LLD_IS13], -1)
    want = jax.jit(jh.apply_functional_grid, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(jm), jh.FUNCTIONALS_42)
    got = th.apply_functional_grid(*to_torch(x, jm), th.FUNCTIONALS_42).numpy()
    assert got.shape == (6, 42 * 60) and np.isfinite(got).all()
    assert_columns_close(got, want)


def test_egemaps_88_matches_jax(runs):
    jl, jm = runs["jax"]
    want = jax.jit(jh._egemaps_88)({k: jnp.asarray(v) for k, v in jl.items()}, jnp.asarray(jm))
    got = th._egemaps_88(dict(zip(jl, to_torch(*jl.values()))), *to_torch(jm))
    assert got.shape == (6, 88)
    assert_columns_close(got.numpy(), want)
