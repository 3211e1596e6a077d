"""eGeMAPSv01a acoustic feature set, batched on the tensor's device — port
of ``mertools_tpu/ops/egemaps.py``.

The reference extracts eGeMAPS with openSMILE's ``config/gemaps/
eGeMAPSv01a.conf`` (``MERBench/feature_extraction/audio/
handcrafted_feature_func.py:33-34,97-124``). The chain, as the JAX package
defines it (its docstring lists the documented departures from the binary):

- 60 ms Gaussian-windowed frames on a 10 ms grid: F0 by subharmonic
  summation (15 harmonics, 0.85^h, 240 log-spaced candidates 55-1000 Hz)
  smoothed by a Viterbi pass over the candidates and an unvoiced state, in
  semitones from 27.5 Hz; HNR from the ACF at the chosen period; H1-H2 and
  H1-A3; jitter and shimmer as frame-to-frame contour proxies;
- 20 ms Hamming frames on the same grid: loudness, alpha ratio, Hammarberg
  index, spectral slopes 0-500 / 500-1500 Hz, spectral flux, MFCC 1-4 (the
  IS09 HTK chain), formants F1-F3 from an order-12 LPC envelope;
- ``sma3`` / ``sma3nz`` smoothing, mask-aware; the 88 functionals.

The Viterbi pass is the one loop over frames: one step a frame for the
whole batch, no host sync inside (a frame past a row's mask is an identity
step, so padding cannot steer the path). Run lengths have a closed form
(cumulative sums with resets). The SHS scores are a product of the 60 ms
magnitude spectrum with a (bins, candidates) matrix made from the JAX
package's index and weight tables (:func:`shs_tables`), uploaded once a
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from .fbank import frame_signal
from .opensmile_is09 import (hamming, htk_dct_lifter, htk_mel_bank, preemphasis_htk,
                             sma3, valid_frames)

SR = 16000
HOP = 160                 # 10 ms
WIN_S = 320               # 20 ms spectral window
WIN_P = 960               # 60 ms pitch window
NFFT_S = 512
NFFT_P = 1024
PREEMPH = 0.97
F0_LO, F0_HI = 55.0, 1000.0
N_HARM = 15
SHS_COMPRESSION = 0.85
N_CAND = 240              # log-spaced F0 candidates (~21 cents)
LPC_ORDER = 12
ENV_GRID = 256            # LPC-envelope evaluation points (0..5500 Hz)
FMT_MAX_HZ = 5500.0
VITERBI_RANGE = "egemaps.viterbi"   # profiler range around the frame loops

# ---------------------------------------------------------------------------
# the 88 functional names (openSMILE eGeMAPSv01a CSV order)
# ---------------------------------------------------------------------------


def _blk10(n):
    return [f"{n}_amean", f"{n}_stddevNorm", f"{n}_percentile20.0",
            f"{n}_percentile50.0", f"{n}_percentile80.0", f"{n}_pctlrange0-2",
            f"{n}_meanRisingSlope", f"{n}_stddevRisingSlope",
            f"{n}_meanFallingSlope", f"{n}_stddevFallingSlope"]


def _blk2(n):
    return [f"{n}_amean", f"{n}_stddevNorm"]


EGEMAPS_NAMES = tuple(
    _blk10("F0semitoneFrom27.5Hz_sma3nz")
    + _blk10("loudness_sma3")
    + _blk2("spectralFlux_sma3")
    + _blk2("mfcc1_sma3") + _blk2("mfcc2_sma3")
    + _blk2("mfcc3_sma3") + _blk2("mfcc4_sma3")
    + _blk2("jitterLocal_sma3nz") + _blk2("shimmerLocaldB_sma3nz")
    + _blk2("HNRdBACF_sma3nz")
    + _blk2("logRelF0-H1-H2_sma3nz") + _blk2("logRelF0-H1-A3_sma3nz")
    + _blk2("F1frequency_sma3nz") + _blk2("F1bandwidth_sma3nz")
    + _blk2("F1amplitudeLogRelF0_sma3nz")
    + _blk2("F2frequency_sma3nz") + _blk2("F2bandwidth_sma3nz")
    + _blk2("F2amplitudeLogRelF0_sma3nz")
    + _blk2("F3frequency_sma3nz") + _blk2("F3bandwidth_sma3nz")
    + _blk2("F3amplitudeLogRelF0_sma3nz")
    + _blk2("alphaRatioV_sma3nz") + _blk2("hammarbergIndexV_sma3nz")
    + _blk2("slopeV0-500_sma3nz") + _blk2("slopeV500-1500_sma3nz")
    + _blk2("spectralFluxV_sma3nz")
    + _blk2("mfcc1V_sma3nz") + _blk2("mfcc2V_sma3nz")
    + _blk2("mfcc3V_sma3nz") + _blk2("mfcc4V_sma3nz")
    + ["alphaRatioUV_sma3nz_amean", "hammarbergIndexUV_sma3nz_amean",
       "slopeUV0-500_sma3nz_amean", "slopeUV500-1500_sma3nz_amean",
       "spectralFluxUV_sma3nz_amean",
       "loudnessPeaksPerSec", "VoicedSegmentsPerSec",
       "MeanVoicedSegmentLengthSec", "StddevVoicedSegmentLengthSec",
       "MeanUnvoicedSegmentLength", "StddevUnvoicedSegmentLength",
       "equivalentSoundLevel_dBp"])
assert len(EGEMAPS_NAMES) == 88, len(EGEMAPS_NAMES)

LLD_NAMES = ("loudness", "alphaRatio", "hammarbergIndex", "slope0-500",
             "slope500-1500", "spectralFlux", "mfcc1", "mfcc2", "mfcc3",
             "mfcc4", "F0semitone", "jitterLocal", "shimmerLocaldB",
             "HNRdBACF", "H1-H2", "H1-A3", "F1frequency", "F1bandwidth",
             "F1amplitudeLogRelF0", "F2frequency", "F2amplitudeLogRelF0",
             "F3frequency", "F3amplitudeLogRelF0")       # 23, CSV order
# (frame-level CSV excludes F2/F3 bandwidth — they are functional-only)

NZ_LLDS = frozenset(("F0semitone", "jitterLocal", "shimmerLocaldB",
                     "HNRdBACF", "H1-H2", "H1-A3", "F1frequency",
                     "F1bandwidth", "F1amplitudeLogRelF0", "F2frequency",
                     "F2bandwidth", "F2amplitudeLogRelF0", "F3frequency",
                     "F3bandwidth", "F3amplitudeLogRelF0"))


def n_frames(T: int) -> int:
    return max(1 + (max(T, WIN_P) - WIN_P) // HOP, 1)


def _gauss_win(n: int, sigma: float = 0.4) -> np.ndarray:
    t = (np.arange(n) - (n - 1) / 2.0) / ((n - 1) / 2.0)
    return np.exp(-0.5 * (t / sigma) ** 2).astype(np.float32)


def _shift(x: torch.Tensor, k: int, fill: float = 0.0) -> torch.Tensor:
    """x moved k frames later along dim 1 (k = -1: earlier), ``fill`` in."""
    z = torch.full_like(x[:, :1], fill)
    return torch.cat([z, x[:, :-1]], 1) if k > 0 else torch.cat([x[:, 1:], z], 1)


def _sma3nz(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Moving average along dim 1 of (B, F) or (B, F, D) over nonzero VALID
    neighbours only; zeros stay zero, frames past ``mask`` neither receive
    nor contribute smoothing."""
    keep = (x != 0) & (mask if x.dim() == 2 else mask[:, :, None])
    nz = keep.to(x.dtype)
    xm = x * nz
    num = _shift(xm, 1) + xm + _shift(xm, -1)
    den = _shift(nz, 1) + nz + _shift(nz, -1)
    return torch.where(keep, num / den.clamp_min(1.0), 0.0)


# ---------------------------------------------------------------------------
# SHS pitch + Viterbi smoothing
# ---------------------------------------------------------------------------

# A candidate grid is (lowest Hz, highest Hz, count), log-spaced; a tuple,
# so the tables made from it are built and uploaded once a device.
EGEMAPS_GRID = (F0_LO, F0_HI, N_CAND)


def cand_freqs(grid: tuple = EGEMAPS_GRID) -> np.ndarray:
    lo, hi, n = grid
    return np.exp(np.linspace(np.log(lo), np.log(hi), n)).astype(np.float32)


_CAND_FREQS = cand_freqs()


def shs_tables(grid: tuple = EGEMAPS_GRID, nfft: int = NFFT_P):
    """The JAX package's SHS gather tables, each (G, H): the lower bin
    ``i0`` of harmonic h of candidate g, the interpolation weight ``w1`` of
    bin i0 + 1, and the compression ``0.85^(h-1)`` (0 past Nyquist)."""
    df = SR / nfft
    h = np.arange(1, N_HARM + 1)[None, :]                # (1, H)
    fbin = cand_freqs(grid)[:, None] * h / df            # (G, H) fractional
    valid = (fbin < nfft // 2).astype(np.float32)
    i0 = np.clip(np.floor(fbin).astype(np.int64), 0, nfft // 2 - 1)
    w1 = (fbin - i0).astype(np.float32)
    comp = (SHS_COMPRESSION ** (h - 1)).astype(np.float32) * valid
    return i0, w1, comp


def shs_matrix(grid: tuple = EGEMAPS_GRID, nfft: int = NFFT_P) -> np.ndarray:
    """(nfft//2 + 1, G): SHS scores = magnitude @ this matrix, the sum over
    harmonics of ``comp * ((1 - w1) * mag[i0] + w1 * mag[i0 + 1])``."""
    i0, w1, comp = shs_tables(grid, nfft)
    G = grid[2]
    W = np.zeros((nfft // 2 + 1, G), np.float32)
    g = np.broadcast_to(np.arange(G)[:, None], i0.shape)
    # float32 products, as the gather's (1 - w1) * comp; no two harmonics of
    # a candidate share a bin, so each entry is one product
    np.add.at(W, (i0, g), (np.float32(1.0) - w1) * comp)
    np.add.at(W, (i0 + 1, g), w1 * comp)
    return W


def _shs_scores(mag_p: torch.Tensor, grid: tuple = EGEMAPS_GRID) -> torch.Tensor:
    """(B, F, K) 60 ms magnitude spectrum -> (B, F, G) SHS scores."""
    return mag_p @ on_device(shs_matrix, mag_p.device, grid)


def viterbi_trans(grid: tuple = EGEMAPS_GRID) -> np.ndarray:
    """(G+1, G+1) transition costs (from, to): 2 |log2 f - log2 f'| between
    voiced candidates, 1 across the voicing switch, 0 unvoiced to unvoiced."""
    G = grid[2]
    logf = np.log2(cand_freqs(grid))
    trans = np.full((G + 1, G + 1), 1.0, np.float32)
    trans[:G, :G] = 2.0 * np.abs(logf[:, None] - logf[None, :])
    trans[G, G] = 0.0
    return trans


def _cand_hz(grid: tuple = EGEMAPS_GRID) -> np.ndarray:
    return np.concatenate([cand_freqs(grid), np.zeros(1, np.float32)])


def _cand_semitones(grid: tuple = EGEMAPS_GRID) -> np.ndarray:
    """F0 in semitones from 27.5 Hz of each state (0 unvoiced), in float32
    as XLA evaluates ``12 log2(max(f0, 1) / 27.5)``: the quotient as a
    product with f32(1/27.5), then ln times f32(12/ln 2), with a correctly
    rounded ln: the bits of XLA's on over 90% of the candidates, one ulp
    off on the rest. The F0 slope functionals split steps by the sign of a
    difference that is 0 on a flat contour only if its 3-frame average
    rounds back to the same bits, so those bits matter; a table keeps them
    the same on every device."""
    f32 = np.float32
    y = (np.maximum(cand_freqs(grid), f32(1.0)) * f32(1 / 27.5)).astype(f32)
    st = (np.log(y.astype(np.float64)).astype(f32) * f32(12 / np.log(2.0))).astype(f32)
    return np.concatenate([st, np.zeros(1, f32)])


def _viterbi_f0(shs: torch.Tensor, p_voiced: torch.Tensor, mask: torch.Tensor,
                grid: tuple = EGEMAPS_GRID) -> torch.Tensor:
    """Min-cost smoothing over G candidates + an unvoiced state: shs (B,F,G),
    p_voiced (B,F), mask (B,F) -> (B, F) state index (G where unvoiced).

    One step a frame for the whole batch; a frame past a row's mask keeps
    that row's cost and points each state at itself, so the decoded path
    over the valid prefix is the one an exact-length clip gives."""
    B, F, G = shs.shape
    dev = shs.device
    sn = shs / (shs.amax(dim=-1, keepdim=True) + 1e-12)
    local_v = (1.0 - sn) + (1.0 - p_voiced)[..., None]   # (B,F,G)
    local_u = p_voiced + 0.5                             # (B,F)
    local = torch.cat([local_v, local_u[..., None]], dim=-1).transpose(0, 1)
    valid = mask.transpose(0, 1)[:, :, None]             # (F,B,1)
    # (1, to, from): the min over the previous state runs along contiguous
    # memory; torch.min gives the first of equal minima, as jnp.argmin
    trans_t = on_device(viterbi_trans, dev, grid).T.contiguous()[None]
    iden = torch.arange(G + 1, device=dev).expand(B, G + 1)

    args = torch.empty((F, B, G + 1), dtype=torch.int64, device=dev)
    path = torch.empty((F, B), dtype=torch.int64, device=dev)
    # a named range, so a profile can tell the loops' share of the chain
    with torch.profiler.record_function(VITERBI_RANGE):
        steps = zip(local.unbind(0)[1:], valid.unbind(0)[1:], args.unbind(0)[1:])
        cost = local[0]                                  # frame 0 always valid
        for loc, ok, out in steps:
            best, arg = torch.min(cost[:, None, :] + trans_t, dim=2)
            cost = torch.where(ok, best + loc, cost)
            torch.where(ok, arg, iden, out=out)
        path[F - 1] = torch.argmin(cost, dim=-1)
        rows = path[:, :, None].unbind(0)
        for t in range(F - 1, 0, -1):
            torch.gather(args[t], 1, rows[t], out=rows[t - 1])
    return path.transpose(0, 1)


# ---------------------------------------------------------------------------
# LLD extraction
# ---------------------------------------------------------------------------


def _peak_near(mag: torch.Tensor, fb: torch.Tensor, back: int, width: int) -> torch.Tensor:
    """max of ``mag`` (B, F, K) over ``width`` bins from floor(fb - back),
    the start clipped into the spectrum."""
    K = mag.shape[-1]
    lo = torch.floor(fb - back).to(torch.int64).clamp(0, K - 1 - width)
    offs = torch.arange(width, device=mag.device)
    return torch.take_along_dim(mag, lo[..., None] + offs, dim=-1).amax(dim=-1)


def _lld_core(wav: torch.Tensor, lengths: torch.Tensor):
    """(B, T), (B,) -> dict[name -> (B, F)], voiced (B,F), mask (B,F)."""
    dev = wav.device
    B, T = wav.shape
    nF = n_frames(T)
    mask = valid_frames(lengths, nF, WIN_P)
    out = {}

    # ---- 60 ms Gaussian branch: F0 / HNR / harmonics
    fr_p = frame_signal(wav, nF, WIN_P, HOP) * on_device(_gauss_win, dev, WIN_P)
    mag_p = torch.abs(torch.fft.rfft(fr_p, n=NFFT_P, dim=-1))
    acf = torch.fft.irfft(mag_p ** 2, n=NFFT_P, dim=-1)
    lag_lo = int(SR / F0_HI)                              # 16
    lag_hi = min(int(SR / F0_LO) + 1, NFFT_P // 2)        # 291
    acn = acf[..., lag_lo:lag_hi] / (acf[..., :1] + 1e-12)
    p_voiced = torch.clamp(acn.amax(dim=-1), 0.0, 1.0)

    state = _viterbi_f0(_shs_scores(mag_p), p_voiced, mask)  # (B,F), G = UV
    f0 = on_device(_cand_hz, dev)[state]                  # Hz, 0 = unvoiced
    voiced = (f0 > 0) & mask
    f0 = torch.where(voiced, f0, 0.0)
    out["F0semitone"] = torch.where(voiced, on_device(_cand_semitones, dev)[state], 0.0)

    # HNR from ACF at the chosen period
    lag = torch.round(SR / f0.clamp_min(F0_LO)).to(torch.int64).clamp(lag_lo, lag_hi - 1)
    r_t0 = torch.take_along_dim(acf, lag[..., None], dim=-1)[..., 0]
    r = torch.clamp(r_t0 / (acf[..., 0] + 1e-12), 1e-5, 1.0 - 1e-5)
    hnr = 10.0 * torch.log10(r / (1.0 - r))
    out["HNRdBACF"] = torch.where(voiced, hnr.clamp(-100.0, 100.0), 0.0)

    # harmonic amplitudes from the 60 ms spectrum (dB)
    df_p = SR / NFFT_P
    a_h1 = _peak_near(mag_p, f0 * 1.0 / df_p, 2, 5)
    a_h2 = _peak_near(mag_p, f0 * 2.0 / df_p, 2, 5)
    out["H1-H2"] = torch.where(
        voiced, 20.0 * torch.log10((a_h1 + 1e-12) / (a_h2 + 1e-12)), 0.0)

    # ---- jitter / shimmer: frame-to-frame contour proxies
    per = torch.where(voiced, 1.0 / f0.clamp_min(1.0), 0.0)
    per_prev = _shift(per, 1)
    both = voiced & (per_prev > 0)
    jit = torch.abs(per - per_prev) / ((per + per_prev) / 2).clamp_min(1e-6)
    out["jitterLocal"] = torch.where(both, jit, 0.0)

    rms_p = torch.sqrt(torch.mean(fr_p ** 2, dim=-1) + 1e-12)
    rms_prev = _shift(rms_p, 1, 1e-6)
    shim = torch.abs(20.0 * torch.log10(rms_p / rms_prev.clamp_min(1e-8)))
    out["shimmerLocaldB"] = torch.where(both, shim, 0.0)

    # ---- 20 ms Hamming branch: loudness / spectral balance / MFCC
    ham = on_device(hamming, dev, WIN_S)
    raw_s = frame_signal(wav, nF, WIN_S, HOP)
    mag_s = torch.abs(torch.fft.rfft(raw_s * ham, n=NFFT_S, dim=-1))
    pow_s = mag_s ** 2
    freqs_s = np.arange(NFFT_S // 2 + 1) * SR / NFFT_S

    fb26 = on_device(htk_mel_bank, dev, SR, NFFT_S, 26, 20.0, 8000.0)
    bandpow = pow_s @ fb26.T
    out["loudness"] = torch.sum(bandpow.clamp_min(1e-12) ** 0.3, dim=-1)

    def band(lo, hi):
        return torch.from_numpy((freqs_s >= lo) & (freqs_s < hi)).to(dev)

    def bandsum(lo, hi):
        return torch.sum(pow_s * band(lo, hi).to(pow_s.dtype), dim=-1)

    out["alphaRatio"] = 10.0 * torch.log10(
        (bandsum(50, 1000) + 1e-12) / (bandsum(1000, 5000) + 1e-12))

    def bandmax(lo, hi):
        return torch.where(band(lo, hi), pow_s, 0.0).amax(dim=-1)

    out["hammarbergIndex"] = 10.0 * torch.log10(
        (bandmax(0, 2000) + 1e-12) / (bandmax(2000, 5000) + 1e-12))

    def slope(lo, hi):
        sel = np.nonzero((freqs_s >= lo) & (freqs_s < hi))[0]
        f_sel = freqs_s[sel]
        db = 10.0 * torch.log10(pow_s[..., sel[0]: sel[-1] + 1] + 1e-12)
        fc = (f_sel - f_sel.mean()).astype(np.float32)
        return torch.sum(db * torch.from_numpy(fc).to(dev), dim=-1) / float(np.sum(fc ** 2))

    out["slope0-500"] = slope(0, 500)
    out["slope500-1500"] = slope(500, 1500)

    flux = torch.sqrt(torch.mean((mag_s - _shift(mag_s, 1)) ** 2, dim=-1))
    out["spectralFlux"] = torch.cat([torch.zeros_like(flux[:, :1]), flux[:, 1:]], 1)

    # MFCC 1-4: HTK chain (preemphasis inside the frame, as IS09)
    mag_pe = torch.abs(torch.fft.rfft(preemphasis_htk(raw_s, PREEMPH) * ham, n=NFFT_S,
                                      dim=-1))
    logmel = torch.log((mag_pe @ fb26.T).clamp_min(1e-8))
    mfcc4 = logmel @ on_device(htk_dct_lifter, dev, 4, 26).T
    for i in range(4):
        out[f"mfcc{i+1}"] = mfcc4[..., i]

    # ---- formants from the LPC envelope of the 20 ms frames
    acf_s = torch.fft.irfft(pow_s, n=NFFT_S, dim=-1)[..., : LPC_ORDER + 1]
    lpc = _lpc_batched(acf_s.reshape(-1, LPC_ORDER + 1)).reshape(B, nF, LPC_ORDER)
    cosm, sinm = on_device(_envelope_basis, dev)
    # |A(e^jw)|^2 = (1 - sum a cos)^2 + (sum a sin)^2
    re = 1.0 - lpc @ cosm.T
    im = lpc @ sinm.T
    env_db = -10.0 * torch.log10(re ** 2 + im ** 2 + 1e-12)   # (B,F,G)
    fmt_f, fmt_bw, _ = _formant_peaks(env_db)

    # amplitude of the harmonic peak nearest each formant, rel. F0 (dB)
    df_s = SR / NFFT_S
    a_f0 = _peak_near(mag_s, torch.where(voiced, f0, 100.0) / df_s, 3, 7)
    for j in range(3):
        fj = fmt_f[..., j]
        ok = voiced & (fj > 0)
        out[f"F{j+1}frequency"] = torch.where(ok, fj, 0.0)
        if j == 0:
            out["F1bandwidth"] = torch.where(ok, fmt_bw[..., 0], 0.0)
        out[f"_F{j+1}bandwidth"] = torch.where(ok, fmt_bw[..., j], 0.0)
        amp = 20.0 * torch.log10(
            (_peak_near(mag_s, fj.clamp_min(100.0) / df_s, 3, 7) + 1e-12) / (a_f0 + 1e-12))
        out[f"F{j+1}amplitudeLogRelF0"] = torch.where(ok, amp, 0.0)

    # H1-A3: first harmonic vs the harmonic peak near F3 (60 ms spectrum)
    a3 = _peak_near(mag_p, fmt_f[..., 2].clamp_min(100.0) / df_p, 3, 7)
    out["H1-A3"] = torch.where(voiced & (fmt_f[..., 2] > 0),
                               20.0 * torch.log10((a_h1 + 1e-12) / (a3 + 1e-12)), 0.0)

    # ---- smoothing (mask-aware: padded frames never leak into valid ones)
    for name in list(out):
        if name.lstrip("_") in NZ_LLDS or name.startswith("_F"):
            out[name] = _sma3nz(out[name], mask)
        else:
            out[name] = sma3(out[name], mask)
    voiced_sm = out["F0semitone"] > 0
    return out, voiced_sm & mask, mask


def _envelope_basis() -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of k w on ENV_GRID points of 0..FMT_MAX_HZ, k = 1..order."""
    w_grid = np.linspace(0.0, 2 * np.pi * FMT_MAX_HZ / SR, ENV_GRID)
    k = np.arange(1, LPC_ORDER + 1)
    return (np.cos(w_grid[:, None] * k[None, :]).astype(np.float32),
            np.sin(w_grid[:, None] * k[None, :]).astype(np.float32))


def _lpc_batched(r: torch.Tensor) -> torch.Tensor:
    """Levinson-Durbin: (N, order+1) autocorr -> (N, order) coefficients."""
    order = r.shape[-1] - 1
    a = torch.zeros_like(r)
    a[:, 0] = 1.0
    err = r[:, 0] + 1e-9
    idx = np.arange(order + 1)
    for i in range(order):
        rev = torch.from_numpy(np.clip(i + 1 - idx, 0, order)).to(r.device)
        rj = r[:, rev]
        m = torch.from_numpy(((idx >= 1) & (idx <= i)).astype(np.float32)).to(r.device)
        # error-filter convention a = [1, -phi...]: the reflection
        # coefficient is k = (r[i+1] + sum_j a[j] r[i+1-j]) / err
        acc = torch.sum(a * rj * m, dim=-1)
        kref = (r[:, i + 1] + acc) / err
        # reflection update a_new[j] = a[j] - k * a[i+1-j]
        upd = torch.from_numpy(((idx >= 1) & (idx <= i + 1)).astype(np.float32)).to(r.device)
        a = a - (kref[:, None] * a[:, rev]) * upd
        err = err * (1.0 - kref ** 2) + 1e-12
    return -a[:, 1:]


def _formant_peaks(env_db: torch.Tensor):
    """(B, F, G) LPC envelope in dB -> first 3 peaks as (freqs, bandwidths,
    peak_db), each (B, F, 3); zeros where fewer than 3 peaks exist.
    Parabolic refinement around each local maximum; bandwidth from the
    -3 dB width of the fitted parabola."""
    G = env_db.shape[-1]
    grid_hz = np.linspace(0.0, FMT_MAX_HZ, G).astype(np.float32)
    step = float(grid_hz[1] - grid_hz[0])

    mid = env_db[..., 1:-1]
    is_pk = (mid > env_db[..., :-2]) & (mid >= env_db[..., 2:])
    no = torch.zeros_like(is_pk[..., :1])
    # the first point is never a peak: a fall from DC is a rolloff
    is_pk = torch.cat([no, is_pk, no], dim=-1)

    # rank of each peak along the grid (1st, 2nd, 3rd ...)
    rank = torch.cumsum(is_pk.to(torch.int32), dim=-1) * is_pk

    # parabolic refinement
    prev = torch.cat([env_db[..., :1], env_db[..., :-1]], dim=-1)
    nxt = torch.cat([env_db[..., 1:], env_db[..., -1:]], dim=-1)
    denom = prev - 2 * env_db + nxt
    big = torch.abs(denom) > 1e-9
    delta = torch.where(big, 0.5 * (prev - nxt) / torch.where(big, denom, 1.0), 0.0)
    delta = delta.clamp(-0.5, 0.5)
    pk_hz = torch.from_numpy(grid_hz).to(env_db.device) + delta * step
    # curvature a (dB per Hz^2); -3 dB halfwidth = sqrt(3/a)
    a_curv = (-0.5 * denom / (step ** 2)).clamp_min(1e-6)
    bw = 2.0 * torch.sqrt(3.0 / a_curv)

    outs = ([], [], [])
    for j in (1, 2, 3):
        sel = rank == j
        any_j = sel.any(dim=-1)
        for o, v in zip(outs, (pk_hz, bw, env_db)):
            o.append(torch.where(any_j, torch.where(sel, v, 0.0).sum(-1), 0.0))
    return tuple(torch.stack(o, -1) for o in outs)


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------


def _mean_cv(x, m):
    n = m.sum(1).clamp_min(1.0)
    mean = (x * m).sum(1) / n
    var = (((x - mean[:, None]) * m) ** 2).sum(1) / n
    cv = torch.sqrt(var) / torch.where(torch.abs(mean) > 1e-9, mean, 1e-9)
    return mean, cv


def _percentiles(x, m, qs):
    """Interpolated percentiles of the masked values along dim 1 (0 where a
    row has none). x (B, F) or (B, F, D), m (B, F) or (B, F, 1); frames past
    the mask sort last as +inf."""
    s = torch.sort(torch.where(m > 0, x, torch.inf), dim=1).values
    cnt = m.sum(1)
    n = cnt.clamp_min(1.0)
    F = x.shape[1]
    outs = []
    for q in qs:
        pos = q * (n - 1.0)
        i0 = torch.floor(pos).to(torch.int64).clamp(0, F - 1)
        i1 = (i0 + 1).clamp(0, F - 1)
        w = (pos - i0.to(pos.dtype))[:, None]
        v0 = torch.take_along_dim(s, i0[:, None], 1)
        v1 = torch.take_along_dim(s, i1[:, None], 1)
        v1 = torch.where(torch.isfinite(v1), v1, v0)
        outs.append(torch.where(cnt > 0, ((1 - w) * v0 + w * v1)[:, 0], 0.0))
    return outs


def _slope_stats(x, m):
    """Rising/falling slope stats of the contour over masked frames: each
    frame t with m[t] & m[t-1] adds its step slope (x[t]-x[t-1])/0.01 to
    the rising set if positive, else to the falling set (the JAX package's
    duration-weighted form of openSMILE's mean over segments)."""
    d = (x[:, 1:] - x[:, :-1]) / (HOP / SR)
    mm = (m[:, 1:] > 0) & (m[:, :-1] > 0)

    def stats(sel):
        cnt = sel.sum(1)
        nsel = cnt.clamp_min(1).to(x.dtype)
        mean = torch.where(sel, d, 0.0).sum(1) / nsel
        var = torch.where(sel, (d - mean[:, None]) ** 2, 0.0).sum(1) / nsel
        ok = cnt > 0
        return torch.where(ok, mean, 0.0), torch.where(ok, torch.sqrt(var), 0.0)

    mr, sr_ = stats(mm & (d > 0))
    mf, sf = stats(mm & (d < 0))
    return mr, sr_, torch.abs(mf), sf


def run_length(seg: torch.Tensor) -> torch.Tensor:
    """(B, F) bool -> (B, F) float length of the current True run so far:
    the running count less its value at the last False frame."""
    c = torch.cumsum(seg.to(torch.float32), dim=1)
    last = torch.cummax(torch.where(seg, 0.0, c), dim=1).values
    return torch.where(seg, c - last, 0.0)


def _seg_stats(seg_mask, mask):
    """Mean/stddev length (sec) + count of contiguous True segments."""
    seg = seg_mask & mask
    starts = seg & ~_shift(seg, 1, False)
    n_seg = starts.to(torch.float32).sum(1)
    total = seg.to(torch.float32).sum(1)
    mean_len = total / n_seg.clamp_min(1.0) * (HOP / SR)
    ends = seg & ~_shift(seg, -1, False)
    seg_lens = torch.where(ends, run_length(seg), 0.0)
    mean_l = seg_lens.sum(1) / n_seg.clamp_min(1.0)
    var_l = (seg_lens ** 2).sum(1) / n_seg.clamp_min(1.0) - mean_l ** 2
    std_len = torch.sqrt(var_l.clamp_min(0.0)) * (HOP / SR)
    return mean_len, std_len, n_seg


def egemaps_utt(wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T), (B,) -> (B, 88) in ``EGEMAPS_NAMES`` order."""
    wav = wav.to(torch.float32)
    return utt_functionals(*_lld_core(wav, lengths), wav, lengths)


def utt_functionals(llds: dict, voiced: torch.Tensor, mask: torch.Tensor, wav: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """:func:`_lld_core`'s contours (and the signal, for its level) -> the
    88 functionals."""
    mA = mask.to(torch.float32)
    mV = voiced.to(torch.float32)
    mU = (mask & ~voiced).to(torch.float32)
    cols = []

    def blk10(x, m):
        mean, cv = _mean_cv(x, m)
        p20, p50, p80 = _percentiles(x, m, (0.2, 0.5, 0.8))
        cols.extend([mean, cv, p20, p50, p80, p80 - p20, *_slope_stats(x, m)])

    def blk2(x, m):
        cols.extend(_mean_cv(x, m))

    blk10(llds["F0semitone"], mV)
    blk10(llds["loudness"], mA)
    blk2(llds["spectralFlux"], mA)
    for i in (1, 2, 3, 4):
        blk2(llds[f"mfcc{i}"], mA)
    for n in ("jitterLocal", "shimmerLocaldB", "HNRdBACF", "H1-H2", "H1-A3",
              "F1frequency", "F1bandwidth", "F1amplitudeLogRelF0",
              "F2frequency", "_F2bandwidth", "F2amplitudeLogRelF0",
              "F3frequency", "_F3bandwidth", "F3amplitudeLogRelF0"):
        blk2(llds[n], mV)
    # voiced/unvoiced spectral splits
    for n in ("alphaRatio", "hammarbergIndex", "slope0-500",
              "slope500-1500", "spectralFlux", "mfcc1", "mfcc2", "mfcc3",
              "mfcc4"):
        blk2(llds[n], mV)
    for n in ("alphaRatio", "hammarbergIndex", "slope0-500",
              "slope500-1500", "spectralFlux"):
        cols.append((llds[n] * mU).sum(1) / mU.sum(1).clamp_min(1.0))

    # temporal statistics
    dur = mA.sum(1).clamp_min(1.0) * (HOP / SR)
    loud = llds["loudness"]
    is_pk = (loud[:, 1:-1] > loud[:, :-2]) & (loud[:, 1:-1] >= loud[:, 2:])
    # a peak needs BOTH neighbours valid: the last valid frame is the
    # contour edge (exact-length semantics), never a peak of padded garbage
    no = torch.zeros_like(mask[:, :1])
    is_pk = torch.cat([no, is_pk, no], 1) & mask & _shift(mask, -1, False)
    cols.append(is_pk.to(torch.float32).sum(1) / dur)
    mean_v, std_v, n_v = _seg_stats(voiced, mask)
    mean_u, std_u, _ = _seg_stats(~voiced, mask)
    cols.append(n_v / dur)
    cols.extend([mean_v, std_v, mean_u, std_u])
    # Leq over the valid signal
    tmask = (torch.arange(wav.shape[1], device=wav.device)[None, :]
             < lengths[:, None]).to(torch.float32)
    energy = (wav ** 2 * tmask).sum(1) / tmask.sum(1).clamp_min(1.0)
    cols.append(10.0 * torch.log10(energy + 1e-12))
    return torch.stack(cols, dim=-1)


def egemaps_frame(wav: torch.Tensor, lengths: torch.Tensor):
    """(B, T), (B,) -> ((B, F, 23) LLDs in CSV order, (B, F) mask)."""
    llds, _, mask = _lld_core(wav.to(torch.float32), lengths)
    return frame_contours(llds), mask


def egemaps_levels(wav: torch.Tensor, lengths: torch.Tensor):
    """Both levels from one contour pass: (:func:`egemaps_utt`, then
    :func:`egemaps_frame`'s frames and mask)."""
    wav = wav.to(torch.float32)
    llds, voiced, mask = _lld_core(wav, lengths)
    return utt_functionals(llds, voiced, mask, wav, lengths), frame_contours(llds), mask


def frame_contours(llds: dict) -> torch.Tensor:
    """:func:`_lld_core`'s contours -> the (B, F, 23) frame columns."""
    return torch.stack([llds[n] for n in LLD_NAMES], dim=-1)
