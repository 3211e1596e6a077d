"""openSMILE ``IS13_ComParE.conf`` feature chain, batched on the tensor's
device — port of ``mertools_tpu/ops/opensmile_is13.py``.

The reference extracts IS13 with ``config/IS13_ComParE.conf``
(``MERBench/feature_extraction/audio/handcrafted_feature_func.py:39,52-53``);
its contract is 120 columns a frame and 6,372 an utterance (``:19``). The
chain, as the JAX package defines it (its docstring lists the documented
departures from the binary, among them the reconstructed functional
grids):

- 65 LLDs on 25 ms / 10 ms frames, ``sma3``-smoothed (the voicing group
  nonzero-only): 4 energy (auditory-spectrum L1 norms, plain and RASTA,
  RMS energy, zero-crossing rate), 55 spectral (26 RASTA-filtered log
  auditory bands, HTK MFCC 1-14, two band powers, four roll-offs, flux,
  centroid, entropy, variance, skewness, kurtosis, slope, sharpness,
  harmonicity), 6 voicing (IS10's SHS + Viterbi pitch branch, its unclipped
  ACF voicing, jitter, jitterDDP, shimmer, and logHNR from the ACF at the
  pitch period);
- frame level (120): the 60 contours of energy, spectral and F0final, then
  their HTK deltas;
- utterance level (6,372): 54 functionals on the 59 energy and spectral
  contours, 46 on their deltas, 39 and 36 on the voicing group and its
  deltas over voiced frames, and a temporal set of 22.

RASTA is an IIR along time: its FIR half runs as one tensor expression,
its pole as one batched step a frame for the whole batch (the JAX
``lax.scan``'s arithmetic), under the ``is13.rasta`` profiler range.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from .egemaps import _percentiles, _shift, _sma3nz, run_length
from .fbank import frame_signal
from .handcrafted import _lpc_levinson
from .opensmile_is09 import (FRAME_LEN, HOP, MEL_FLOOR, N_FFT, SR, _delta2, hamming,
                             htk_dct_lifter, htk_mel_bank, n_frames, preemphasis_htk, sma3,
                             valid_frames)
from .opensmile_is10 import LAG_HI, LAG_LO, finish, onsets, pitch_branch

RASTA_RANGE = "is13.rasta"   # profiler range around the frame loop

# ---------------------------------------------------------------- LLD names

ENERGY_LLDS = ("audspec_lengthL1norm", "audspecRasta_lengthL1norm",
               "pcm_RMSenergy", "pcm_zcr")
SPECTRAL_LLDS = (tuple(f"audSpec_Rfilt{i}" for i in range(26))
                 + tuple(f"pcm_fftMag_mfcc{i}" for i in range(1, 15))
                 + ("pcm_fftMag_fband250-650", "pcm_fftMag_fband1000-4000",
                    "spectralRollOff25.0", "spectralRollOff50.0",
                    "spectralRollOff75.0", "spectralRollOff90.0",
                    "spectralFlux", "spectralCentroid", "spectralEntropy",
                    "spectralVariance", "spectralSkewness",
                    "spectralKurtosis", "spectralSlope", "psySharpness",
                    "spectralHarmonicity"))
VOICING_LLDS = ("F0final", "voicingFinalUnclipped", "jitterLocal",
                "jitterDDP", "shimmerLocal", "logHNR")
assert len(ENERGY_LLDS) == 4 and len(SPECTRAL_LLDS) == 55
FRAME_LLDS = ENERGY_LLDS + SPECTRAL_LLDS + ("F0final",)     # 60 in lld CSV

# ------------------------------------------------------------- functionals

_SHARED_46 = ("quartile1", "quartile2", "quartile3", "iqr1-2", "iqr2-3",
              "iqr1-3", "percentile1.0", "percentile99.0", "pctlrange0-1",
              "amean", "rqmean", "flatness", "stddev", "skewness",
              "kurtosis", "upleveltime25", "upleveltime50",
              "upleveltime75", "upleveltime90", "risetime", "curvtime",
              "maxPos", "minPos", "linregc1", "linregc2", "linregerrA",
              "linregerrQ", "qregc1", "qregc2", "qregc3", "qregerrA",
              "qregerrQ", "meanPeakDist", "peakDistStddev", "peakMean",
              "peakMeanMeanDist", "peakRangeAbs", "peakRangeRel",
              "meanRisingSlope", "stddevRisingSlope", "meanFallingSlope",
              "stddevFallingSlope", "centroid", "posamean", "absmean",
              "maxmeandist")
_LLD_ONLY_8 = ("lpgain", "lpc0", "lpc1", "lpc2", "lpc3", "lpc4",
               "meanSegLen", "maxSegLen")
FUNCS_A = _SHARED_46 + _LLD_ONLY_8                    # 54, on spectral sma
FUNCS_A_DE = _SHARED_46                               # 46, on spectral de
FUNCS_B = tuple(f for f in _SHARED_46 if f not in (
    "qregc1", "qregc2", "qregc3", "qregerrA", "qregerrQ",
    "peakRangeRel", "curvtime"))                      # 39, voicing sma
FUNCS_B_DE = tuple(f for f in FUNCS_B if f not in (
    "maxPos", "minPos", "risetime"))                  # 36, voicing de
assert (len(FUNCS_A), len(FUNCS_A_DE), len(FUNCS_B), len(FUNCS_B_DE)) == (54, 46, 39, 36)

TEMPORAL_22 = ("numVoicedSegments", "voicedSegmentsPerSec",
               "meanVoicedSegLen", "stddevVoicedSegLen", "maxVoicedSegLen",
               "minVoicedSegLen", "percentVoiced", "meanUnvoicedSegLen",
               "stddevUnvoicedSegLen", "maxUnvoicedSegLen",
               "minUnvoicedSegLen", "loudnessPeaksPerSec",
               "meanLoudnessPeakDist", "stddevLoudnessPeakDist",
               "meanLoudnessPeakAmp", "F0semitoneMean", "F0semitoneStddev",
               "F0semitoneP20", "F0semitoneP50", "F0semitoneP80",
               "F0semitoneRange", "turnDuration")
assert len(TEMPORAL_22) == 22

IS13_NAMES = tuple(
    [f"{n}_sma_{f}" for n in ENERGY_LLDS + SPECTRAL_LLDS for f in FUNCS_A]
    + [f"{n}_sma_de_{f}" for n in ENERGY_LLDS + SPECTRAL_LLDS for f in FUNCS_A_DE]
    + [f"{n}_sma_{f}" for n in VOICING_LLDS for f in FUNCS_B]
    + [f"{n}_sma_de_{f}" for n in VOICING_LLDS for f in FUNCS_B_DE]
    + list(TEMPORAL_22))
assert len(IS13_NAMES) == 6372, len(IS13_NAMES)


def _rasta(logmel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Classic RASTA band-pass along time on (B, F, M) log bands:
    y[t] = 0.94 y[t-1] + (2 x[t] + x[t-1] - x[t-3] - 2 x[t-4]) / 10, the
    frames past ``mask`` zeroed first. Causal, so padded frames cannot
    reach valid ones."""
    x = logmel * mask[:, :, None]
    B, F, M = x.shape

    def back(k):
        return torch.cat([torch.zeros_like(x[:, :k]), x[:, : F - k]], dim=1)

    u = ((2.0 * x + back(1) - back(3) - 2.0 * back(4)) * 0.1).transpose(0, 1)
    ys = torch.empty_like(u)                               # (F, B, M)
    y = torch.zeros_like(u[0])
    # a named range, so a profile can tell the loop's share of the chain
    with torch.profiler.record_function(RASTA_RANGE):
        for t in range(F):
            y = torch.add(0.94 * y, u[t], out=ys[t])
    return ys.transpose(0, 1)


def fft_freqs() -> np.ndarray:
    """The power spectrum's bin frequencies in Hz, (N_FFT // 2 + 1,)."""
    return (np.arange(N_FFT // 2 + 1) * SR / N_FFT).astype(np.float32)


def band_mask(lo: float, hi: float) -> np.ndarray:
    """1 on the bins in [lo, hi) Hz."""
    f = fft_freqs()
    return ((f >= lo) & (f < hi)).astype(np.float32)


def slope_regressor() -> np.ndarray:
    """The bin frequencies less their mean: the spectral slope's regressor."""
    f = fft_freqs()
    return (f - f.mean()).astype(np.float32)


def sharpness_weights() -> np.ndarray:
    """psySharpness's weight of mel band z (1-26): z, times exp(0.17 (z -
    16)) from band 16 up."""
    zw = np.arange(1, 27, dtype=np.float32)
    return (np.where(zw < 16, 1.0, np.exp(0.17 * (zw - 16))).astype(np.float32) * zw)


def _lld_core(wav: torch.Tensor, lengths: torch.Tensor):
    """(B, T), (B,) -> (dict name -> (B, F), voiced (B, F), mask (B, F))."""
    dev = wav.device
    nF = n_frames(wav.shape[1])
    mask = valid_frames(lengths, nF, FRAME_LEN)
    raw = frame_signal(wav, nF, FRAME_LEN, HOP)
    out = {}

    # ---- energy branch (raw frames, IS09 components)
    out["pcm_RMSenergy"] = torch.sqrt(torch.mean(raw ** 2, dim=-1))
    zc = (raw[..., 1:] * raw[..., :-1] < 0).to(torch.float32)
    # a count times f32(1/399), as XLA divides by a constant: the contour is
    # quantized, so its ties (and the functionals' decisions) need its bits
    out["pcm_zcr"] = torch.sum(zc, dim=-1) * (1.0 / (FRAME_LEN - 1))

    # ---- auditory spectrum (26 HTK mel bands on the power spectrum)
    win = preemphasis_htk(raw) * on_device(hamming, dev, FRAME_LEN)
    mag = torch.abs(torch.fft.rfft(win, n=N_FFT, dim=-1))
    pow_ = mag ** 2
    fb26 = on_device(htk_mel_bank, dev)
    aud = pow_ @ fb26.T                                         # (B,F,26)
    out["audspec_lengthL1norm"] = torch.sum(aud, dim=-1)
    rasta = _rasta(torch.log(aud.clamp_min(MEL_FLOOR)), mask)   # log domain
    for i in range(26):
        out[f"audSpec_Rfilt{i}"] = rasta[..., i]
    out["audspecRasta_lengthL1norm"] = torch.sum(torch.exp(rasta), dim=-1)

    # ---- MFCC 1-14 (IS09 HTK chain on the magnitude mel bands)
    logmel = torch.log((mag @ fb26.T).clamp_min(MEL_FLOOR))
    mfcc = logmel @ on_device(htk_dct_lifter, dev, 14, 26).T
    for i in range(14):
        out[f"pcm_fftMag_mfcc{i + 1}"] = mfcc[..., i]

    # ---- band energies / rolloffs / moments on the power spectrum
    fgrid = on_device(fft_freqs, dev)
    out["pcm_fftMag_fband250-650"] = pow_ @ on_device(band_mask, dev, 250, 650)
    out["pcm_fftMag_fband1000-4000"] = pow_ @ on_device(band_mask, dev, 1000, 4000)

    total = torch.sum(pow_, dim=-1, keepdim=True)
    cum = torch.cumsum(pow_, dim=-1) / total.clamp_min(1e-12)
    for q in (25, 50, 75, 90):
        out[f"spectralRollOff{q}.0"] = fgrid[torch.argmax((cum >= q / 100.0).to(torch.uint8),
                                                          dim=-1)]

    flux = torch.sqrt(torch.mean((mag - _shift(mag, 1)) ** 2, dim=-1))
    out["spectralFlux"] = torch.cat([torch.zeros_like(flux[:, :1]), flux[:, 1:]], 1)

    pn = pow_ / total.clamp_min(1e-12)
    mu = torch.sum(pn * fgrid, dim=-1)
    dev_f = fgrid - mu[..., None]
    var = torch.sum(pn * dev_f ** 2, dim=-1)
    out["spectralCentroid"] = mu
    out["spectralVariance"] = var
    out["spectralSkewness"] = (torch.sum(pn * dev_f ** 3, dim=-1)
                               / torch.sqrt(var.clamp_min(1e-12)) ** 3)
    out["spectralKurtosis"] = torch.sum(pn * dev_f ** 4, dim=-1) / var.clamp_min(1e-12) ** 2
    out["spectralEntropy"] = -torch.sum(pn * torch.log(pn.clamp_min(1e-12)), dim=-1)
    # slope: dB-power vs Hz linear regression over the full band
    db = 10.0 * torch.log10(pow_.clamp_min(1e-12))
    out["spectralSlope"] = (db @ on_device(slope_regressor, dev)
                            / float(np.sum(slope_regressor() ** 2)))
    # psySharpness: high-band-weighted loudness centroid of the mel bands
    sl = aud.clamp_min(1e-12) ** 0.23
    out["psySharpness"] = (sl @ on_device(sharpness_weights, dev)
                           / torch.sum(sl, -1).clamp_min(1e-12)) * 0.11
    # harmonicity: mean peak-to-adjacent-valley contrast of the log spectrum
    l3 = db[..., 1:-1]
    pk = (l3 > db[..., :-2]) & (l3 >= db[..., 2:])
    contrast = l3 - 0.5 * (db[..., :-2] + db[..., 2:])
    out["spectralHarmonicity"] = (torch.sum(torch.where(pk, contrast, 0.0), -1)
                                  / torch.sum(pk, -1).clamp_min(1).to(torch.float32))

    # ---- voicing branch (IS10's SHS + Viterbi pitch, 52-620 Hz)
    f0, voiced, p_voiced, jitter, jitter_ddp, shimmer, acf = pitch_branch(wav, lengths, mask)
    out["F0final"] = f0
    out["voicingFinalUnclipped"] = p_voiced
    out["jitterLocal"] = jitter
    out["jitterDDP"] = jitter_ddp
    out["shimmerLocal"] = shimmer
    # logHNR from the ACF at the pitch period (eGeMAPS's HNRdBACF)
    period = torch.div(f0.new_tensor(float(SR)), f0.clamp_min(52.0))
    lag = torch.round(period).to(torch.int64).clamp(LAG_LO, LAG_HI - 1)
    r_t0 = torch.take_along_dim(acf, lag[..., None], dim=-1)[..., 0]
    r = torch.clamp(r_t0 / (acf[..., 0] + 1e-12), 1e-5, 1.0 - 1e-5)
    out["logHNR"] = torch.where(voiced, 10.0 * torch.log10(r / (1.0 - r)), 0.0)

    # ---- smoothing (mask-aware; voicing contours nonzero-only)
    spect = sma3(torch.stack([out[n] for n in ENERGY_LLDS + SPECTRAL_LLDS], -1), mask)
    voic = _sma3nz(torch.stack([out[n] for n in VOICING_LLDS], -1), mask)
    llds = {n: spect[..., i] for i, n in enumerate(ENERGY_LLDS + SPECTRAL_LLDS)}
    llds.update({n: voic[..., i] for i, n in enumerate(VOICING_LLDS)})
    return llds, (llds["F0final"] > 0) & mask, mask


# ------------------------------------------------------ functional engine


def contour_functionals(x: torch.Tensor, mask: torch.Tensor, names: tuple) -> torch.Tensor:
    """(B, F, D) contours + (B, F) mask -> (B, D * len(names)), LLD-major.

    One masked-reduction engine for every IS13 functional (the JAX
    package's definitions). Empty masks give zeros."""
    B, F, D = x.shape
    f32 = x.dtype
    mb = mask[:, :, None]
    mv = mb.to(f32)
    n = torch.sum(mv, dim=1).clamp_min(1.0)
    hop_s = HOP / SR

    neg = torch.where(mb, x, -torch.inf)
    posi = torch.where(mb, x, torch.inf)
    mx, mn = torch.amax(neg, 1), torch.amin(posi, 1)
    rng = mx - mn

    mean = torch.sum(x * mv, 1) / n
    c = (x - mean[:, None, :]) * mv
    var = torch.sum(c ** 2, 1) / n
    std = torch.sqrt(var)
    sigma = std.clamp_min(1e-12)

    # percentiles (interpolated, masked)
    q1, q2, q3, p1, p99 = _percentiles(x, mv, (0.25, 0.5, 0.75, 0.01, 0.99))

    t = torch.arange(F, dtype=f32, device=x.device)[None, :, None]
    tmean = torch.sum(t * mv, 1) / n
    tc = (t - tmean[:, None, :]) * mv
    stt = torch.sum(tc * tc, 1).clamp_min(1e-12)
    slope = torch.sum(tc * c, 1) / stt
    offset = mean - slope * tmean
    resid = (c - slope[:, None, :] * tc) * mv

    # quadratic regression x ~ A t^2 + B t + C on scaled centred time
    # u = (t - tmean) / F, Gram-Schmidt orthogonalised (as the JAX package)
    u = tc / F
    suu = torch.sum(u * u, 1).clamp_min(1e-12)
    v_raw = u * u * mv
    v = (v_raw - (torch.sum(v_raw, 1) / n)[:, None, :]) * mv
    beta = torch.sum(v * u, 1) / suu
    vp = (v - beta[:, None, :] * u) * mv                   # v orthogonal to u
    svv = torch.sum(vp * vp, 1).clamp_min(1e-12)
    qa_s = torch.sum(vp * c, 1) / svv                      # coeff on u^2 (scaled)
    b_u = torch.sum(u * c, 1) / suu
    qb_s = b_u - qa_s * beta                               # coeff on u (scaled)
    mean_u2 = torch.sum(v_raw, 1) / n
    qa = qa_s / (F * F)                                    # t^2 coefficient
    qb = qb_s / F - 2.0 * tmean * qa                       # t coefficient
    qc = (mean - qa_s * mean_u2 + qa * tmean ** 2 - qb_s * tmean / F)
    qres = (c - b_u[:, None, :] * u - qa_s[:, None, :] * vp) * mv

    # rise/curvature times and slopes
    d = x[:, 1:] - x[:, :-1]
    mm = (mask[:, 1:] & mask[:, :-1])[:, :, None].to(f32)
    rise = torch.sum((d > 0).to(f32) * mm, 1) / torch.sum(mm, 1).clamp_min(1.0)
    d2 = x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]
    mm2 = (mask[:, 2:] & mask[:, 1:-1] & mask[:, :-2])[:, :, None]
    curv = (torch.sum((d2 > 0) & mm2, 1) / torch.sum(mm2, 1).clamp_min(1.0)).to(f32)

    dsl = d * (SR / HOP)

    def selstats(sel):
        cnt = torch.sum(sel, 1)
        ns = cnt.clamp_min(1).to(f32)
        mn_ = torch.sum(torch.where(sel, dsl, 0.0), 1) / ns
        v_ = torch.sum(torch.where(sel, (dsl - mn_[:, None]) ** 2, 0.0), 1) / ns
        ok = cnt > 0
        return torch.where(ok, mn_, 0.0), torch.where(ok, torch.sqrt(v_), 0.0)

    mrs, srs = selstats((d > 0) & (mm > 0))
    mfs, sfs = selstats((d < 0) & (mm > 0))

    # peaks: strict local maxima with both neighbours valid
    mid = x[:, 1:-1]
    pk = torch.zeros_like(x, dtype=torch.bool)
    pk[:, 1:-1] = ((mid > x[:, :-2]) & (mid >= x[:, 2:])
                   & mb[:, 1:-1] & mb[:, :-2] & mb[:, 2:])
    npk = torch.sum(pk.to(f32), 1)
    pkmean = torch.where(npk > 0, torch.sum(torch.where(pk, x, 0.0), 1) / npk.clamp_min(1.0), 0.0)
    pkmax = torch.amax(torch.where(pk, x, -torch.inf), 1)
    pkmin = torch.amin(torch.where(pk, x, torch.inf), 1)
    pk_range = torch.nan_to_num(torch.where(npk > 0, pkmax - pkmin, 0.0),
                                posinf=0.0, neginf=0.0)
    # peak positions -> distances via masked index stats (the JAX package's
    # approximation: the gaps' spread from the positions' spread)
    tpos = t.expand(B, F, D)
    first_pk = torch.amin(torch.where(pk, tpos, torch.inf), 1)
    last_pk = torch.amax(torch.where(pk, tpos, -torch.inf), 1)
    mean_pd = torch.nan_to_num(
        torch.where(npk > 1, (last_pk - first_pk) / (npk - 1.0).clamp_min(1.0), 0.0),
        posinf=0.0, neginf=0.0)
    pos_mean = torch.where(npk > 0, torch.sum(torch.where(pk, tpos, 0.0), 1)
                           / npk.clamp_min(1.0), 0.0)
    pos_var = torch.where(
        npk > 1, torch.sum(torch.where(pk, (tpos - pos_mean[:, None, :]) ** 2, 0.0), 1)
        / npk.clamp_min(1.0), 0.0)
    sd_pd = torch.sqrt((pos_var * 2.0 / (npk - 1.0).clamp_min(1.0)).clamp_min(0.0))

    # LP functionals on the contour (order 5, masked autocorrelation; a lag
    # past the buffer sums nothing, where the JAX slices fail to broadcast)
    xm = x * mv
    r = torch.stack([torch.sum(xm[:, k:] * xm[:, : max(F - k, 0)] * mv[:, k:]
                               * mv[:, : max(F - k, 0)], 1) for k in range(6)], dim=-1)
    r = r / r[..., :1].clamp_min(1e-12)
    lpc = _lpc_levinson(r.reshape(B * D, 6), 5).reshape(B, D, 5)
    # lpgain: prediction error power after order-5 LP, sum_k a_k r_k
    a_ = torch.cat([torch.ones_like(lpc[..., :1]), -lpc], -1)
    lpg = torch.abs(torch.sum(a_ * r, -1))

    # segments above the mean
    above = (x > mean[:, None, :]) & mb
    nseg = torch.sum((above & ~_shift(above, 1, False)).to(f32), 1)
    seg_total = torch.sum(above.to(f32), 1)
    mean_seg = torch.where(nseg > 0, seg_total / nseg.clamp_min(1.0), 0.0)
    max_seg = torch.amax(run_length(above), 1)

    absx = torch.abs(x)
    absmean = torch.sum(absx * mv, 1) / n
    flat = (torch.exp(torch.sum(torch.log(absx.clamp_min(1e-12)) * mv, 1) / n)
            / absmean.clamp_min(1e-12))
    possel = (x > 0) & mb
    posamean = torch.sum(torch.where(possel, x, 0.0), 1) / torch.sum(possel, 1).clamp_min(1)
    centroid = torch.sum(t * absx * mv, 1) / torch.sum(absx * mv, 1).clamp_min(1e-12)

    def uplevel(frac):
        above_thr = (x > (mn + frac * rng)[:, None, :]) & mb
        return torch.sum(above_thr.to(f32), 1) / n

    cols = {
        "quartile1": q1, "quartile2": q2, "quartile3": q3,
        "iqr1-2": q2 - q1, "iqr2-3": q3 - q2, "iqr1-3": q3 - q1,
        "percentile1.0": p1, "percentile99.0": p99, "pctlrange0-1": p99 - p1,
        "amean": mean, "rqmean": torch.sqrt(torch.sum(x * x * mv, 1) / n),
        "flatness": flat, "stddev": std,
        "skewness": torch.sum(c ** 3, 1) / n / sigma ** 3,
        "kurtosis": torch.sum(c ** 4, 1) / n / var.clamp_min(1e-12) ** 2,
        "upleveltime25": uplevel(0.25), "upleveltime50": uplevel(0.50),
        "upleveltime75": uplevel(0.75), "upleveltime90": uplevel(0.90),
        "risetime": rise, "curvtime": curv,
        "maxPos": torch.argmax(neg, 1).to(f32),
        "minPos": torch.argmin(posi, 1).to(f32),
        "linregc1": slope, "linregc2": offset,
        "linregerrA": torch.sum(torch.abs(resid), 1) / n,
        "linregerrQ": torch.sum(resid ** 2, 1) / n,
        "qregc1": qa, "qregc2": qb, "qregc3": qc,
        "qregerrA": torch.sum(torch.abs(qres), 1) / n,
        "qregerrQ": torch.sum(qres ** 2, 1) / n,
        "meanPeakDist": mean_pd, "peakDistStddev": sd_pd,
        "peakMean": pkmean, "peakMeanMeanDist": pkmean - mean,
        "peakRangeAbs": pk_range,
        "peakRangeRel": pk_range / torch.abs(rng).clamp_min(1e-12),
        "meanRisingSlope": mrs, "stddevRisingSlope": srs,
        "meanFallingSlope": torch.abs(mfs), "stddevFallingSlope": sfs,
        "centroid": centroid, "posamean": posamean, "absmean": absmean,
        "maxmeandist": mx - mean,
        "lpgain": lpg, "lpc0": lpc[..., 0], "lpc1": lpc[..., 1],
        "lpc2": lpc[..., 2], "lpc3": lpc[..., 3], "lpc4": lpc[..., 4],
        "meanSegLen": mean_seg * hop_s,
        "maxSegLen": max_seg * hop_s,
    }
    return finish(torch.stack([cols[f] for f in names], dim=-1), mv)


def is13_frame(wav: torch.Tensor, lengths: torch.Tensor):
    """Frame-level IS13: (B, T) -> ((B, F, 120), (B, F) mask): the 60
    ``_sma`` contours then their 60 ``_sma_de`` deltas."""
    llds, _, mask = _lld_core(wav.to(torch.float32), lengths)
    return frame_contours(llds, mask), mask


def frame_contours(llds: dict, mask: torch.Tensor) -> torch.Tensor:
    """:func:`_lld_core`'s contours -> the (B, F, 120) frame columns."""
    x = torch.stack([llds[n] for n in FRAME_LLDS], dim=-1)
    return torch.cat([x, _delta2(x, torch.sum(mask, dim=1))], dim=-1)


def _seg_stats(seg: torch.Tensor):
    """(B, F) bool -> mean, stddev, max and min length (frames) of its
    runs, 0 where it has none."""
    f32 = torch.float32
    ns = onsets(seg)
    mean_l = torch.where(ns > 0, torch.sum(seg.to(f32), 1) / ns.clamp_min(1.0), 0.0)
    ends = seg & ~torch.cat([seg[:, 1:], torch.zeros_like(seg[:, :1])], 1)
    runs = run_length(seg)
    lens = torch.where(ends, runs, 0.0)
    mn_l = torch.amin(torch.where(ends, runs, torch.inf), 1)
    mn_l = torch.nan_to_num(torch.where(ns > 0, mn_l, 0.0), posinf=0.0)
    v_ = (torch.sum(lens ** 2, 1) / ns.clamp_min(1.0) - mean_l ** 2).clamp_min(0.0)
    return mean_l, torch.sqrt(v_), torch.amax(lens, 1), mn_l


def semitones(f0: torch.Tensor) -> torch.Tensor:
    """``12 log2(max(f0, 1) / 27.5)`` as XLA evaluates it: the quotient as a
    product with f32(1/27.5), then ln times f32(12 / ln 2)."""
    return (torch.log(f0.clamp_min(1.0) * np.float32(1 / 27.5))
            * np.float32(12 / np.log(2.0)))


def is13_utt(wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Utterance-level IS13: (B, T) -> (B, 6372) in ``IS13_NAMES`` order."""
    return utt_functionals(*_lld_core(wav.to(torch.float32), lengths))


def is13_levels(wav: torch.Tensor, lengths: torch.Tensor):
    """Both levels from one contour pass: (:func:`is13_utt`, then
    :func:`is13_frame`'s frames and mask)."""
    llds, voiced, mask = _lld_core(wav.to(torch.float32), lengths)
    return utt_functionals(llds, voiced, mask), frame_contours(llds, mask), mask


def functional_blocks(llds: dict, voiced: torch.Tensor, mask: torch.Tensor) -> list:
    """:func:`_lld_core`'s contours -> the utterance functionals' inputs in
    column order, a (contours (B, F, D), mask (B, F), functional names)
    block each for :func:`block_functionals`."""
    n_valid = torch.sum(mask, dim=1)
    spect = torch.stack([llds[n] for n in ENERGY_LLDS + SPECTRAL_LLDS], -1)
    voic = torch.stack([llds[n] for n in VOICING_LLDS], -1)
    return [(spect, mask, FUNCS_A), (_delta2(spect, n_valid), mask, FUNCS_A_DE),
            (voic, voiced, FUNCS_B), (_delta2(voic, n_valid), voiced, FUNCS_B_DE)]


block_functionals = contour_functionals


def utt_functionals(llds: dict, voiced: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`_lld_core`'s contours -> the 6,372 functionals."""
    f32 = torch.float32
    n_valid = torch.sum(mask, dim=1)
    parts = [contour_functionals(*b) for b in functional_blocks(llds, voiced, mask)]

    # temporal set (22)
    hop_s = HOP / SR
    dur = n_valid.to(f32) * hop_s
    nseg = onsets(voiced)
    v_mean, v_std, v_max, v_min = _seg_stats(voiced)
    u_mean, u_std, u_max, u_min = _seg_stats(mask & ~voiced)

    # loudness peaks on the audspec L1-norm contour (both neighbours valid)
    loud = llds["audspec_lengthL1norm"]
    is_pk = torch.zeros_like(mask)
    is_pk[:, 1:-1] = ((loud[:, 1:-1] > loud[:, :-2]) & (loud[:, 1:-1] >= loud[:, 2:])
                      & mask[:, 1:-1] & mask[:, 2:])
    npk = torch.sum(is_pk.to(f32), 1)
    tgrid = torch.arange(loud.shape[1], dtype=f32, device=loud.device)[None]
    fpk = torch.amin(torch.where(is_pk, tgrid, torch.inf), 1)
    lpk = torch.amax(torch.where(is_pk, tgrid, -torch.inf), 1)
    mean_pkd = torch.nan_to_num(
        torch.where(npk > 1, (lpk - fpk) / (npk - 1).clamp_min(1.0), 0.0) * hop_s,
        posinf=0.0, neginf=0.0)
    pos_mean = torch.where(npk > 0, torch.sum(torch.where(is_pk, tgrid, 0.0), 1)
                           / npk.clamp_min(1.0), 0.0)
    pos_var = torch.where(npk > 1, torch.sum(
        torch.where(is_pk, (tgrid - pos_mean[:, None]) ** 2, 0.0), 1) / npk.clamp_min(1.0), 0.0)
    sd_pkd = torch.sqrt((pos_var * 2.0 / (npk - 1.0).clamp_min(1.0)).clamp_min(0.0)) * hop_s
    amp_pk = torch.where(npk > 0, torch.sum(torch.where(is_pk, loud, 0.0), 1)
                         / npk.clamp_min(1.0), 0.0)

    # F0 semitone summary over voiced frames (of the smoothed F0 contour)
    semi = torch.where(voiced, semitones(llds["F0final"]), 0.0)
    mvv = voiced.to(f32)
    nv = torch.sum(mvv, 1).clamp_min(1.0)
    sm_mean = torch.sum(semi * mvv, 1) / nv
    sm_var = torch.sum(((semi - sm_mean[:, None]) * mvv) ** 2, 1) / nv
    p20, p50, p80 = _percentiles(semi, mvv, (0.2, 0.5, 0.8))

    temporal = torch.stack([
        nseg, nseg / dur.clamp_min(1e-6),
        v_mean * hop_s, v_std * hop_s, v_max * hop_s, v_min * hop_s,
        torch.sum(mvv, 1) / n_valid.to(f32).clamp_min(1.0),
        u_mean * hop_s, u_std * hop_s, u_max * hop_s, u_min * hop_s,
        npk / dur.clamp_min(1e-6), mean_pkd, sd_pkd, amp_pk,
        sm_mean, torch.sqrt(sm_var), p20, p50, p80, p80 - p20, dur], dim=-1)
    out = torch.cat(parts + [temporal], dim=-1)
    assert out.shape[-1] == 6372, out.shape
    return out
