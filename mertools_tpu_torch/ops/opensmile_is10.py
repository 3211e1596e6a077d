"""openSMILE ``IS10_paraling.conf`` feature chain, batched on the tensor's
device — port of ``mertools_tpu/ops/opensmile_is10.py``.

The reference extracts IS10 with the openSMILE binary and
``config/IS10_paraling.conf`` (``MERBench/feature_extraction/audio/
handcrafted_feature_func.py:37,50-51``); its contract is 32 columns a
frame and 1,582 an utterance (``:18``). The chain, as the JAX package
defines it (its docstring lists the documented departures from the
binary), assembled from the IS09 and eGeMAPS components and the LPC/LSP
helpers of :mod:`.handcrafted`:

- 38 LLDs on 25 ms / 10 ms frames, ``sma3``-smoothed: the standard group
  (34) pcm_loudness, HTK MFCC 0-14, 8 log mel bands, lspFreq 0-7 (LPC
  order 8), F0finEnv (sample-and-hold of F0), voicingFinalUnclipped (the
  60 ms ACF maximum, unclipped); the pitch group (4) F0final (SHS + Viterbi
  over 180 candidates 52-620 Hz, voiced where the ACF maximum passes 0.70),
  jitterLocal, jitterDDP, shimmerLocal (nonzero-only smoothing);
- HTK deltas of all 38;
- 21 functionals on the standard group and its deltas, 19 on the pitch
  group and its deltas over voiced frames only, then numOnsets and
  turnDuration: 1428 + 152 + 2 = 1582.

The pitch windows clamp to each row's last valid sample, so a clip padded
to its bucket reads what it reads alone. The Viterbi pass is eGeMAPS's
(:func:`.egemaps._viterbi_f0` on this grid, one batched step a frame).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from . import egemaps as eg
from .fbank import frame_signal
from .handcrafted import _lpc_levinson, _lsp_from_lpc
from .opensmile_is09 import (FRAME_LEN, HOP, MEL_FLOOR, N_FFT, SR, _delta2, hamming,
                             htk_mel_bank, n_frames, preemphasis_htk, sma3, valid_frames)

F0_LO, F0_HI = 52.0, 620.0        # IS10_paraling cPitchShs range
N_CAND = 180                      # log-spaced candidates (~21 cents)
GRID = (F0_LO, F0_HI, N_CAND)
VOICING_CUTOFF = 0.70             # cPitchShs voicingCutoff default
WIN_P = 960                       # 60 ms Gaussian pitch window
NFFT_P = 1024
LPC_ORDER = 8
LAG_LO = int(SR / F0_HI)                          # 25
LAG_HI = min(int(SR / F0_LO) + 1, NFFT_P // 2)    # 308

FUNCTIONALS_21 = ("maxPos", "minPos", "amean", "linregc1", "linregc2",
                  "linregerrA", "linregerrQ", "stddev", "skewness",
                  "kurtosis", "quartile1", "quartile2", "quartile3",
                  "iqr1-2", "iqr2-3", "iqr1-3", "percentile1.0",
                  "percentile99.0", "pctlrange0-1", "upleveltime75",
                  "upleveltime90")
FUNCTIONALS_19 = FUNCTIONALS_21[2:]          # pitch group drops maxPos/minPos

LLD_STD = (("pcm_loudness",) + tuple(f"mfcc{i}" for i in range(15))
           + tuple(f"logMelFreqBand{i}" for i in range(8))
           + tuple(f"lspFreq{i}" for i in range(8))
           + ("F0finEnv", "voicingFinalUnclipped"))        # 34
LLD_PITCH = ("F0final", "jitterLocal", "jitterDDP", "shimmerLocal")  # 4
LLD_FRAME = LLD_STD[:32]                                   # lld CSV: 32

IS10_NAMES = tuple(
    [f"{n}_sma_{f}" for n in LLD_STD for f in FUNCTIONALS_21]
    + [f"{n}_sma_de_{f}" for n in LLD_STD for f in FUNCTIONALS_21]
    + [f"{n}_sma_{f}" for n in LLD_PITCH for f in FUNCTIONALS_19]
    + [f"{n}_sma_de_{f}" for n in LLD_PITCH for f in FUNCTIONALS_19]
    + ["F0final_numOnsets", "turnDuration"])
assert len(IS10_NAMES) == 1582, len(IS10_NAMES)


def htk_dct_c0(n_out: int = 15, n_in: int = 26) -> np.ndarray:
    """(n_out, n_in) HTK DCT rows c0..c(n_out-1), liftering L=22 folded in
    (the c0 row unliftered: sin(0) = 0)."""
    j = np.arange(0, n_out)[:, None]
    m = np.arange(1, n_in + 1)[None, :]
    D = np.sqrt(2.0 / n_in) * np.cos(np.pi * j * (m - 0.5) / n_in)
    lift = 1.0 + 11.0 * np.sin(np.pi * j[:, 0] / 22.0)
    return (D * lift[:, None]).astype(np.float32)


def _frames_at_valid(x: torch.Tensor, nF: int, win: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, nF, win) frames whose indices clamp to each row's last
    valid sample (not the buffer's end): each row is first extended with
    its last valid sample, then framed."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    held = torch.minimum(t, (lengths.clamp_min(1) - 1)[:, None])
    return frame_signal(torch.gather(x, 1, held), nF, win, HOP)


def sample_and_hold(f0: torch.Tensor) -> torch.Tensor:
    """Each frame's last nonzero value of ``f0`` (B, F) at or before it, 0
    before the first: the running maximum of the last voiced frame's index,
    then a gather (equal to the frame-by-frame hold)."""
    t = torch.arange(f0.shape[1], device=f0.device)[None, :]
    last = torch.cummax(torch.where(f0 > 0, t, -1), dim=1).values
    return torch.where(last >= 0, torch.gather(f0, 1, last.clamp_min(0)), 0.0)


def pitch_branch(wav: torch.Tensor, lengths: torch.Tensor, mask: torch.Tensor):
    """The 60 ms Gaussian pitch branch IS10 and IS13 share: (f0 in Hz, 0
    unvoiced; voiced; the unclipped ACF maximum; jitter, jitterDDP, shimmer;
    the ACF), each (B, F) but the ACF (B, F, NFFT_P)."""
    dev = wav.device
    nF = mask.shape[1]
    fr_p = _frames_at_valid(wav, nF, WIN_P, lengths) * on_device(eg._gauss_win, dev, WIN_P)
    mag_p = torch.abs(torch.fft.rfft(fr_p, n=NFFT_P, dim=-1))
    acf = torch.fft.irfft(mag_p ** 2, n=NFFT_P, dim=-1)
    acn = acf[..., LAG_LO:LAG_HI] / (acf[..., :1] + 1e-12)
    p_voiced = torch.amax(acn, dim=-1)                          # UNCLIPPED
    state = eg._viterbi_f0(eg._shs_scores(mag_p, GRID), p_voiced.clamp(0.0, 1.0), mask, GRID)
    f0 = on_device(eg._cand_hz, dev, GRID)[state]
    voiced = (f0 > 0) & (p_voiced > VOICING_CUTOFF) & mask
    f0 = torch.where(voiced, f0, 0.0)

    # jitter / shimmer: frame-contour proxies
    per = torch.where(voiced, 1.0 / f0.clamp_min(1.0), 0.0)
    per_prev = eg._shift(per, 1)
    both = voiced & (per_prev > 0)
    jit = torch.abs(per - per_prev) / ((per + per_prev) / 2).clamp_min(1e-6)
    jitter = torch.where(both, jit, 0.0)
    both3 = both & eg._shift(both, 1, False)
    jitter_ddp = torch.where(both3, torch.abs(jitter - eg._shift(jitter, 1)), 0.0)
    rms_p = torch.sqrt(torch.mean(fr_p ** 2, dim=-1) + 1e-12)
    rms_prev = eg._shift(rms_p, 1, 1e-6)
    shim = torch.abs(rms_p - rms_prev) / ((rms_p + rms_prev) / 2).clamp_min(1e-8)
    shimmer = torch.where(both, shim, 0.0)
    return f0, voiced, p_voiced, jitter, jitter_ddp, shimmer, acf


def _lld_core(wav: torch.Tensor, lengths: torch.Tensor):
    """(B, T), (B,) -> (std (B,F,34), pitch (B,F,4), voiced (B,F), mask)."""
    dev = wav.device
    B, T = wav.shape
    nF = n_frames(T)
    mask = valid_frames(lengths, nF, FRAME_LEN)
    raw = frame_signal(wav, nF, FRAME_LEN, HOP)                 # (B,F,400)
    ham_np = hamming(FRAME_LEN)
    ham = on_device(hamming, dev, FRAME_LEN)

    # -- pcm_loudness: Zwicker (I/I0)^0.3 of the Hamming-weighted intensity
    intensity = torch.sum(raw ** 2 * ham, dim=-1) / float(np.sum(ham_np))
    loudness = (intensity.clamp_min(0.0) / 1e-6) ** 0.3

    # -- HTK MFCC 0-14 (the IS09 chain with c0)
    win = preemphasis_htk(raw) * ham
    mag = torch.abs(torch.fft.rfft(win, n=N_FFT, dim=-1))       # (B,F,257)
    logmel26 = torch.log((mag @ on_device(htk_mel_bank, dev).T).clamp_min(MEL_FLOOR))
    mfcc = logmel26 @ on_device(htk_dct_c0, dev).T              # (B,F,15)

    # -- logMelFreqBand 0-7 (8 HTK mel bands, log magnitude energies)
    fb8 = on_device(htk_mel_bank, dev, SR, N_FFT, 8, 20.0, 8000.0)
    logmel8 = torch.log((mag @ fb8.T).clamp_min(MEL_FLOOR))     # (B,F,8)

    # -- lspFreq 0-7 from LPC order 8 of the windowed frame's autocorrelation
    pw = torch.fft.rfft(win, n=2 * N_FFT, dim=-1)
    acf_w = torch.fft.irfft(pw.real ** 2 + pw.imag ** 2, n=2 * N_FFT,
                            dim=-1)[..., : LPC_ORDER + 1]
    lpc = _lpc_levinson(acf_w.reshape(B * nF, LPC_ORDER + 1), LPC_ORDER)
    lsp = _lsp_from_lpc(lpc, LPC_ORDER).reshape(B, nF, LPC_ORDER)   # rad

    f0, voiced, p_voiced, jitter, jitter_ddp, shimmer, _ = pitch_branch(wav, lengths, mask)
    std = torch.cat([loudness[..., None], mfcc, logmel8, lsp,
                     sample_and_hold(f0)[..., None], p_voiced[..., None]], dim=-1)  # 34
    pitch = torch.stack([f0, jitter, jitter_ddp, shimmer], dim=-1)  # (B,F,4)
    std = sma3(std, mask)
    pitch = eg._sma3nz(pitch, mask)
    return std, pitch, (pitch[..., 0] > 0) & mask, mask


def finish(per_lld: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, D, n_funcs) -> (B, D * n_funcs): zeros where a mask is empty,
    and inf / nan as 0."""
    ok = torch.sum(m, dim=1) > 0
    per_lld = torch.where(ok[..., None], per_lld, 0.0)
    return torch.nan_to_num(per_lld, nan=0.0, posinf=0.0, neginf=0.0).reshape(
        per_lld.shape[0], -1)


def functionals_21(x: torch.Tensor, mask: torch.Tensor,
                   drop_extremes: bool = False) -> torch.Tensor:
    """(B, F, D), (B, F) -> (B, D * n_funcs), LLD-major, in
    :data:`FUNCTIONALS_21` order (19 when ``drop_extremes``)."""
    F = x.shape[1]
    mb = mask[:, :, None]
    m = mb.to(x.dtype)
    n = torch.sum(m, dim=1).clamp_min(1.0)

    neg = torch.where(mb, x, -torch.inf)
    pos = torch.where(mb, x, torch.inf)
    mx, mn = torch.amax(neg, dim=1), torch.amin(pos, dim=1)

    mean = torch.sum(x * m, dim=1) / n
    c = (x - mean[:, None, :]) * m
    var = torch.sum(c ** 2, dim=1) / n
    std = torch.sqrt(var)
    skew = torch.sum(c ** 3, dim=1) / n / std.clamp_min(1e-12) ** 3
    kurt = torch.sum(c ** 4, dim=1) / n / var.clamp_min(1e-12) ** 2

    t = torch.arange(F, dtype=x.dtype, device=x.device)[None, :, None]
    tmean = torch.sum(t * m, dim=1) / n
    tc = (t - tmean[:, None, :]) * m
    stt = torch.sum(tc * tc, dim=1).clamp_min(1e-12)
    slope = torch.sum(tc * c, dim=1) / stt
    offset = mean - slope * tmean
    resid = (c - slope[:, None, :] * tc) * m

    # interpolated percentiles over the masked values (eGeMAPS method)
    q1, q2, q3, p1, p99 = eg._percentiles(x, m, (0.25, 0.5, 0.75, 0.01, 0.99))
    rng = mx - mn

    def uplevel(frac):
        above = (x > (mn + frac * rng)[:, None, :]) & mb
        return torch.sum(above.to(x.dtype), dim=1) / n

    cols = {"maxPos": torch.argmax(neg, dim=1).to(x.dtype),
            "minPos": torch.argmin(pos, dim=1).to(x.dtype), "amean": mean,
            "linregc1": slope, "linregc2": offset,
            "linregerrA": torch.sum(torch.abs(resid), dim=1) / n,
            "linregerrQ": torch.sum(resid ** 2, dim=1) / n, "stddev": std,
            "skewness": skew, "kurtosis": kurt, "quartile1": q1, "quartile2": q2,
            "quartile3": q3, "iqr1-2": q2 - q1, "iqr2-3": q3 - q2,
            "iqr1-3": q3 - q1, "percentile1.0": p1, "percentile99.0": p99,
            "pctlrange0-1": p99 - p1, "upleveltime75": uplevel(0.75),
            "upleveltime90": uplevel(0.90)}
    funcs = FUNCTIONALS_19 if drop_extremes else FUNCTIONALS_21
    return finish(torch.stack([cols[f] for f in funcs], dim=-1), m)


def onsets(voiced: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B,) voiced-segment starts."""
    return torch.sum((voiced & ~eg._shift(voiced, 1, False)).to(torch.float32), dim=1)


def is10_frame(wav: torch.Tensor, lengths: torch.Tensor):
    """Frame-level IS10: (B, T) -> ((B, F, 32), (B, F) mask), the 32
    ``_sma`` spectral-branch contours of the reference's lld CSV."""
    std, _, _, mask = _lld_core(wav.to(torch.float32), lengths)
    return std[..., :32], mask


def is10_utt(wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Utterance-level IS10: (B, T) -> (B, 1582) in ``IS10_NAMES`` order."""
    return utt_functionals(*_lld_core(wav.to(torch.float32), lengths))


def is10_levels(wav: torch.Tensor, lengths: torch.Tensor):
    """Both levels from one contour pass: (:func:`is10_utt`, then
    :func:`is10_frame`'s frames and mask)."""
    parts = _lld_core(wav.to(torch.float32), lengths)
    return utt_functionals(*parts), parts[0][..., :32], parts[3]


def functional_blocks(std: torch.Tensor, pitch: torch.Tensor, voiced: torch.Tensor,
                      mask: torch.Tensor) -> list:
    """:func:`_lld_core`'s contours -> the utterance functionals' inputs in
    column order, a (contours (B, F, D), mask (B, F), functional names)
    block each for :func:`block_functionals`."""
    n_valid = torch.sum(mask, dim=1)
    return [(std, mask, FUNCTIONALS_21), (_delta2(std, n_valid), mask, FUNCTIONALS_21),
            # the pitch group's functionals run over voiced frames only
            (pitch, voiced, FUNCTIONALS_19), (_delta2(pitch, n_valid), voiced, FUNCTIONALS_19)]


def block_functionals(x: torch.Tensor, mask: torch.Tensor, funcs: tuple) -> torch.Tensor:
    """One block of :func:`functional_blocks` -> its (B, D * len(funcs))
    columns."""
    return functionals_21(x, mask, drop_extremes=funcs == FUNCTIONALS_19)


def utt_functionals(std: torch.Tensor, pitch: torch.Tensor, voiced: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """:func:`_lld_core`'s contours -> the 1,582 functionals."""
    dur = torch.sum(mask, dim=1).to(torch.float32) * (HOP / SR)
    out = torch.cat([block_functionals(*b) for b in functional_blocks(std, pitch, voiced, mask)]
                    + [torch.stack([onsets(voiced), dur], dim=-1)], dim=-1)
    assert out.shape[-1] == 1582, out.shape
    return out
