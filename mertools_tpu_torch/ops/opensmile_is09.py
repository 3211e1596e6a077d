"""openSMILE ``IS09_emotion.conf`` feature chain, batched on the tensor's
device — port of ``mertools_tpu/ops/opensmile_is09.py``.

The reference shells out to the openSMILE binary with
``config/IS09_emotion.conf`` (``MERBench/feature_extraction/audio/
handcrafted_feature_func.py:35-36,97-124``). The component chain, as the
JAX package defines it:

- ``cFramer`` 25 ms / 10 ms, left-aligned complete frames only
  (nF = 1 + (T-400)//160 at 16 kHz, at least one frame);
- ``cEnergy rms=1`` and ``cMZcr zcr=1`` on the raw frames;
- MFCC: HTK pre-emphasis inside each frame (``y[0] = x[0]*(1-k)``),
  symmetric Hamming, |rfft| at 512, 26 HTK mel bands (20-8000 Hz, unit
  peak) on the magnitude, log floored at 1e-8, HTK DCT c1..c12 with
  liftering L=22;
- ``cPitchACF``: ACF = irfft(|X|^2); voiceProb = clip(max over lags
  32..255 of acf/acf[0], 0, 1); F0 = sr / lag of that maximum, 0 where
  voiceProb <= 0.55;
- ``cContourSmoother smaWin=3``, mask-aware; ``cDeltaRegression
  deltawin=2``, edges replicated at each row's last valid frame;
- the 12 functionals per contour (biased moments, kurtosis not excess,
  first-occurrence maxPos/minPos as raw frame indices).

Frames past a row's length are masked everywhere, so a clip padded to its
bucket gives what it gives alone. The spectra are ``torch.fft`` and the mel
and DCT products fp32 matmuls; the tables are numpy copies of the JAX
package's, uploaded once a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from .fbank import frame_signal

SR = 16000
FRAME_LEN = 400          # 25 ms @ 16 kHz
HOP = 160                # 10 ms
N_FFT = 512              # next pow2 >= 400 (cTransformFFT)
N_MEL = 26
PREEMPH = 0.97
CEP_LIFTER = 22
MAX_PITCH = 500.0        # cPitchACF maxPitch
VOICING_CUTOFF = 0.55    # cPitchACF voicingCutoff default
MEL_FLOOR = 1e-8         # log floor for digital silence

FUNCTIONALS = ("max", "min", "range", "maxPos", "minPos", "amean",
               "linregc1", "linregc2", "linregerrQ", "stddev",
               "skewness", "kurtosis")

LLD_NAMES = (("pcm_RMSenergy", "pcm_zcr", "voiceProb", "F0")
             + tuple(f"mfcc{i}" for i in range(1, 13)))
# the reference's CSV columns: 16 ``_sma`` contours then their ``_sma_de``
FRAME_NAMES = (tuple(f"{n}_sma" for n in LLD_NAMES)
               + tuple(f"{n}_sma_de" for n in LLD_NAMES))
UTT_NAMES = tuple(f"{c}_{f}" for c in FRAME_NAMES for f in FUNCTIONALS)


def n_frames(T: int) -> int:
    return max(1 + (T - FRAME_LEN) // HOP, 1)


def hamming(n: int) -> np.ndarray:
    return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
            ).astype(np.float32)


def htk_mel_bank(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MEL,
                 fmin: float = 20.0, fmax: float = 8000.0) -> np.ndarray:
    """HTK triangular filters (n_mels, n_fft//2+1), unit peak height."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def from_mel(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * sr / n_fft
    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = from_mel(mel_pts)
    fb = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-9)
        dn = (hi - fft_freqs) / max(hi - c, 1e-9)
        fb[m] = np.maximum(0.0, np.minimum(up, dn))
    return fb


def htk_dct_lifter(n_out: int = 12, n_in: int = N_MEL,
                   lifter: int = CEP_LIFTER) -> np.ndarray:
    """(n_out, n_in) HTK DCT rows for c_1..c_n_out, liftering folded in."""
    j = np.arange(1, n_out + 1)[:, None]
    m = np.arange(1, n_in + 1)[None, :]
    D = np.sqrt(2.0 / n_in) * np.cos(np.pi * j * (m - 0.5) / n_in)
    lift = 1.0 + (lifter / 2.0) * np.sin(np.pi * j[:, 0] / lifter)
    return (D * lift[:, None]).astype(np.float32)


def preemphasis_htk(raw: torch.Tensor, k: float = PREEMPH) -> torch.Tensor:
    """HTK pre-emphasis inside each frame (last axis): y[0] = x[0]*(1-k)."""
    return torch.cat([raw[..., :1] * (1.0 - k), raw[..., 1:] - k * raw[..., :-1]], dim=-1)


def valid_frames(lengths: torch.Tensor, nF: int, win: int) -> torch.Tensor:
    """(B,) lengths -> (B, nF) mask of frames of ``win`` that end inside
    the clip (frame 0 always)."""
    starts = torch.arange(nF, device=lengths.device) * HOP
    return (starts[None, :] + win) <= lengths.clamp_min(win)[:, None]


def sma3(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """cContourSmoother smaWin=3 along dim 1 of (B, F) or (B, F, D), the
    window truncated at the contour's edges and at each row's last valid
    frame: frames past ``mask`` never leak into valid ones."""
    mv = (mask if x.dim() == 2 else mask[:, :, None]).to(x.dtype)
    xm = x * mv

    def three(a):
        z = torch.zeros_like(a[:, :1])
        return torch.cat([z, a[:, :-1]], 1) + a + torch.cat([a[:, 1:], z], 1)

    return torch.where(mv > 0, three(xm) / three(mv).clamp_min(1.0), x)


def _delta2(x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """cDeltaRegression deltawin=2: HTK delta, edges replicated at each
    row's LAST VALID frame (``n_valid`` (B,)), not the padded buffer end.
    The division by 10 is a product with f32(0.1), as XLA evaluates it (and
    as CUDA divides by a scalar), so the deltas have the same bits on every
    device: the IS10 and IS13 functionals split frames by the sign of their
    differences, which is 0 on a flat stretch only if the bits agree."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    hi = (n_valid[:, None] - 1).clamp_min(0)

    def g(off):
        idx = torch.minimum((t + off).clamp_min(0), hi)
        return torch.take_along_dim(x, idx[:, :, None], dim=1)

    return (1.0 * (g(1) - g(-1)) + 2.0 * (g(2) - g(-2))) * 0.1


def _lld_core(wav: torch.Tensor, lengths: torch.Tensor):
    """(B, T), (B,) -> (B, F, 16) smoothed LLDs + (B, F) frame mask."""
    dev = wav.device
    nF = n_frames(wav.shape[1])
    mask = valid_frames(lengths, nF, FRAME_LEN)
    raw = frame_signal(wav, nF, FRAME_LEN, HOP)                 # (B,F,400)

    # -- energy / zcr on raw frames (cEnergy rms=1, cMZcr zcr=1)
    rms = torch.sqrt(torch.mean(raw ** 2, dim=-1))
    zc = (raw[..., 1:] * raw[..., :-1] < 0).to(torch.float32)
    zcr = torch.sum(zc, dim=-1) / (FRAME_LEN - 1)

    # -- preemphasis (HTK within-frame) + Hamming
    win = preemphasis_htk(raw) * on_device(hamming, dev, FRAME_LEN)
    spec = torch.fft.rfft(win, n=N_FFT, dim=-1)
    mag = torch.abs(spec)                                       # (B,F,257)

    # -- MFCC 1..12 (HTK-compatible)
    mel = mag @ on_device(htk_mel_bank, dev).T
    logmel = torch.log(mel.clamp_min(MEL_FLOOR))
    mfcc = logmel @ on_device(htk_dct_lifter, dev).T            # (B,F,12)

    # -- cPitchACF: ACF peak -> voicing probability and F0
    acf = torch.fft.irfft(mag ** 2, n=N_FFT, dim=-1)            # (B,F,512)
    lag_lo = int(np.ceil(SR / MAX_PITCH))                       # 32
    lag_hi = N_FFT // 2                                         # 256 (62.5 Hz)
    acn = acf[..., lag_lo:lag_hi] / (acf[..., :1] + 1e-12)
    voice_prob = torch.clamp(torch.amax(acn, dim=-1), 0.0, 1.0)
    f0_raw = SR / (torch.argmax(acn, dim=-1) + lag_lo).to(torch.float32)
    f0 = torch.where(voice_prob > VOICING_CUTOFF, f0_raw, 0.0)

    lld = torch.cat([rms[..., None], zcr[..., None], voice_prob[..., None],
                     f0[..., None], mfcc], dim=-1)              # (B,F,16)
    return sma3(lld, mask), mask


def is09_frame(wav: torch.Tensor, lengths: torch.Tensor):
    """Frame-level IS09: (B, T) -> ((B, F, 32), (B, F) mask), in the
    ``-lldcsvoutput`` CSV's column order (``FRAME_NAMES``)."""
    sma, mask = _lld_core(wav.to(torch.float32), lengths)
    n_valid = mask.sum(dim=1)
    return torch.cat([sma, _delta2(sma, n_valid)], dim=-1), mask


def functionals_12(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The IS09 functional grid over (B, F, D) -> (B, D*12), LLD-major."""
    mb = mask[:, :, None]
    m = mb.to(x.dtype)
    n = m.sum(dim=1).clamp_min(1.0)                             # (B,1)

    neg = torch.where(mb, x, -torch.inf)
    pos = torch.where(mb, x, torch.inf)
    mx, mn = neg.amax(dim=1), pos.amin(dim=1)
    max_pos = neg.argmax(dim=1).to(x.dtype)
    min_pos = pos.argmin(dim=1).to(x.dtype)

    mean = (x * m).sum(dim=1) / n
    c = (x - mean[:, None, :]) * m
    var = (c ** 2).sum(dim=1) / n
    std = torch.sqrt(var)
    sigma = std.clamp_min(1e-12)
    skew = (c ** 3).sum(dim=1) / n / sigma ** 3
    kurt = (c ** 4).sum(dim=1) / n / var.clamp_min(1e-12) ** 2

    t = torch.arange(x.shape[1], dtype=x.dtype, device=x.device)[None, :, None]
    tmean = (t * m).sum(dim=1) / n
    tc = (t - tmean[:, None, :]) * m
    stt = (tc * tc).sum(dim=1).clamp_min(1e-12)
    slope = (tc * c).sum(dim=1) / stt
    offset = mean - slope * tmean
    resid = (c - slope[:, None, :] * tc) * m
    errq = (resid ** 2).sum(dim=1) / n

    cols = {"max": mx, "min": mn, "range": mx - mn, "maxPos": max_pos,
            "minPos": min_pos, "amean": mean, "linregc1": slope,
            "linregc2": offset, "linregerrQ": errq, "stddev": std,
            "skewness": skew, "kurtosis": kurt}
    per_lld = torch.stack([cols[f] for f in FUNCTIONALS], dim=-1)  # (B,D,12)
    return per_lld.reshape(x.shape[0], -1)


def is09_utt(wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Utterance-level IS09: (B, T) -> (B, 384), 32 contours x 12
    functionals, LLD-major (``UTT_NAMES``)."""
    x32, mask = is09_frame(wav, lengths)
    return functionals_12(x32, mask)


def is09_levels(wav: torch.Tensor, lengths: torch.Tensor):
    """Both levels from one contour pass: (:func:`is09_utt`, then
    :func:`is09_frame`'s frames and mask)."""
    x32, mask = is09_frame(wav, lengths)
    return functionals_12(x32, mask), x32, mask
