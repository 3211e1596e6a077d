"""Whisper-compatible log-mel spectrogram — port of ``mertools_tpu/ops/mel.py``.

Replaces the reference's host-side numpy ``WhisperFeatureExtractor``
(``extract_audio_huggingface.py:83-91`` produces [1, 80, 3000] features):
frame -> Hann window -> rFFT -> power -> slaney mel filterbank -> log10 ->
dynamic-range clamp -> scale, on whatever device the wav lies on. The
filterbank helpers are numpy, copied from the JAX module (whose top level
imports jax). :func:`log_mel_from_power` is the tail shared with the fused
kernel path (:mod:`.mel_fused`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # 480000
N_FRAMES = CHUNK_SAMPLES // HOP   # 3000


def hertz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mels = 3.0 * f / 200.0
    log_region = f >= 1000.0
    logstep = 27.0 / np.log(6.4)
    mels = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) * logstep, mels)
    return mels


def mel_to_hertz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    logstep = np.log(6.4) / 27.0
    f = np.where(log_region, 1000.0 * np.exp(logstep * (m - 15.0)), f)
    return f


def mel_filter_bank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                    fmin: float = 0.0, fmax: float = 8000.0,
                    sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank (n_mels, n_freqs),
    matching HF ``mel_filter_bank(..., norm='slaney', mel_scale='slaney')``."""
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel_slaney(fmin), hertz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


@functools.cache
def filter_bank(n_mels: int = N_MELS) -> np.ndarray:
    """The (n_mels, 201) filterbank, built once per mel count (read-only)."""
    fb = mel_filter_bank(n_mels=n_mels)
    fb.flags.writeable = False
    return fb


def hann_window() -> np.ndarray:
    """Whisper's periodic Hann window, ``np.hanning(401)[:-1]``, in fp32."""
    return np.hanning(N_FFT + 1)[:-1].astype(np.float32)


def pad_or_trim(wav: np.ndarray, length: int = CHUNK_SAMPLES) -> np.ndarray:
    """Whisper 30 s zero-pad/truncate (feature-extractor max_length)."""
    if len(wav) >= length:
        return np.asarray(wav[:length], np.float32)
    out = np.zeros(length, np.float32)
    out[: len(wav)] = wav
    return out


def mel_power_spectrum(wav: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, T) float32 -> (B, T // 160, n_mels) mel power: reflect-pad by
    n_fft // 2, 400-sample frames every 160 samples (whisper drops the final
    frame), Hann window, rFFT, |.|^2, then the filterbank product in fp32."""
    T = wav.shape[1]
    pad = N_FFT // 2
    x = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, : T // HOP]          # (B, F, 400) view
    window = torch.from_numpy(hann_window()).to(wav.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                    # (B, F, 201)
    fb = torch.from_numpy(filter_bank(n_mels).T.copy()).to(wav.device)
    return power @ fb                                          # (B, F, n_mels)


def log_mel_from_power(mel: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) mel power -> (B, n_mels, F) Whisper features:
    log10(max(., 1e-10)), clamp to each clip's max - 8, then (x + 4) / 4."""
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10)).transpose(1, 2)
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(wav: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, 480000) float32 -> (B, n_mels, 3000) Whisper log-mel features.

    Matches WhisperFeatureExtractor; ``n_mels=128`` is the whisper-large-v3
    feature extractor."""
    return log_mel_from_power(mel_power_spectrum(wav, n_mels))
