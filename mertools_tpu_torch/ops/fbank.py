"""Kaldi-compatible log-mel filterbank ("fbank") on the tensor's device —
port of ``mertools_tpu/ops/fbank.py``.

The ImageBind audio frontend (``MER2025/MER2025_Track23/my_affectgpt/models/
ImageBind/data.py:28-68``: ``torchaudio.compliance.kaldi.fbank`` with
``htk_compat=True, window_type="hanning", num_mel_bins=128, dither=0.0,
frame_length=25, frame_shift=10``) and the 2 s constant-clips sampler
(``data.py:117-166``, pytorchvideo ``ConstantClipsPerVideoSampler``).

Kaldi semantics, as the JAX package implements them:
- snip_edges=True framing: ``m = 1 + (n - 400) // 160`` frames,
- per-frame DC-offset removal (subtract the frame mean),
- preemphasis 0.97 with replicate-padded first sample,
- symmetric Hann window (``torch.hann_window(400, periodic=False)``),
- zero-pad to the next power of two (512) -> power spectrum (257 bins),
- Kaldi mel scale ``1127 ln(1 + f/700)``, triangular banks over
  ``[low=20 Hz, high=nyquist]`` with a zero nyquist column,
- ``log(max(x, FLT_EPS))``.

The spectrum is ``torch.fft.rfft`` (the JAX package's is ``jnp.fft.rfft``,
a library FFT too; no Pallas kernel is on this path). The banks and the
window are numpy copies of the JAX package's, uploaded once a device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LEN = 400          # 25 ms
FRAME_SHIFT = 160        # 10 ms
PADDED_LEN = 512         # next power of two
_EPSILON = float(np.finfo(np.float32).eps)   # kaldi EPSILON = 1.1921e-7


def kaldi_mel_banks(num_bins: int, padded_window_size: int = PADDED_LEN,
                    sample_freq: int = SAMPLE_RATE, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel banks, shape (num_bins, padded//2 + 1); the last
    (nyquist) column is zero, as in torchaudio's ``get_mel_banks`` + pad."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2.0 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left = mel_low + bin_idx * mel_delta
    center = mel_low + (bin_idx + 1.0) * mel_delta
    right = mel_low + (bin_idx + 2.0) * mel_delta
    freqs = mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (freqs - left) / (center - left)
    down = (right - freqs) / (right - center)
    banks = np.maximum(0.0, np.minimum(up, down))
    out = np.zeros((num_bins, num_fft_bins + 1), np.float64)
    out[:, :num_fft_bins] = banks
    return out.astype(np.float32)


def _hann_symmetric(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(num_mel_bins: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(window (400,), banks transposed (257, num_mel_bins)) on ``device``,
    uploaded once; callers only read them."""
    return (torch.from_numpy(_hann_symmetric(FRAME_LEN)).to(device),
            torch.from_numpy(kaldi_mel_banks(num_mel_bins).T.copy()).to(device))


def frame_signal(wavs: torch.Tensor, n_frames: int, win: int, hop: int) -> torch.Tensor:
    """(B, n) -> (B, n_frames, win) windows starting every ``hop`` samples.
    An index past the end reads the last sample, as the JAX package's
    gather does (XLA clamps out-of-range gather indices)."""
    idx = (torch.arange(max(n_frames, 0), device=wavs.device)[:, None] * hop
           + torch.arange(win, device=wavs.device)[None, :])
    return wavs[:, idx.clamp_max(wavs.shape[-1] - 1)]


def kaldi_fbank(wavs: torch.Tensor, num_mel_bins: int = 128) -> torch.Tensor:
    """(B, n_samples) -> (B, n_frames, num_mel_bins) kaldi-style log-mels;
    dither is 0 (the ImageBind setting), energy off. A signal shorter than
    one frame gives no frames."""
    n = wavs.shape[-1]
    m = 1 + (n - FRAME_LEN) // FRAME_SHIFT
    if m <= 0:
        return wavs.new_zeros(wavs.shape[0], 0, num_mel_bins)
    window, banks = _tables(num_mel_bins, wavs.device)
    frames = frame_signal(wavs, m, FRAME_LEN, FRAME_SHIFT)       # (B, m, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)         # remove_dc_offset
    # preemphasis with replicate-padded first sample (torchaudio kaldi)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * prev) * window
    spec = torch.fft.rfft(frames, n=PADDED_LEN, dim=-1)        # zero-padded
    power = spec.real.square() + spec.imag.square()             # (B, m, 257)
    return torch.log(torch.clamp_min(power @ banks, _EPSILON))


def constant_clip_timepoints(duration: float, clip_duration: float = 2.0,
                             clips_per_video: int = 8) -> list[tuple[float, float]]:
    """pytorchvideo ``ConstantClipsPerVideoSampler``: uniformly spaced clip
    starts covering ``duration`` (data.py:130-152)."""
    max_start = max(duration - clip_duration, 0.0)
    denom = max(clips_per_video - 1, 1)
    return [(i * max_start / denom, i * max_start / denom + clip_duration)
            for i in range(clips_per_video)]


def sample_audio_clips(wav: np.ndarray, sample_rate: int = SAMPLE_RATE,
                       clip_duration: float = 2.0, clips_per_video: int = 8
                       ) -> np.ndarray:
    """wav (n,) -> (clips_per_video, clip_samples) as the reference
    ``load_audio`` (data.py:170-215): zero-pad to >= 2 s, then slice
    ``int(start*sr):int(end*sr)`` windows. Where float rounding makes a
    window one sample longer (at 50,001 samples, for one), its first
    ``clip_samples`` are kept: the fbank's 198 frames end before the extra
    sample and remove each frame's mean, so the mel image is the
    reference's up to rounding. The JAX package's copy raises there."""
    clip_samples = int(clip_duration * sample_rate)
    wav = np.asarray(wav, np.float32)
    if len(wav) < clip_samples:
        wav = np.pad(wav, (0, clip_samples - len(wav)))
    duration = len(wav) / sample_rate
    clips = np.zeros((clips_per_video, clip_samples), np.float32)
    for i, (s, e) in enumerate(constant_clip_timepoints(
            duration, clip_duration, clips_per_video)):
        seg = wav[int(s * sample_rate): int(e * sample_rate)][:clip_samples]
        clips[i, : len(seg)] = seg
    return clips


def imagebind_melspec(clips: torch.Tensor, num_mel_bins: int = 128,
                      target_length: int = 204,
                      mean: float = -4.268, std: float = 9.138) -> torch.Tensor:
    """(B, clip_samples) 2 s clips -> (B, num_mel_bins, target_length)
    normalized mel "images" (``waveform2melspec`` + Normalize, data.py:28-68):
    subtract the clip mean, fbank, transpose to (mels, frames), zero-pad or
    cut to ``target_length`` frames, normalize with the AudioSet stats."""
    clips = clips - clips.mean(dim=-1, keepdim=True)
    fb = kaldi_fbank(clips, num_mel_bins).transpose(1, 2)       # (B, mels, m)
    m = fb.shape[-1]
    if m < target_length:
        fb = torch.nn.functional.pad(fb, (0, target_length - m))
    else:
        fb = fb[..., :target_length]
    return (fb - mean) / std
