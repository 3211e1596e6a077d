"""Handcrafted acoustic features on the tensor's device — port of the
librosa half and the set dispatchers of ``mertools_tpu/ops/handcrafted.py``.

The reference computes MERBench's handcrafted baselines one clip at a time:
librosa for the mel spectrogram and MFCC (``MERBench/feature_extraction/
audio/handcrafted_feature_func.py:145-202``) and the openSMILE binary for
the IS09 / IS10 / IS13 / eGeMAPS sets (``:28-142``). Here a whole bucket of
clips runs as batched tensor math: framing, window, ``torch.fft.rfft``,
the mel and DCT products as fp32 matmuls. The JAX package's spectra are
``jnp.fft`` and its products einsums, outside any Pallas kernel, so no
hand-written kernel runs here.

Two behaviours depend on the batch, as in the JAX package, and are kept so
the port's stores equal its stores: :func:`power_to_db` clips at the
maximum of the whole batch minus ``top_db`` (librosa clips a clip alone),
and :func:`stft_power` reflect-pads at the end of the padded buffer, so the
last frames of a clip shorter than its bucket read zeros.

The openSMILE sets route to their chains: IS09 -> :mod:`.opensmile_is09`,
eGeMAPS -> :mod:`.egemaps`. IS10 and IS13 are ROADMAP A10b and raise.
The window, filterbank and DCT tables are made in numpy as the JAX
package makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import on_device
from .fbank import frame_signal as _frames
from .mel import hertz_to_mel_slaney, mel_to_hertz_slaney

# the reference's own measured contract (handcrafted_feature_func.py:15-19)
FRAME_DIMS = {"IS09": 32, "IS10": 32, "IS13": 120, "eGeMAPS": 23}
UTT_DIMS = {"IS09": 384, "IS10": 1582, "IS13": 6372, "eGeMAPS": 88}
NOT_PORTED = ("IS10", "IS13")   # ROADMAP A10b


# ---------------------------------------------------------------------------
# framing / spectra
# ---------------------------------------------------------------------------


def n_frames_for(T: int, frame_len: int, hop: int) -> int:
    return max(1 + (T - frame_len) // hop, 1)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F, frame_len) with F = 1 + (T - frame_len)//hop (at
    least 1; an index past the end reads the last sample)."""
    return _frames(x, n_frames_for(x.shape[-1], frame_len, hop), frame_len, hop)


def frame_mask(lengths: torch.Tensor, n_frames: int, frame_len: int,
               hop: int) -> torch.Tensor:
    """(B,) sample lengths -> (B, F) bool mask of frames fully inside."""
    starts = torch.arange(n_frames, device=lengths.device) * hop
    return (starts[None, :] + frame_len) <= lengths.clamp_min(frame_len)[:, None]


def hann(n: int, periodic: bool = True) -> np.ndarray:
    m = n if periodic else n - 1
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / m)).astype(np.float32)


def centred_window(n_fft: int, win_length: int) -> np.ndarray:
    """A periodic Hann of ``win_length`` centred in ``n_fft`` zeros
    (librosa ``util.pad_center``)."""
    lpad = (n_fft - win_length) // 2
    w_full = np.zeros(n_fft, np.float32)
    w_full[lpad: lpad + win_length] = hann(win_length)
    return w_full


def reflect_index(T: int, pad: int) -> np.ndarray:
    """Indices of ``np.pad(x, pad, mode="reflect")`` along an axis of T
    (the reflection repeats where ``pad`` exceeds T - 1, as numpy's does)."""
    i = np.arange(-pad, T + pad)
    if T == 1:
        return np.zeros_like(i)
    period = 2 * (T - 1)
    i = np.abs(i) % period
    return np.where(i >= T, period - i, i)


def stft_power(x: torch.Tensor, n_fft: int, win_length: int, hop: int,
               center: bool = True) -> torch.Tensor:
    """librosa-style power spectrogram. (B, T) -> (B, F, n_fft//2+1).

    With ``center`` the buffer is reflect-padded by n_fft//2 at both ends,
    so frame f is centred at f*hop."""
    if center:
        idx = reflect_index(x.shape[-1], n_fft // 2)
        x = x[..., torch.from_numpy(idx).to(x.device)]
    frames = frame_signal(x, n_fft, hop) * on_device(centred_window, x.device, n_fft,
                                                      win_length)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def mel_filter_bank_librosa(sr: int, n_fft: int, n_mels: int,
                            fmin: float = 0.0, fmax: float | None = None
                            ) -> np.ndarray:
    """librosa-default (slaney scale, slaney norm) filterbank (n_mels, bins)."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel_slaney(fmin), hertz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float | None = 80.0) -> torch.Tensor:
    """librosa.power_to_db with ref=1.0; the ``top_db`` floor is taken from
    the maximum of the whole batch, as the JAX package takes it."""
    log_spec = 10.0 * torch.log10(S.clamp_min(amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n_out, n_in), scipy/librosa norm='ortho'."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


def delta_sg(x: torch.Tensor, width: int = 9, dim: int = 1) -> torch.Tensor:
    """librosa.feature.delta: Savitzky-Golay first derivative, window 9,
    edges replicated (librosa's mode='interp' differs only in the first and
    last width//2 frames)."""
    half = width // 2
    k = np.arange(-half, half + 1, dtype=np.float32)
    taps = (k / np.sum(k ** 2)).astype(np.float32)
    x_t = x.movedim(dim, -1)
    n = x_t.shape[-1]
    idx = np.clip(np.arange(-half, n + half), 0, n - 1)
    x_pad = x_t[..., torch.from_numpy(idx).to(x.device)]
    out = sum(float(taps[i]) * x_pad[..., i: i + n] for i in range(width))
    return out.movedim(-1, dim)


# ---------------------------------------------------------------------------
# librosa-equivalent features (handcrafted_feature_func.py:156-202)
# ---------------------------------------------------------------------------


def mel_spec_librosa(wav: torch.Tensor, sr: int = 22050,
                     frame_size: float = 0.025, frame_step: float = 0.010,
                     n_mels: int = 128, n_fft: int = 2048) -> torch.Tensor:
    """(B, T) -> (B, F, 128) linear-power mel spectrogram (log_mel=False in
    the reference, ``handcrafted_feature_func.py:167-182``)."""
    win = int(frame_size * sr)
    hop = int(frame_step * sr)
    S = stft_power(wav, n_fft, win, hop)
    return S @ on_device(mel_filter_bank_librosa, wav.device, sr, n_fft, n_mels).T


def mfcc_librosa(wav: torch.Tensor, sr: int = 22050, frame_size: float = 0.025,
                 frame_step: float = 0.010, n_mfcc: int = 40,
                 n_mels: int = 128, n_fft: int = 2048) -> torch.Tensor:
    """(B, T) -> (B, F, 120): MFCC-40 + delta + delta-delta (delta=True in
    the reference, ``handcrafted_feature_func.py:185-202``)."""
    S = mel_spec_librosa(wav, sr, frame_size, frame_step, n_mels, n_fft)
    mfcc = power_to_db(S) @ on_device(dct_matrix, wav.device, n_mfcc, n_mels).T
    d1 = delta_sg(mfcc, dim=1)
    d2 = delta_sg(d1, dim=1)
    return torch.cat([mfcc, d1, d2], dim=-1)


# ---------------------------------------------------------------------------
# the openSMILE set dispatchers
# ---------------------------------------------------------------------------


def _chain(feature_set: str, sr: int):
    if feature_set in NOT_PORTED:
        raise ValueError(f"{feature_set}: the openSMILE {feature_set} chain is not "
                         f"ported to mertools_tpu_torch yet (ROADMAP A10b); use "
                         f"python -m mertools_tpu.cli.extract_handcrafted")
    if feature_set == "IS09":
        from . import opensmile_is09 as mod
    elif feature_set == "eGeMAPS":
        from . import egemaps as mod
    else:
        raise ValueError(feature_set)
    if sr != mod.SR:
        raise ValueError(f"the {feature_set} chain is defined at {mod.SR} Hz, got {sr}")
    return mod


def handcrafted_frame(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000,
                      feature_set: str = "IS09"):
    """Frame-level (LLD) features: (B, T) -> ((B, F, FRAME_DIMS[set]), (B, F)
    mask)."""
    mod = _chain(feature_set, sr)
    fn = mod.is09_frame if feature_set == "IS09" else mod.egemaps_frame
    return fn(wav, lengths)


def handcrafted_utt(wav: torch.Tensor, lengths: torch.Tensor, sr: int = 16000,
                    feature_set: str = "IS09") -> torch.Tensor:
    """Utterance-level functionals: (B, T) -> (B, UTT_DIMS[set])."""
    mod = _chain(feature_set, sr)
    fn = mod.is09_utt if feature_set == "IS09" else mod.egemaps_utt
    return fn(wav, lengths)
