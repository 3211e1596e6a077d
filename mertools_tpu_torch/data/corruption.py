"""Data corruption for robustness research (MER-NOISE style) — port of
``mertools_tpu/data/corruption.py``.

Reference semantics (``MER2023/main-corrupt.py:25-116`` and
``MERBench/toolkit/utils/functions.py:349-433``):

  * **Audio SNR noise**: concatenate random MUSAN noise clips until they
    cover the clean wav, cut a random window, scale the noise so that
    ``noise_rms = clean_rms / 10^(snr/20)``, add, then rescale if int16
    would clip (numpy, copied as it is).
  * **Video blur**: ``log2(blur_rate)`` pyramid downs then ups per frame
    (cv2.pyrDown/pyrUp), here antialiased linear resizes on the device
    through ``ops/image.resize_separable``, which equals the JAX package's
    ``jax.image.resize``.
"""

from __future__ import annotations

import math

import numpy as np

def rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x.astype(np.float64)))))


def adjusted_noise_rms(clean_rms: float, snr: float) -> float:
    """noise rms for a target SNR in dB (main-corrupt.py:35-38)."""
    return clean_rms / (10 ** (float(snr) / 20))


def mix_noise(clean: np.ndarray, noise_pool: list[np.ndarray], snr: float,
              rng: np.random.Generator | None = None,
              int16_range: bool = True) -> tuple[np.ndarray, dict]:
    """Add MUSAN-style noise at a given SNR (main-corrupt.py:44-80).

    clean/noise in int16-scale float (as the reference reads them).
    """
    rng = rng or np.random.default_rng()
    clean = clean.astype(np.float64)

    noise_amp: list[float] = []
    picks = []
    while len(noise_amp) <= len(clean):
        i = int(rng.integers(0, len(noise_pool)))
        noise_amp.extend(noise_pool[i].astype(np.float64))
        picks.append(i)
    start = int(rng.integers(0, len(noise_amp) - len(clean) + 1))
    noise = np.asarray(noise_amp[start: start + len(clean)])

    target = adjusted_noise_rms(rms(clean), snr)
    noise = noise * (target / max(rms(noise), 1e-12))
    mixed = clean + noise

    if int16_range:
        max_i, min_i = np.iinfo(np.int16).max, np.iinfo(np.int16).min
        if mixed.max() > max_i or mixed.min() < min_i:
            if mixed.max() >= abs(mixed.min()):
                mixed = mixed * (max_i / mixed.max())
            else:
                mixed = mixed * (min_i / mixed.min())
    return mixed, {"noise_indices": picks, "snr": snr, "start": start}


def blur_frames(frames: np.ndarray, blur_rate: int, device="cuda") -> np.ndarray:
    """Pyramid-style blur: log2(blur_rate) 2x downsamples then upsamples.

    frames: (T, H, W, C) uint8, uploaded as uint8 to ``device`` (the card
    unless the caller asks for the CPU). Each step halves the sizes with
    floor division, then the same number of steps double them; the result
    is rounded, clipped and cast to uint8, as the JAX package's
    (main-corrupt.py:84-95)."""
    import torch

    from ..core.device import resolve_device, upload
    from ..ops.image import resize_separable

    steps = int(math.log2(blur_rate))
    if steps <= 0:
        return frames
    dev = resolve_device(device, fp32=True)
    x = upload(np.ascontiguousarray(frames), dev).float()
    for _ in range(steps):
        x = resize_separable(x, x.shape[1] // 2, x.shape[2] // 2, "linear")
    for _ in range(steps):
        x = resize_separable(x, x.shape[1] * 2, x.shape[2] * 2, "linear")
    return torch.round(x).clamp(0, 255).to(torch.uint8).cpu().numpy()
