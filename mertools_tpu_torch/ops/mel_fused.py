"""Fused Whisper mel power (kernel B2) — port of ``mertools_tpu/ops/mel_pallas.py``.

The Pallas TPU kernel (``mel_pallas.py:_kernel``, launched at ``:95``)
computes the windowed DFT of every 400-sample frame as three hop-shifted
row slices times banded cos/sin matrices, then the power and the mel
filterbank, without materialising the framed signal. The CUDA kernel
(``csrc/mel_power_fwd.cu``) computes the same function with its own
design: reflect padding by index, a 400-point real FFT in fp32 (a 200-point
complex FFT and a split), and the mel product over each filter's band
(:func:`mel_bands`).

:func:`mel_power` launches the kernel for CUDA tensors (or raises) and takes
the plain version :func:`mel_power_ref` only for CPU tensors. Both are fixed,
like the TPU kernel, at 30 s clips (480000 samples) and 80 mel bins.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .mel import (CHUNK_SAMPLES, N_FFT, N_FRAMES, N_MELS, filter_bank,
                  hann_window, log_mel_from_power, log_mel_spectrogram,
                  mel_power_spectrum)


def mel_power_ref(wav: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the FFT path of :mod:`.mel` up to the mel
    product. (B, 480000) fp32 -> (B, 3000, 80) fp32 mel power."""
    return mel_power_spectrum(wav, N_MELS)


def check_kernel_args(wav: torch.Tensor, n_mels: int = N_MELS) -> None:
    """Raise ValueError on anything the kernel does not take.

    Device-agnostic, so it can be exercised on CPU tensors."""
    if n_mels != N_MELS:
        raise ValueError(f"the fused mel kernel computes {N_MELS} mel bins, "
                         f"not {n_mels}")
    if wav.dim() != 2 or wav.shape[1] != CHUNK_SAMPLES:
        raise ValueError(f"wav must be (B, {CHUNK_SAMPLES}) (30 s at 16 kHz), "
                         f"got {tuple(wav.shape)}")
    if wav.shape[0] < 1:
        raise ValueError("wav holds no clip")
    if wav.dtype != torch.float32:
        raise ValueError(f"wav must be float32, got {wav.dtype}")
    if not wav.is_contiguous():
        raise ValueError(f"wav must be contiguous, strides {wav.stride()}")
    if wav.data_ptr() % 8:
        raise ValueError("wav must start on an 8-byte boundary (the kernel "
                         "reads sample pairs)")


def mel_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The banded form of an (n_mels, n_bins) filterbank that the kernel's
    mel product runs over: int32 (3, n_mels) rows of each mel's first bin
    ``lo``, band length ``n`` (from its first to its last nonzero; 0 for an
    all-zero filter) and the offset of its weights, and the fp32 weights
    ``fb[m, lo:lo + n]``, band after band. Every term outside a band is an
    exact zero, so the product is the same function as the dense one."""
    lo, n, off, w = [], [], [], []
    for row in fb:
        nz = np.flatnonzero(row)
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        n.append(b - a)
        off.append(sum(len(x) for x in w))
        w.append(row[a:b])
    return (np.array([lo, n, off], np.int32),
            np.concatenate(w).astype(np.float32))


@functools.cache
def _tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's constants on ``device``: (cos, sin)(2 pi m / 400)
    interleaved, computed in float64 and rounded to fp32; the Hann window;
    the filterbank's bands and their weights (:func:`mel_bands`)."""
    ang = 2.0 * np.pi * np.arange(N_FFT) / N_FFT
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (twiddle, hann_window(), *mel_bands(filter_bank(N_MELS))))


def _cuda_device(device: torch.device) -> torch.device:
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


def mel_power(wav: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """(B, 480000) fp32 -> (B, 3000, 80) fp32 mel power spectrogram.

    CPU tensors take :func:`mel_power_ref`. CUDA tensors launch the kernel or
    raise: there is no fallback. ``mel_power.launches`` counts kernel
    launches."""
    check_kernel_args(wav, n_mels)
    if wav.device.type == "cpu":
        return mel_power_ref(wav)
    if wav.device.type != "cuda":
        raise ValueError(f"mel_power runs on CPU or CUDA, not {wav.device}")
    from ._kernels import library

    device = _cuda_device(wav.device)
    twiddle, window, bands, weights = _tables(device)
    B = wav.shape[0]
    out = torch.empty((B, N_FRAMES, N_MELS), dtype=torch.float32, device=device)
    rc = library().mt_mel_power_fwd(
        wav.data_ptr(), twiddle.data_ptr(), window.data_ptr(), bands.data_ptr(),
        weights.data_ptr(), out.data_ptr(), B, CHUNK_SAMPLES, weights.numel(),
        device.index, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"mel_power_fwd launch failed: cudaError {rc}")
    mel_power.launches += 1
    return out


mel_power.launches = 0


def kernel_plan(device: torch.device) -> dict:
    """The kernel's launch shape on the CUDA ``device`` for 30 s clips:
    threads and frames a block, blocks a clip, dynamic shared memory bytes,
    blocks an SM (CUDA's occupancy API) and registers a thread."""
    from ._kernels import library

    device = _cuda_device(torch.device(device))
    weights = _tables(device)[3]
    plan = (ctypes.c_int * 6)()
    rc = library().mt_mel_power_fwd_plan(CHUNK_SAMPLES, weights.numel(),
                                         device.index, plan)
    if rc != 0:
        raise RuntimeError(f"mel_power_fwd plan failed: cudaError {rc}")
    return dict(zip(("threads", "frames", "blocks_per_clip", "smem_bytes",
                     "blocks_per_sm", "registers"), plan))


def log_mel_spectrogram_fused(wav: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`.mel.log_mel_spectrogram` on 30 s clips:
    (B, 480000) -> (B, 80, 3000) Whisper features through :func:`mel_power`."""
    return log_mel_from_power(mel_power(wav))


def select_log_mel(device: torch.device):
    """The log-mel frontend for 30 s clips on ``device``: kernel B2 on a
    CUDA device, the FFT path (:func:`.mel.log_mel_spectrogram`) on the
    CPU. Takes the place of the JAX package's ``platform == "tpu"`` gate."""
    return (log_mel_spectrogram_fused if device.type == "cuda"
            else log_mel_spectrogram)
