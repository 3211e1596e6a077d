"""Device set-up and host-to-device upload shared by the extractors and ASR."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device, fp32: bool) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a host without
    one. ``fp32`` is parity mode: cuBLAS and cuDNN stop using TF32, which
    they would otherwise do silently where the JAX package runs at HIGHEST."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but this host has no "
                               f"CUDA device")
        if fp32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    return dev


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to a card through pinned memory
    with a non-blocking copy, so the host can build the next batch."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.lru_cache(maxsize=128)
def on_device(build, device: torch.device, *args) -> torch.Tensor:
    """The numpy table ``build(*args)`` as a tensor on ``device``, built and
    uploaded once a device; callers only read it."""
    return torch.from_numpy(np.ascontiguousarray(build(*args))).to(device)


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    """A waveform as PCM16: int16 input as it is, floats in [-1, 1) rounded
    and clipped."""
    if wav.dtype == np.int16:
        return wav
    return np.clip(np.round(np.asarray(wav, np.float32) * 32768.0),
                   -32768, 32767).astype(np.int16)
