"""Separable image resize and the fused face preprocessing — port of
``mertools_tpu/ops/image.py``.

Resize is separable and linear, so it is two small products ``y = Whᵀ x Ww``
with interpolation matrices, and the affine normalisation (uint8 -> /255 ->
(x - mean) / std) folds around it because every column of W sums to 1.

:func:`resize_weight_matrix` is the JAX package's numpy code as it is: it
reproduces ``jax.image.resize``'s ``_compute_weight_mat`` (Keys cubic
a = -0.5, antialias on downscale, boundary renormalisation) exactly, which
``F.interpolate`` does not, so the port's CLIP pixels equal the JAX
package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5 (jax.image 'bicubic'/'cubic')."""
    x = np.abs(x)
    return np.where(
        x <= 1.0, (1.5 * x - 2.5) * x * x + 1.0,
        np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    """Linear kernel (jax.image 'bilinear')."""
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic,
            "bilinear": _triangle, "linear": _triangle,
            "triangle": _triangle}


@functools.lru_cache(maxsize=64)
def resize_weight_matrix(in_size: int, out_size: int,
                         method: str = "bicubic",
                         antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) interpolation matrix matching
    jax.image.resize's ``_compute_weight_mat`` exactly."""
    kernel = _KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = (np.abs(sample_f[None, :] - np.arange(in_size)[:, None])
         / kernel_scale)
    w = kernel(x)                                        # (in, out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).tiny,
                 w / total, 0.0)
    in_range = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(in_range[None, :], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights_on(in_size: int, out_size: int, method: str,
                device: torch.device) -> torch.Tensor:
    # one upload per (size, device): a numpy upload a batch would block the
    # host behind the card's queue
    return torch.from_numpy(resize_weight_matrix(in_size, out_size,
                                                 method)).to(device)


def resize_separable(x: torch.Tensor, out_h: int, out_w: int,
                     method: str = "bicubic") -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, out_h, out_w, C) by two products; equals
    jax.image.resize(method, antialias=True) to fp32 rounding. Runs in
    x's dtype: fp32 callers keep TF32 off (``core.device.resolve_device``)."""
    wh = _weights_on(x.shape[1], out_h, method, x.device)
    ww = _weights_on(x.shape[2], out_w, method, x.device)
    y = torch.einsum("bhwc,ho->bowc", x, wh)
    return torch.einsum("bowc,wp->bopc", y, ww)


def fused_face_preprocess(frames: torch.Tensor, image_size: int,
                          mean, std, scale: float = 1.0 / 255.0,
                          bgr_to_rgb: bool = True, resize_short: int = 0,
                          method: str = "bicubic") -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, S, S, 3) normalised float32: channel flip,
    the affine normalisation folded per channel around the separable resize
    (resize rows sum to 1, so resize(a*x+b) == a*resize(x)+b).
    ``resize_short`` > 0 reproduces Resize(short) + CenterCrop(image_size)."""
    x = frames.float()
    if bgr_to_rgb:
        x = torch.flip(x, dims=(-1,))      # torch has no negative strides
    R = resize_short or image_size
    x = resize_separable(x, R, R, method)
    if resize_short:
        off = (R - image_size) // 2
        x = x[:, off: off + image_size, off: off + image_size]
    a, b = _affine_on(tuple(mean), tuple(std), scale, x.device)
    return x * a + b


@functools.lru_cache(maxsize=16)
def _affine_on(mean: tuple, std: tuple, scale: float,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale / std, -mean / std) in float32, uploaded once per device."""
    m, s = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    return (torch.from_numpy(np.float32(scale) / s).to(device),
            torch.from_numpy(-m / s).to(device))
