"""Face alignment and cropping geometry — port of
``mertools_tpu/ops/face_align.py``.

Detection and landmarks come from a detector (``ops/face_haar`` or
``ops/face_detect``); this module does the geometric stage on the tensor's
device: similarity-align to the ArcFace template and crop into the
``(T, 112, 112, 3)`` stores every visual extractor reads.

- :func:`umeyama` — least-squares similarity transform, a batched 2x2 SVD
  with the reflection fix.
- :func:`warp_affine` — batched inverse warp with order-1 sampling: each of
  the four taps reads zero outside the frame, which is
  ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant", cval=0)``,
  done here as one gather over the flattened frames. uint8 frames are
  gathered as they are and the taps cast to float32, so a card receives the
  frames at a quarter of their float size.
- :func:`align_faces`, :func:`crop_resize` — landmarks or boxes to crops.
- :func:`umeyama_np`, :func:`warp_affine_np` — the JAX package's host twins,
  copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

# ArcFace 112x112 5-point template (left eye, right eye, nose, mouth L/R)
ARCFACE_TEMPLATE = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transform src -> dst.

    src/dst: (..., K, 2) point sets. Returns (..., 2, 3) affine matrices
    A with [x', y']^T = A @ [x, y, 1]^T (Umeyama 1991, rotation+scale+t).
    The rotation U diag(d) Vt does not depend on the signs the SVD picks
    for its singular vectors, so it equals the JAX package's."""
    mu_s = src.mean(dim=-2, keepdim=True)
    mu_d = dst.mean(dim=-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    var_s = (sc ** 2).sum(dim=(-1, -2))
    cov = torch.einsum("...ki,...kj->...ij", dc, sc) / src.shape[-2]

    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    d = torch.ones(U.shape[:-1], dtype=src.dtype, device=src.device)
    d[..., -1] = torch.sign(det)
    R = torch.einsum("...ij,...j,...jk->...ik", U, d, Vt)
    scale = (S * d).sum(-1) / (var_s / src.shape[-2] + 1e-12)
    sR = scale[..., None, None] * R
    t = mu_d.transpose(-1, -2) - sR @ mu_s.transpose(-1, -2)
    return torch.cat([sR, t], dim=-1)                   # (..., 2, 3)


def _invert_affine(A: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) forward affine -> inverse (for pull-warping)."""
    M = A[..., :2]
    t = A[..., 2]
    Minv = torch.linalg.inv(M)
    tinv = -torch.einsum("...ij,...j->...i", Minv, t)
    return torch.cat([Minv, tinv[..., None]], dim=-1)


def warp_affine(images: torch.Tensor, affines: torch.Tensor,
                out_h: int = 112, out_w: int = 112) -> torch.Tensor:
    """Batched inverse warp with bilinear sampling.

    images: (B, H, W, C) uint8 or float; affines: (B, 2, 3) FORWARD
    transforms (src px -> dst px). The output pixel (x, y) samples
    ``A⁻¹·[x, y, 1]``. Returns (B, out_h, out_w, C) float32 on images'
    device."""
    B, H, W, C = images.shape
    dev = images.device
    inv = _invert_affine(affines.to(dev, torch.float32))          # dst -> src
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(-1, 2)               # (P, 2) x,y
    src = torch.einsum("pj,bij->bpi", grid, inv[:, :, :2]) + inv[:, None, :, 2]
    sx, sy = src[..., 0], src[..., 1]                             # (B, P)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0f, sy - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = images.reshape(B * H * W, C)
    base = (torch.arange(B, device=dev) * (H * W))[:, None]

    def tap(yi, xi, w):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(B, -1, C).float()
        return v * (w * valid)[..., None]

    out = (tap(y0, x0, (1 - fy) * (1 - fx)) + tap(y0, x0 + 1, (1 - fy) * fx)
           + tap(y0 + 1, x0, fy * (1 - fx)) + tap(y0 + 1, x0 + 1, fy * fx))
    return out.reshape(B, out_h, out_w, C)


def umeyama_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Host (NumPy) twin of :func:`umeyama` — identical math."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    mu_s = src.mean(axis=-2, keepdims=True)
    mu_d = dst.mean(axis=-2, keepdims=True)
    sc = src - mu_s
    dc = dst - mu_d
    var_s = (sc ** 2).sum(axis=(-1, -2))
    cov = np.einsum("...ki,...kj->...ij", dc, sc) / src.shape[-2]
    U, S, Vt = np.linalg.svd(cov)
    det = np.linalg.det(U) * np.linalg.det(Vt)
    d = np.ones(U.shape[:-1], np.float32)
    d[..., -1] = np.sign(det)
    R = np.einsum("...ij,...j,...jk->...ik", U, d, Vt)
    scale = (S * d).sum(-1) / (var_s / src.shape[-2] + 1e-12)
    sR = scale[..., None, None] * R
    t = np.swapaxes(mu_d, -1, -2) - sR @ np.swapaxes(mu_s, -1, -2)
    return np.concatenate([sR, t], axis=-1).astype(np.float32)


def warp_affine_np(images: np.ndarray, affines: np.ndarray,
                   out_h: int = 112, out_w: int = 112) -> np.ndarray:
    """Host (NumPy) twin of :func:`warp_affine` — identical bilinear
    inverse-warp semantics (order-1, zero outside)."""
    images = np.asarray(images, np.float32)
    affines = np.asarray(affines, np.float32)
    B, H, W, C = images.shape
    M = affines[:, :, :2]
    t = affines[:, :, 2]
    Minv = np.linalg.inv(M)
    tinv = -np.einsum("bij,bj->bi", Minv, t)
    ys, xs = np.meshgrid(np.arange(out_h, dtype=np.float32),
                         np.arange(out_w, dtype=np.float32), indexing="ij")
    grid = np.stack([xs, ys], -1).reshape(-1, 2)       # (P, 2) x,y
    # per-frame loop beats batched fancy indexing here (the per-frame
    # working set stays in cache)
    out = np.empty((B, out_h, out_w, C), np.float32)
    for b in range(B):
        src = grid @ Minv[b].T + tinv[b]
        sx, sy = src[:, 0], src[:, 1]
        x0f, y0f = np.floor(sx), np.floor(sy)
        fx, fy = sx - x0f, sy - y0f
        x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)

        def tap(yi, xi):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = images[b, np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
            return v * valid[:, None]

        v = (tap(y0, x0) * ((1 - fy) * (1 - fx))[:, None]
             + tap(y0, x0 + 1) * ((1 - fy) * fx)[:, None]
             + tap(y0 + 1, x0) * (fy * (1 - fx))[:, None]
             + tap(y0 + 1, x0 + 1) * (fy * fx)[:, None])
        out[b] = v.reshape(out_h, out_w, C)
    return out


def align_faces(frames: torch.Tensor, landmarks: torch.Tensor,
                out_size: int = 112) -> torch.Tensor:
    """frames (B, H, W, 3) + 5-point landmarks (B, 5, 2) in pixel (x, y)
    -> (B, out_size, out_size, 3) template-aligned float32 crops, on
    frames' device."""
    lms = landmarks.to(frames.device, torch.float32)
    tmpl = torch.from_numpy(ARCFACE_TEMPLATE * (out_size / 112.0)).to(frames.device)
    A = umeyama(lms, tmpl.expand(lms.shape))
    return warp_affine(frames, A, out_size, out_size)


def crop_resize(frames: torch.Tensor, boxes: torch.Tensor,
                out_size: int = 112) -> torch.Tensor:
    """frames (B, H, W, 3) + boxes (B, 4) [x0, y0, x1, y1] px ->
    (B, out_size, out_size, 3) crops (detector-bbox pipelines)."""
    boxes = boxes.to(frames.device, torch.float32)
    x0, y0, x1, y1 = boxes.unbind(-1)
    sx = (x1 - x0) / out_size
    sy = (y1 - y0) / out_size
    zeros = torch.zeros_like(sx)
    inv = torch.stack([torch.stack([sx, zeros, x0], -1),
                       torch.stack([zeros, sy, y0], -1)], 1)  # dst -> src
    return warp_affine(frames, _invert_affine(inv), out_size, out_size)
