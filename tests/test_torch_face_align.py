"""The port's face alignment geometry against the JAX package's
``ops/face_align.py`` on the same numpy inputs: Umeyama transforms (one
with a reflection) within 1e-5 relative, the warps within 1e-3 on the
0-255 scale with sample points off the frame (align_faces, which solves
its transform first, within 1e-2), and the host twins equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.ops import face_align as jf
from mertools_tpu_torch.ops import face_align as tf

torch.set_num_threads(1)

WARP_TOL = 1e-3   # 0-255 scale
# align_faces solves its transform first: both sides solve it in float32,
# each ~2e-5 px from a float64 solve (translations of ~20 px), which moves a
# sample point by up to ~1e-4 px after the inverse, on frames whose levels
# change by up to 32 a pixel
ALIGN_TOL = 1e-2


def _frames(seed: int, dtype=np.float32) -> np.ndarray:
    """(3, 96, 80, 3) frames on the 0-255 scale, smooth as camera frames
    are: a seeded 13 x 11 grid interpolated linearly. Both sides compute
    their sample points in float32, and XLA fuses a multiply-add where torch
    does not, so a point may differ by an ulp (7.6e-6 px at 100 px); a
    frame of white noise, 255 levels from pixel to pixel, would turn that
    into 2e-3 levels, while a step of at most 32 levels keeps it below
    5e-4."""
    coarse = np.random.default_rng(seed).random((3, 13, 11, 3)) * 255
    y = np.linspace(0, 12, 96)
    x = np.linspace(0, 10, 80)
    y0, x0 = np.minimum(y.astype(int), 11), np.minimum(x.astype(int), 9)
    fy, fx = (y - y0)[:, None, None], (x - x0)[None, :, None]
    c = coarse[:, y0][:, :, x0]
    c1 = coarse[:, y0][:, :, x0 + 1]
    r = coarse[:, y0 + 1][:, :, x0]
    r1 = coarse[:, y0 + 1][:, :, x0 + 1]
    out = (1 - fy) * ((1 - fx) * c + fx * c1) + fy * ((1 - fx) * r + fx * r1)
    return out.astype(dtype)


# forward affines whose inverse samples off the frame on every side
AFFINES = np.asarray(
    [[[0.9, 0.1, 3.0], [-0.1, 0.9, 5.0]],
     [[1.2, 0.0, -40.0], [0.0, 1.2, 2.0]],
     [[0.7, -0.2, 10.0], [0.2, 0.7, -30.0]]], np.float32)


def _point_sets(seed: int):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(6, 5, 2)).astype(np.float32) * 30 + 50
    dst = rng.normal(size=(6, 5, 2)).astype(np.float32) * 30 + 50
    dst[0] = src[0] * np.float32([-1.0, 1.0]) + 7   # a mirror: det(U Vt) < 0
    return src, dst


def test_umeyama_matches_jax_with_a_reflection():
    src, dst = _point_sets(1)
    ref = np.asarray(jf.umeyama(jnp.asarray(src), jnp.asarray(dst)))
    got = tf.umeyama(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    cov = np.einsum("ki,kj->ij", dst[0] - dst[0].mean(0), src[0] - src[0].mean(0))
    assert np.linalg.det(cov) < 0          # the reflection fix is taken
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_warp_affine_matches_jax_off_the_frame(dtype):
    frames = _frames(0, dtype)
    ref = np.asarray(jf.warp_affine(jnp.asarray(frames, jnp.float32),
                                    jnp.asarray(AFFINES), 50, 60))
    got = tf.warp_affine(torch.from_numpy(frames), torch.from_numpy(AFFINES),
                         50, 60)
    assert got.dtype == torch.float32 and got.shape == (3, 50, 60, 3)
    assert (ref == 0).any()                # some points fall off the frame
    assert np.abs(got.numpy() - ref).max() <= WARP_TOL


def test_align_faces_matches_jax():
    frames = _frames(2)
    lm = jf.ARCFACE_TEMPLATE * 1.5 + np.float32([10.0, 6.0])
    lms = np.stack([lm, lm * 1.1, lm * 0.8 - 30]).astype(np.float32)
    ref = np.asarray(jf.align_faces(jnp.asarray(frames), jnp.asarray(lms)))
    got = tf.align_faces(torch.from_numpy(frames), torch.from_numpy(lms)).numpy()
    assert got.shape == ref.shape == (3, 112, 112, 3)
    assert np.abs(got - ref).max() <= ALIGN_TOL


def test_crop_resize_matches_jax():
    frames = _frames(3)
    boxes = np.asarray([[8.0, 8.0, 56.0, 60.0], [-20.0, 10.0, 40.0, 110.0],
                        [30.0, -5.0, 95.0, 70.0]], np.float32)
    ref = np.asarray(jf.crop_resize(jnp.asarray(frames), jnp.asarray(boxes),
                                    out_size=32))
    got = tf.crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                         out_size=32).numpy()
    assert np.abs(got - ref).max() <= WARP_TOL


def test_host_twins_equal_the_jax_packages():
    src, dst = _point_sets(4)
    np.testing.assert_array_equal(tf.umeyama_np(src, dst), jf.umeyama_np(src, dst))
    frames = _frames(5)
    np.testing.assert_array_equal(tf.warp_affine_np(frames, AFFINES, 24, 28),
                                  jf.warp_affine_np(frames, AFFINES, 24, 28))
