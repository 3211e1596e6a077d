"""The port's Haar face frontend against the JAX package's
``ops/face_haar.py`` on a short drifting clip with the severe mouth
occluder (the protocol of ``test_face_frontend_fidelity.py``): the track's
boxes, landmarks and sources equal, and ``crop_video``'s two warps within
one level of the JAX package's."""

import numpy as np
import pytest
from test_face_frontend_fidelity import draw_face

from mertools_tpu.ops import face_haar as jh
from mertools_tpu.ops import viola_jones as jvj
from mertools_tpu_torch.ops import face_haar as th

try:
    jvj.find_cascade(jvj.FRONTALFACE)
    HAVE = True
except FileNotFoundError:
    HAVE = False

pytestmark = pytest.mark.skipif(not HAVE, reason="no cascade XMLs")


def _clip(T: int = 10, H: int = 240, W: int = 220, s: int = 100):
    """T RGB uint8 frames of a face drifting 4 px a frame with +-3 px
    jitter, the severe mouth occluder on frames 3-6."""
    rng = np.random.default_rng(3)
    frames = np.zeros((T, H, W, 3), np.uint8)
    for t in range(T):
        cx = 75 + 4.0 * t + rng.integers(-3, 4)
        cy = 125 + rng.integers(-3, 4)
        img, _ = draw_face(H, W, cx, cy, s, 1.0, rng, 3.0)
        if 3 <= t <= 6:
            y0, x0 = int(cy + 0.35 * s), int(cx - 0.3 * s)
            img[y0: y0 + int(0.25 * s), x0: x0 + int(0.6 * s)] = 30
        frames[t] = np.repeat(np.clip(img, 0, 255)[..., None], 3, -1).astype(np.uint8)
    return frames


@pytest.fixture(scope="module")
def tracked():
    """The clip, each package's frontend and each package's track."""
    frames = _clip()
    fe_t, fe_j = th.HaarFaceFrontend(), jh.HaarFaceFrontend()
    return frames, fe_t, fe_j, fe_t.track_video(frames), fe_j.track_video(frames)


def test_track_equals_jax(tracked):
    _, _, _, got, ref = tracked
    assert got["acquired"] and ref["acquired"]
    np.testing.assert_array_equal(got["source"], ref["source"])
    np.testing.assert_array_equal(got["detected"], ref["detected"])
    np.testing.assert_array_equal(got["boxes"], ref["boxes"])
    np.testing.assert_array_equal(got["lms"], ref["lms"])
    assert (ref["source"] == 1).any()
    assert (ref["source"] == 2).any()      # eye-pair reacquisition fired


@pytest.mark.parametrize("backend", ["device", "host"])
def test_crop_video_matches_jax(tracked, backend, monkeypatch):
    """Both of the port's warps (``device`` on the CPU here) against both
    of the JAX package's, on the same track: at most one level apart
    (uint8 truncation of warps that differ in float32 rounding)."""
    frames, fe_t, fe_j, track, _ = tracked
    monkeypatch.setattr(fe_t, "track_video", lambda f: track)
    monkeypatch.setattr(fe_j, "track_video", lambda f: track)
    got, det = fe_t.crop_video(frames, warp_backend=backend, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (len(frames), 112, 112, 3)
    np.testing.assert_array_equal(det, track["detected"])
    for jb in ("host", "device"):
        ref, _ = fe_j.crop_video(frames, warp_backend=jb)
        assert np.abs(got.astype(int) - ref).max() <= 1
    if backend == "host":
        np.testing.assert_array_equal(got, fe_j.crop_video(frames, warp_backend="host")[0])


def test_a_clip_without_a_face_gives_one_zero_frame():
    frames = np.full((3, 100, 100, 3), 128, np.uint8)
    out, det = th.HaarFaceFrontend().crop_video(frames, size=64, device="cpu")
    assert out.shape == (1, 64, 64, 3) and out.sum() == 0 and not det.any()
