"""The port's Viola-Jones engine against the JAX package's
``ops/viola_jones.py``: the packaged cascades parse to the same arrays as
OpenCV's, and on drawn faces ``detect_multiscale`` finds the same windows
with each backend (the native evaluator built from the port's own
``merhaar.cpp``, and the numpy one); a failed build raises."""

import numpy as np
import pytest
from test_face_frontend_fidelity import draw_face

from mertools_tpu.ops import viola_jones as jvj
from mertools_tpu_torch.ops import viola_jones as tvj

try:
    jvj.find_cascade(jvj.FRONTALFACE)
    HAVE = True
except FileNotFoundError:
    HAVE = False

needs_cascades = pytest.mark.skipif(not HAVE, reason="no cascade XMLs")


@pytest.fixture(scope="module")
def cascades():
    """Each cascade parsed once per module, by both packages."""
    return {n: (tvj.load_cascade(tvj.find_cascade(n)),
                jvj.load_cascade(jvj.find_cascade(n)))
            for n in (tvj.FRONTALFACE, tvj.EYE)}


def _images():
    """Three drawn faces (the last with the severe mouth occluder) and a
    frame of noise, grayscale float64."""
    rng = np.random.default_rng(0)
    a, _ = draw_face(200, 180, 90, 100, 80, 1.0, rng, 3.0)
    b, _ = draw_face(220, 200, 100, 110, 96, 0.85, rng, 6.0)
    c, _ = draw_face(180, 170, 85, 92, 70, 1.0, rng, 3.0)
    c[int(92 + 0.35 * 70): int(92 + 0.6 * 70), int(85 - 0.3 * 70): int(85 + 0.3 * 70)] = 30
    d = rng.integers(0, 255, (120, 110)).astype(np.float64)
    return [a, b, c, d]


def test_packaged_cascades_are_found_first():
    for name in (tvj.FRONTALFACE, tvj.EYE):
        assert tvj.find_cascade(name).startswith(tvj.PACKAGE_CASCADES)


@needs_cascades
@pytest.mark.parametrize("name", [tvj.FRONTALFACE, tvj.EYE])
def test_cascade_parse_equals_jax(cascades, name):
    t, j = cascades[name]
    assert t.window == j.window and len(t.stages) == len(j.stages)
    np.testing.assert_array_equal(t.rects, j.rects)
    np.testing.assert_array_equal(t.weights, j.weights)
    for st, sj in zip(t.stages, j.stages):
        assert st.threshold == sj.threshold
        np.testing.assert_array_equal(st.feat_idx, sj.feat_idx)
        np.testing.assert_array_equal(st.stump_thr, sj.stump_thr)
        np.testing.assert_array_equal(st.leaves, sj.leaves)


@needs_cascades
def test_single_scale_windows_equal_jax_both_backends(cascades):
    """Window for window at the pyramid levels where the first face fits
    the 24 px window, and at full resolution: the port's native and numpy
    evaluators and the JAX package's numpy one find the same survivors."""
    t, j = cascades[tvj.FRONTALFACE]
    img = _images()[0]
    survivors = 0
    for scale in (0.16, 0.17, 0.18, 0.19, 1.0):
        h, w = int(round(img.shape[0] * scale)), int(round(img.shape[1] * scale))
        yi = np.clip(np.round((np.arange(h) + 0.5) / scale - 0.5).astype(int),
                     0, img.shape[0] - 1)
        xi = np.clip(np.round((np.arange(w) + 0.5) / scale - 0.5).astype(int),
                     0, img.shape[1] - 1)
        ii, sq = tvj._integral(img[np.ix_(yi, xi)])
        ref = jvj._detect_single_scale(ii, sq, j, stride=1)
        for fn in (tvj._detect_single_scale_native, tvj._detect_single_scale):
            ys, xs = fn(ii, sq, t, stride=1)
            np.testing.assert_array_equal(ys, ref[0])
            np.testing.assert_array_equal(xs, ref[1])
        survivors += len(ref[0])
    assert survivors >= 5


@needs_cascades
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_detect_multiscale_equals_jax(cascades, backend, monkeypatch):
    """Every pyramid level's windows, grouped: equal to the JAX package's
    on the same backend, and the port's counter names the backend that
    ran."""
    t, j = cascades[tvj.FRONTALFACE]
    monkeypatch.setattr(tvj, "EVALUATOR_CALLS", {"native": 0, "numpy": 0})
    found = 0
    for img in _images():
        got = tvj.detect_multiscale(img, t, min_neighbors=1, min_size=60,
                                    backend=backend)
        ref = jvj.detect_multiscale(img, j, min_neighbors=1, min_size=60,
                                    backend=backend)
        np.testing.assert_array_equal(got, ref)
        found += len(got)
    assert found >= 2                      # the unoccluded faces
    other = "numpy" if backend == "native" else "native"
    assert tvj.EVALUATOR_CALLS[backend] > 0 and tvj.EVALUATOR_CALLS[other] == 0


def test_auto_is_the_native_evaluator():
    calls = dict(tvj.EVALUATOR_CALLS)
    img = np.full((60, 60), 128.0)
    tvj.detect_multiscale(img, tvj.load_cascade(tvj.find_cascade(tvj.EYE)),
                          min_size=40)
    assert tvj.EVALUATOR_CALLS["native"] > calls["native"]
    assert tvj.EVALUATOR_CALLS["numpy"] == calls["numpy"]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "merhaar.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tvj, "HAAR_SOURCE", bad)
    monkeypatch.setattr(tvj, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="merhaar.cpp"):
        tvj.build_native()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_build_is_named_by_the_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "merhaar.cpp"
    src.write_bytes(tvj.HAAR_SOURCE.read_bytes())
    monkeypatch.setattr(tvj, "HAAR_SOURCE", src)
    monkeypatch.setattr(tvj, "BUILD_DIR", tmp_path / "build")
    first = tvj.build_native()
    assert first.exists() and tvj.build_native() == first
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert tvj.build_native() != first
