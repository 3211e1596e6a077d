"""Viola-Jones cascade engine of the face frontend — port of
``mertools_tpu/ops/viola_jones.py`` (host code, numpy as it is).

- new-format stump cascade XML parser (24x24 face / 20x20 eye models); the
  two cascades the frontend reads, OpenCV's Intel-licensed
  ``haarcascade_frontalface_default.xml`` and ``haarcascade_eye.xml``, ship
  in ``ops/cascades/`` with their license headers;
- image-pyramid multiscale detection with integral-image window sums,
  variance normalization and staged rejection;
- OpenCV-style min-neighbors rectangle grouping.

Two window evaluators compute the same survivors: the native one
(``mertools_tpu_torch/native/merhaar.cpp``, per-window early rejection,
rows in parallel on one thread a core), built with ``g++`` at first use into
``build/native/`` with the source's hash in the file name, and the
vectorized numpy one, the plain version. ``backend="auto"`` is the native
evaluator, and a failed build raises; only tests and parity checks select
``"numpy"``, by name. :data:`EVALUATOR_CALLS` counts the single-scale
evaluations of each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np

PACKAGE_CASCADES = str(Path(__file__).resolve().parent / "cascades")
CASCADE_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
)

FRONTALFACE = "haarcascade_frontalface_default.xml"
EYE = "haarcascade_eye.xml"

HAAR_SOURCE = Path(__file__).resolve().parents[1] / "native" / "merhaar.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

# single-scale window evaluations by backend, since the process started
EVALUATOR_CALLS = {"native": 0, "numpy": 0}


def find_cascade(name: str) -> str:
    """``MERTOOLS_CASCADE_DIR``, then the package's own ``cascades/``, then
    OpenCV's system directories."""
    override = os.environ.get("MERTOOLS_CASCADE_DIR")
    dirs = ((override,) if override else ()) + (PACKAGE_CASCADES,) + CASCADE_DIRS
    for d in dirs:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"cascade {name!r} not found in {dirs}; set MERTOOLS_CASCADE_DIR")


@dataclass
class Stage:
    threshold: float
    feat_idx: np.ndarray    # (K,) int32
    stump_thr: np.ndarray   # (K,) float32
    leaves: np.ndarray      # (K, 2) float32 [below, above]


@dataclass
class Cascade:
    window: int                      # square window side (width == height)
    stages: list
    rects: np.ndarray                # (F, 3, 4) int32 x,y,w,h (zero-padded)
    weights: np.ndarray              # (F, 3) float32 (0 for padding)

    @property
    def n_features(self) -> int:
        return len(self.rects)


def load_cascade(path: str) -> Cascade:
    root = ET.parse(path).getroot()
    c = root.find("cascade")
    if c is None:
        raise ValueError(f"{path}: not a new-format cascade file")
    if c.findtext("featureType", "HAAR").strip() != "HAAR":
        raise ValueError("only HAAR cascades supported")
    w = int(c.findtext("width"))
    h = int(c.findtext("height"))
    if w != h:
        raise ValueError("non-square cascade windows unsupported")

    stages = []
    for st in c.find("stages"):
        thr = float(st.findtext("stageThreshold"))
        fi, sthr, leaves = [], [], []
        for weak in st.find("weakClassifiers"):
            nodes = weak.findtext("internalNodes").split()
            lv = [float(x) for x in weak.findtext("leafValues").split()]
            if len(nodes) != 4 or len(lv) != 2:
                raise ValueError("only stump cascades supported")
            fi.append(int(nodes[2]))
            sthr.append(float(nodes[3]))
            leaves.append(lv)
        stages.append(Stage(thr, np.asarray(fi, np.int32),
                            np.asarray(sthr, np.float32),
                            np.asarray(leaves, np.float32)))

    feats = c.find("features")
    F = len(feats)
    rects = np.zeros((F, 3, 4), np.int32)
    weights = np.zeros((F, 3), np.float32)
    for i, f in enumerate(feats):
        rs = f.find("rects")
        if f.find("tilted") is not None and f.findtext("tilted").strip() == "1":
            raise ValueError("tilted features unsupported")
        for j, r in enumerate(rs):
            vals = r.text.split()
            rects[i, j] = [int(v) for v in vals[:4]]
            weights[i, j] = float(vals[4])
    return Cascade(w, stages, rects, weights)


def _integral(img: np.ndarray):
    H, W = img.shape
    ii = np.zeros((H + 1, W + 1), np.float64)
    sq = np.zeros((H + 1, W + 1), np.float64)
    np.cumsum(np.cumsum(img, 0), 1, out=ii[1:, 1:])
    np.cumsum(np.cumsum(img.astype(np.float64) ** 2, 0), 1, out=sq[1:, 1:])
    return ii, sq


def _rect_sums(ii, ys, xs, rects):
    """rects (K, 3, 4); ys/xs (P,) -> per-feature weighted sums (K, P)."""
    ry = rects[:, :, 1][..., None] + ys[None, None]      # (K, 3, P)
    rx = rects[:, :, 0][..., None] + xs[None, None]
    rh = rects[:, :, 3][..., None]
    rw = rects[:, :, 2][..., None]
    return (ii[ry + rh, rx + rw] - ii[ry, rx + rw]
            - ii[ry + rh, rx] + ii[ry, rx])


# ---------------------------------------------------------------------------
# native evaluator (native/merhaar.cpp): per-window staged short-circuiting —
# most windows die within the first stages, which the vectorized numpy path
# cannot exploit (it evaluates every stage feature for every live window)
# ---------------------------------------------------------------------------


def build_native() -> Path:
    """Compile ``merhaar.cpp`` unless a library with its hash exists; the
    build is atomic, so concurrent processes never load half a file.
    Raises RuntimeError naming the compiler's output if the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(HAAR_SOURCE.read_bytes())
    out = BUILD_DIR / f"libmerhaar_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(HAAR_SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {HAAR_SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{HAAR_SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _native_lib() -> ctypes.CDLL:
    """The native evaluator, built on first call, its entry point declared."""
    lib = ctypes.CDLL(str(build_native()))
    c_dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_lp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.mer_haar_detect.restype = ctypes.c_long
    lib.mer_haar_detect.argtypes = [
        c_dp, c_dp, ctypes.c_long, ctypes.c_long,       # ii, sq, H1, W1
        ctypes.c_long, ctypes.c_long,                   # window, stride
        c_lp, c_dp, ctypes.c_long,                      # stage off/thr/n
        c_lp, c_fp, c_fp,                               # feat_idx/thr/leaves
        c_lp, c_fp,                                     # rects, weights
        c_lp, ctypes.c_long]                            # out, max_out
    return lib


def _flat_cascade(casc: Cascade):
    """Flatten stages into contiguous stump arrays (cached on the object)."""
    flat = getattr(casc, "_flat", None)
    if flat is None:
        off = np.zeros(len(casc.stages) + 1, np.int64)
        fi, thr, lv, sthr = [], [], [], []
        for i, st in enumerate(casc.stages):
            off[i + 1] = off[i] + len(st.feat_idx)
            fi.append(st.feat_idx.astype(np.int64))
            thr.append(st.stump_thr.astype(np.float32))
            lv.append(st.leaves.astype(np.float32))
            sthr.append(float(st.threshold))
        flat = (off, np.asarray(sthr, np.float64),
                np.ascontiguousarray(np.concatenate(fi)),
                np.ascontiguousarray(np.concatenate(thr)),
                np.ascontiguousarray(np.concatenate(lv).reshape(-1, 2)),
                np.ascontiguousarray(casc.rects.astype(np.int64)),
                np.ascontiguousarray(casc.weights.astype(np.float32)))
        casc._flat = flat
    return flat


def _detect_single_scale_native(ii, sq, casc: Cascade, stride: int):
    lib = _native_lib()
    EVALUATOR_CALLS["native"] += 1
    W = casc.window
    H_i, W_i = ii.shape[0] - 1, ii.shape[1] - 1
    if H_i < W or W_i < W:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    off, sthr, fi, thr, lv, rects, wts = _flat_cascade(casc)
    n_max = ((H_i - W) // stride + 1) * ((W_i - W) // stride + 1)
    out = np.zeros((max(n_max, 1), 2), np.int64)
    n = lib.mer_haar_detect(
        np.ascontiguousarray(ii), np.ascontiguousarray(sq),
        ii.shape[0], ii.shape[1], W, stride,
        off, sthr, len(casc.stages), fi, thr, lv,
        rects.reshape(-1), wts.reshape(-1), out.reshape(-1), n_max)
    return out[:n, 0].copy(), out[:n, 1].copy()


def _detect_single_scale(ii, sq, casc: Cascade, stride: int):
    """All surviving window origins (y, x) at this pyramid level: the
    plain version of the native evaluator."""
    EVALUATOR_CALLS["numpy"] += 1
    W = casc.window
    H_i, W_i = ii.shape[0] - 1, ii.shape[1] - 1
    if H_i < W or W_i < W:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ys, xs = np.mgrid[0: H_i - W + 1: stride, 0: W_i - W + 1: stride]
    ys, xs = ys.ravel(), xs.ravel()

    # variance normalization over the (1,1,W-2,W-2) norm rect (OpenCV layout)
    area = (W - 2) ** 2
    y0, x0 = ys + 1, xs + 1
    s = (ii[y0 + W - 2, x0 + W - 2] - ii[y0, x0 + W - 2]
         - ii[y0 + W - 2, x0] + ii[y0, x0])
    s2 = (sq[y0 + W - 2, x0 + W - 2] - sq[y0, x0 + W - 2]
          - sq[y0 + W - 2, x0] + sq[y0, x0])
    nf = area * s2 - s * s
    vnf = np.where(nf > 0, 1.0 / np.sqrt(np.maximum(nf, 1e-12)), 1.0)

    for st in casc.stages:
        if len(ys) == 0:
            break
        rects = casc.rects[st.feat_idx]            # (K, 3, 4)
        wts = casc.weights[st.feat_idx]            # (K, 3)
        sums = _rect_sums(ii, ys, xs, rects)       # (K, 3, P)
        fv = np.einsum("kr,krp->kp", wts, sums) * vnf[None]
        # float64 stage sums: np.where(bool, f32, f32) would sum in float32
        # while the native evaluator accumulates in double — keep both paths
        # in f64 so they only differ by summation order (~1e-16)
        contrib = np.where(fv < st.stump_thr[:, None],
                           st.leaves[:, 0][:, None].astype(np.float64),
                           st.leaves[:, 1][:, None].astype(np.float64))
        keep = contrib.sum(0) >= st.threshold
        ys, xs, vnf = ys[keep], xs[keep], vnf[keep]
    return ys, xs


def group_rectangles(boxes: np.ndarray, min_neighbors: int = 3,
                     eps: float = 0.2) -> np.ndarray:
    """OpenCV-style grouping: cluster boxes whose sides agree within eps,
    average each cluster, keep clusters with > min_neighbors members.
    boxes (N, 4) [x, y, w, h] -> (M, 5) [x, y, w, h, neighbors]."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 5), np.float32)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    b = boxes.astype(np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            delta = eps * (min(b[i, 2], b[j, 2]) + min(b[i, 3], b[j, 3])) * 0.5
            if (abs(b[i, 0] - b[j, 0]) <= delta and abs(b[i, 1] - b[j, 1]) <= delta
                    and abs(b[i, 0] + b[i, 2] - b[j, 0] - b[j, 2]) <= delta
                    and abs(b[i, 1] + b[i, 3] - b[j, 1] - b[j, 3]) <= delta):
                parent[find(i)] = find(j)
    roots = np.asarray([find(i) for i in range(n)])
    out = []
    for r in np.unique(roots):
        members = b[roots == r]
        if len(members) > min_neighbors or (min_neighbors == 0):
            m = members.mean(0)
            out.append([m[0], m[1], m[2], m[3], len(members)])
    return np.asarray(out, np.float32).reshape(-1, 5)


def detect_multiscale(gray: np.ndarray, casc: Cascade,
                      scale_factor: float = 1.1, min_neighbors: int = 3,
                      min_size: int = 40, max_size: int | None = None,
                      stride: int = 1, backend: str = "auto") -> np.ndarray:
    """Detect objects in a grayscale uint8/float image.

    Returns (M, 5) [x, y, w, h, neighbors] in input-pixel coordinates,
    sorted by neighbor count (strongest first). ``backend``: 'auto' and
    'native' use the short-circuiting C++ evaluator (built at first use; a
    failed build raises), 'numpy' the vectorized plain version."""
    single = {"auto": _detect_single_scale_native,
              "native": _detect_single_scale_native,
              "numpy": _detect_single_scale}[backend]
    gray = np.asarray(gray, np.float64)
    H, W = gray.shape
    raw = []
    scale = float(casc.window) / max(min_size, casc.window)
    # pyramid: detected window size = casc.window / scale
    while True:
        win_orig = casc.window / scale
        if max_size is not None and win_orig > max_size:
            break
        h, w = int(round(H * scale)), int(round(W * scale))
        if h < casc.window or w < casc.window:
            break
        yy = (np.arange(h) + 0.5) / scale - 0.5
        xx = (np.arange(w) + 0.5) / scale - 0.5
        yi = np.clip(np.round(yy).astype(int), 0, H - 1)
        xi = np.clip(np.round(xx).astype(int), 0, W - 1)
        level = gray[np.ix_(yi, xi)]
        ii, sq = _integral(level)
        ys, xs = single(ii, sq, casc, stride)
        for y, x in zip(ys, xs):
            raw.append([x / scale, y / scale, win_orig, win_orig])
        scale /= scale_factor
    boxes = group_rectangles(np.asarray(raw, np.float64).reshape(-1, 4),
                             min_neighbors)
    if len(boxes):
        boxes = boxes[np.argsort(-boxes[:, 4])]
    return boxes
