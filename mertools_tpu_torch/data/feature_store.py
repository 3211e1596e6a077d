"""Per-clip ``.npy`` feature store, layout-compatible with the reference
(the port's copy of ``mertools_tpu/data/feature_store.py``).

Layout (reference ``MERBench/toolkit/utils/read_data.py:15-41``):
  * ``{root}/{model}-UTT/{clip}.npy``  -> (D,) or (1, D)
  * ``{root}/{model}-FRA/{clip}.npy``  -> (T, D)
  * or a directory ``{root}/{feat}/{clip}/``   of per-frame ``.npy`` files
    (OpenFace-style), concatenated in sorted order.

Reads normalize to (T, D) float32 (a (D,) vector becomes (1, D)), exactly as
``func_read_one_feat``. The reference fans reads over a ``Pool(8)``; here
they are serial, one ``open`` and one ``read`` a file: a thread pool of
``np.load`` calls was slower than that on the H100 machine's 9p file system,
its threads taking turns at the GIL between short system calls.
"""

from __future__ import annotations

import io
import os

import numpy as np


def read_one_feature(root: str, name: str) -> np.ndarray:
    """Read one clip's feature as (T, D) float32."""
    path = os.path.join(root, name + ".npy")
    dir_path = os.path.join(root, name)
    try:
        with open(path, "rb", buffering=0) as f:
            feat = np.squeeze(np.load(io.BytesIO(f.read())))
    except FileNotFoundError:
        if not os.path.isdir(dir_path):
            raise FileNotFoundError(f"no feature at {path} or {dir_path}") from None
        frames = [np.load(os.path.join(dir_path, f))
                  for f in sorted(os.listdir(dir_path))]
        feat = np.squeeze(np.array(frames))
    if feat.ndim == 0 or feat.size == 0:
        raise ValueError(f"empty/garbled feature for {name} under {root}")
    if feat.ndim == 1:
        feat = feat[None, :]
    return np.ascontiguousarray(feat, dtype=np.float32)


def read_features(root: str, names: list[str]) -> tuple[list[np.ndarray], int]:
    """Read many clips; returns (features, feature_dim).

    Mirrors ``func_read_multiprocess`` (read_data.py:46-67) including the
    dim report taken from the first sample.
    """
    if len(names) == 0:
        return [], 0
    feats = [read_one_feature(root, n) for n in names]
    dim = feats[0].shape[-1]
    return feats, dim


def write_feature(root: str, name: str, feat: np.ndarray) -> str:
    """Write one clip's feature ((T, D) FRA or (D,) UTT), reference layout."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name + ".npy")
    np.save(path, np.asarray(feat, dtype=np.float32))
    return path


def check_completeness(root: str, names: list[str]) -> list[str]:
    """Names missing from the store (reference functions.py:297-326)."""
    missing = []
    for name in names:
        if not (os.path.exists(os.path.join(root, name + ".npy"))
                or os.path.isdir(os.path.join(root, name))):
            missing.append(name)
    return missing
