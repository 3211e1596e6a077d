"""Per-clip ``.npy`` feature store, layout-compatible with the reference
(the port's copy of ``mertools_tpu/data/feature_store.py``).

Layout (reference ``MERBench/toolkit/utils/read_data.py:15-41``):
  * ``{root}/{model}-UTT/{clip}.npy``  -> (D,) or (1, D)
  * ``{root}/{model}-FRA/{clip}.npy``  -> (T, D)
  * or a directory ``{root}/{feat}/{clip}/``   of per-frame ``.npy`` files
    (OpenFace-style), concatenated in sorted order.

Reads normalize to (T, D) float32 (a (D,) vector becomes (1, D)), exactly as
``func_read_one_feat``. The reference fans reads over a ``Pool(8)``; here a
thread pool overlaps the (IO-bound) reads, with a serial path for one
worker.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def read_one_feature(root: str, name: str) -> np.ndarray:
    """Read one clip's feature as (T, D) float32."""
    path = os.path.join(root, name + ".npy")
    dir_path = os.path.join(root, name)
    if os.path.exists(path):
        feat = np.load(path)
        feat = np.squeeze(feat)
    elif os.path.isdir(dir_path):
        frames = [np.load(os.path.join(dir_path, f))
                  for f in sorted(os.listdir(dir_path))]
        feat = np.squeeze(np.array(frames))
    else:
        raise FileNotFoundError(f"no feature at {path} or {dir_path}")
    if feat.ndim == 0 or feat.size == 0:
        raise ValueError(f"empty/garbled feature for {name} under {root}")
    if feat.ndim == 1:
        feat = feat[None, :]
    return np.ascontiguousarray(feat, dtype=np.float32)


def read_features(root: str, names: list[str], max_workers: int = 8
                  ) -> tuple[list[np.ndarray], int]:
    """Read many clips; returns (features, feature_dim).

    Mirrors ``func_read_multiprocess`` (read_data.py:46-67) including the
    dim report taken from the first sample.
    """
    if len(names) == 0:
        return [], 0
    if max_workers <= 1:
        feats = [read_one_feature(root, n) for n in names]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            feats = list(pool.map(lambda n: read_one_feature(root, n), names))
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
