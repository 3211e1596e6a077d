"""Temporal feature alignment, host half (port of
``mertools_tpu/ops/align.py:43-88``).

Reference semantics (``MERBench/toolkit/utils/read_data.py:72-125``):

``map_feature_np(x: (T, D), dst) -> (dst, D)``:
  * T == dst: identity.
  * T < dst : **front**-pad with zeros to length dst. (Front because the
    LSTM encoder reads only the final hidden state — reference
    ``toolkit/models/modules/encoder.py:67``.)
  * T > dst : front-pad with ``(dst - T % dst) % dst`` zeros so the padded
    length is ``dst * pool`` with ``pool = ceil(T / dst)``, then mean-pool
    consecutive groups of ``pool`` frames.

The JAX module's batched device half (``:94-170``) has no caller outside
its tests; it waits for ROADMAP A7.
"""

from __future__ import annotations

import math

import numpy as np


def map_feature_np(x: np.ndarray, dst_len: int) -> np.ndarray:
    """Resample one (T, D) feature to (dst_len, D) with reference semantics."""
    t, d = x.shape
    if t == dst_len:
        return x
    if t < dst_len:
        pad = np.zeros((dst_len - t, d), dtype=x.dtype)
        return np.concatenate([pad, x], axis=0)
    pool = t // dst_len if t % dst_len == 0 else t // dst_len + 1
    pad_len = dst_len * pool - t
    pad = np.zeros((pad_len, d), dtype=x.dtype)
    stacked = np.concatenate([pad, x], axis=0).reshape(dst_len, pool, d)
    return stacked.mean(axis=1)


def align_to_utt_np(feats: list[np.ndarray]) -> np.ndarray:
    """Mean over time per sample -> (N, D). (read_data.py:92-97)"""
    return np.stack([f.mean(axis=0) for f in feats], axis=0)


def feature_scale_compress_np(feats: list[np.ndarray], scale: int) -> list[np.ndarray]:
    """Compress each sample to ceil(T/scale) frames. (read_data.py:100-105)"""
    if scale == 1:
        return feats
    return [map_feature_np(f, math.ceil(len(f) / scale)) for f in feats]


def align_to_text_np(audios, texts, videos):
    """Resample audio/video (and text, a no-op) to the text length per sample.
    (read_data.py:108-114)"""
    out_a, out_t, out_v = [], [], []
    for a, t, v in zip(audios, texts, videos):
        dst = len(t)
        out_a.append(map_feature_np(a, dst))
        out_t.append(map_feature_np(t, dst))
        out_v.append(map_feature_np(v, dst))
    return out_a, out_t, out_v


def pad_to_maxlen_np(feats: list[np.ndarray], max_len: int | None = None):
    """Front-pad every sample to the max length; returns (N, L, D) + lengths.
    (read_data.py:117-125 — reference pads with map_feature to batch max)"""
    lengths = np.array([len(f) for f in feats], dtype=np.int32)
    max_len = int(max_len if max_len is not None else lengths.max())
    out = np.stack([map_feature_np(f, max_len) for f in feats], axis=0)
    return out, lengths
