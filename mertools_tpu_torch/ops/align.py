"""Temporal feature alignment (port of ``mertools_tpu/ops/align.py``).

Reference semantics (``MERBench/toolkit/utils/read_data.py:72-125``):

``map_feature_np(x: (T, D), dst) -> (dst, D)``:
  * T == dst: identity.
  * T < dst : **front**-pad with zeros to length dst. (Front because the
    LSTM encoder reads only the final hidden state — reference
    ``toolkit/models/modules/encoder.py:67``.)
  * T > dst : front-pad with ``(dst - T % dst) % dst`` zeros so the padded
    length is ``dst * pool`` with ``pool = ceil(T / dst)``, then mean-pool
    consecutive groups of ``pool`` frames.

The host half (``*_np``) works on lists of (T, D) arrays. The batched
device half (``map_feature_batched``, ``masked_mean_over_time``,
``scale_compress_batched``) takes end-padded (B, T, D) buffers with their
lengths and applies the same semantics as one product with a (B, dst, T)
weight matrix, in fp32 (TF32 off on a card, ``core.device.resolve_device``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Device (torch) batched implementation.
# ---------------------------------------------------------------------------
def _group_weights(lengths: torch.Tensor, dst: torch.Tensor, src_len: int,
                   dst_len: int) -> torch.Tensor:
    """W (B, dst_len, src_len): the front-pad + mean-pool of each sample's
    ``lengths[b]`` valid frames onto its first ``dst[b]`` output rows
    (pool = ceil(len / dst), pad = dst * pool - len); rows past ``dst[b]``
    are 0."""
    pool = torch.clamp((lengths + dst - 1) // dst.clamp_min(1), min=1)
    pad = dst * pool - lengths
    t_idx = torch.arange(src_len, device=lengths.device)[None, None, :]
    j_idx = torch.arange(dst_len, device=lengths.device)[None, :, None]
    group = (t_idx + pad[:, None, None]) // pool[:, None, None]
    keep = ((group == j_idx) & (t_idx < lengths[:, None, None])
            & (j_idx < dst[:, None, None]))
    return keep.float() / pool[:, None, None].float()


def _mapping_weights(lengths: torch.Tensor, src_len: int, dst_len: int) -> torch.Tensor:
    """W (B, dst_len, src_len) such that out = W @ x_padded, for end-padded
    ``x_padded`` (B, src_len, D) with ``lengths`` valid frames a row: the
    reference's front-pad + mean-pool."""
    lengths = lengths.to(torch.int64)
    return _group_weights(lengths, torch.full_like(lengths, dst_len), src_len, dst_len)


def map_feature_batched(x: torch.Tensor, lengths: torch.Tensor, dst_len: int) -> torch.Tensor:
    """Batched reference-semantics resample: (B, T, D) + lengths (B,) ->
    (B, dst_len, D), one product in fp32, in x's dtype."""
    w = _mapping_weights(lengths, x.shape[1], dst_len)
    return torch.einsum("bjt,btd->bjd", w, x.float()).to(x.dtype)


def masked_mean_over_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, D) + lengths -> (B, D): the mean over each row's valid
    (end-padded) frames, the device ``align_to_utt`` (read_data.py:92-97)."""
    t_idx = torch.arange(x.shape[1], device=x.device)[None, :]
    mask = (t_idx < lengths[:, None]).float()
    total = torch.einsum("btd,bt->bd", x.float(), mask)
    return (total / lengths[:, None].clamp_min(1).float()).to(x.dtype)


def scale_compress_batched(x: torch.Tensor, lengths: torch.Tensor, scale: int,
                           dst_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``feature_scale_compress``: each row to ceil(len / scale)
    frames, at the front of an end-padded buffer of ``dst_len`` rows.
    Returns (y (B, dst_len, D), the new lengths)."""
    lengths = lengths.to(torch.int64)
    new_len = (lengths + scale - 1) // scale
    w = _group_weights(lengths, new_len, x.shape[1], dst_len)
    y = torch.einsum("bjt,btd->bjd", w, x.float()).to(x.dtype)
    return y, new_len
