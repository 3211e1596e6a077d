"""In-memory trimodal feature dataset and its batch plan (port of
``mertools_tpu/data/dataset.py:1-141,204-211``).

Equivalent of ``Data_Feat`` (reference ``MERBench/toolkit/data/feat_data.py:6-82``)
plus the loader plumbing of ``toolkit/dataloader/*``:

  1. read per-clip features for the three modalities from the feature store,
  2. ``feature_scale_compress`` by ``feat_scale`` (1 for utt / 6 frm_align /
     12 frm_unalign — reference main-release.py:130-142),
  3. align per ``feat_type``:
     * ``utt``         : temporal mean -> (N, D) per modality
     * ``frm_align``   : resample audio/video to the text length per sample
     * ``frm_unalign`` : keep native lengths
  4. **front**-pad frame-level modalities to a dataset-wide max length, so
     every batch has one shape (the reference front-pads to the batch max;
     the LSTM encoders read the last step, so leading zeros are the same
     mechanism).

Batching is an index plan (:func:`epoch_plan`): shuffled indices padded to a
multiple of the batch size by wrapping, with a validity mask. The trainer
keeps the dataset on the device and gathers each batch there.

:class:`TopNFeatureDataset` is top-N fusion's (``dataset.py:144-201``): the
best N UTT stores of each modality slot, as ``feat0..feat{K-1}``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from ..core import globals_mer as G
from ..ops import align
from . import feature_store


def _front_pad_stack(feats: list[np.ndarray], max_len: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Front-pad ragged (T, D) features to a common length -> (N, L, D)."""
    lengths = np.array([len(f) for f in feats], dtype=np.int32)
    max_len = int(max_len if max_len is not None else lengths.max())
    out = np.stack([align.map_feature_np(f, max_len) for f in feats]).astype(np.float32)
    return out, lengths


@dataclass
class FeatureDataset:
    names: list[str]
    audios: np.ndarray          # (N, Da) utt | (N, La, Da) frm
    texts: np.ndarray           # (N, Dt) utt | (N, Lt, Dt) frm
    videos: np.ndarray          # (N, Dv) utt | (N, Lv, Dv) frm
    emos: np.ndarray            # (N,) int32
    vals: np.ndarray            # (N,) float32
    feat_type: str = "utt"
    audio_lens: np.ndarray | None = None
    text_lens: np.ndarray | None = None
    video_lens: np.ndarray | None = None

    def __len__(self):
        return len(self.names)

    @property
    def adim(self):
        return self.audios.shape[-1]

    @property
    def tdim(self):
        return self.texts.shape[-1]

    @property
    def vdim(self):
        return self.videos.shape[-1]

    def arrays(self) -> dict[str, np.ndarray]:
        """What the trainer keeps on the device."""
        return {"audios": self.audios, "texts": self.texts,
                "videos": self.videos, "emos": self.emos, "vals": self.vals}

    @classmethod
    def build(cls, names, emos, vals, audio_root, text_root, video_root,
              feat_type="utt", feat_scale=1) -> "FeatureDataset":
        if feat_type not in ("utt", "frm_align", "frm_unalign"):
            raise ValueError(f"unknown feat_type {feat_type!r}")
        audios, _ = feature_store.read_features(audio_root, names)
        texts, _ = feature_store.read_features(text_root, names)
        videos, _ = feature_store.read_features(video_root, names)
        return cls.from_raw(names, emos, vals, audios, texts, videos,
                            feat_type, feat_scale)

    @classmethod
    def from_raw(cls, names, emos, vals, audios, texts, videos,
                 feat_type="utt", feat_scale=1,
                 max_lens: tuple[int | None, int | None, int | None] = (None, None, None),
                 ) -> "FeatureDataset":
        """Build from already-read ragged (T, D) lists."""
        audios = align.feature_scale_compress_np(audios, feat_scale)
        texts = align.feature_scale_compress_np(texts, feat_scale)
        videos = align.feature_scale_compress_np(videos, feat_scale)

        kw: dict = {}
        if feat_type == "utt":
            a = align.align_to_utt_np(audios).astype(np.float32)
            t = align.align_to_utt_np(texts).astype(np.float32)
            v = align.align_to_utt_np(videos).astype(np.float32)
        elif feat_type == "frm_align":
            audios, texts, videos = align.align_to_text_np(audios, texts, videos)
            a, la = _front_pad_stack(audios, max_lens[0])
            t, lt = _front_pad_stack(texts, max_lens[1] or a.shape[1])
            v, lv = _front_pad_stack(videos, max_lens[2] or a.shape[1])
            kw = dict(audio_lens=la, text_lens=lt, video_lens=lv)
        else:  # frm_unalign
            a, la = _front_pad_stack(audios, max_lens[0])
            t, lt = _front_pad_stack(texts, max_lens[1])
            v, lv = _front_pad_stack(videos, max_lens[2])
            kw = dict(audio_lens=la, text_lens=lt, video_lens=lv)

        return cls(names=list(names), audios=a, texts=t, videos=v,
                   emos=np.asarray(emos, np.int32),
                   vals=np.asarray(vals, np.float32),
                   feat_type=feat_type, **kw)


def epoch_plan(indices: np.ndarray, batch_size: int,
               rng: np.random.Generator | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Static-shape batch plan: (idx (nb, B) int32, mask (nb, B) float32).

    Shuffles when ``rng`` is given (training); pads the tail batch by wrapping
    to the front with mask=0 so every batch has the same shape.
    """
    indices = np.asarray(indices, dtype=np.int32)
    if rng is not None:
        indices = indices.copy()
        rng.shuffle(indices)
    n = len(indices)
    nb = max(1, math.ceil(n / batch_size))
    total = nb * batch_size
    mask = np.zeros(total, np.float32)
    mask[:n] = 1.0
    padded = np.tile(indices, math.ceil(total / n))[:total]
    return padded.reshape(nb, batch_size), mask.reshape(nb, batch_size)


@dataclass
class TopNFeatureDataset:
    """Top-N fusion dataset: N feature sets per modality slot, all UTT
    (reference ``MER2024/toolkit/data/feat_data_topn.py:9-60``).

    ``arrays()`` exposes ``feat0..feat{K-1}`` for ``attention_topn``.
    """
    names: list[str]
    feats: list[np.ndarray]      # K x (N, D_k)
    emos: np.ndarray
    vals: np.ndarray
    feat_type: str = "utt"

    def __len__(self):
        return len(self.names)

    @property
    def feat_dims(self) -> list[int]:
        return [f.shape[-1] for f in self.feats]

    # the FeatureDataset protocol main_release reads
    adim = property(lambda self: self.feats[0].shape[-1])
    tdim = property(lambda self: self.feats[0].shape[-1])
    vdim = property(lambda self: self.feats[0].shape[-1])

    def arrays(self) -> dict[str, np.ndarray]:
        out = {f"feat{i}": f for i, f in enumerate(self.feats)}
        out["emos"] = self.emos
        out["vals"] = self.vals
        return out

    @staticmethod
    def feature_names(topn: int, modality: str = "AVT") -> list[str]:
        """The best ``topn`` encoders of each of the modality's three rank
        slots. ``AT`` and ``VT`` take the text ranking twice and ``AV`` the
        image ranking twice, as the JAX package does
        (``dataset.py:181-188``)."""
        ranks = {"AVT": [G.AUDIO_RANK_LOW2HIGH, G.TEXT_RANK_LOW2HIGH,
                         G.IMAGE_RANK_LOW2HIGH],
                 "AT": [G.AUDIO_RANK_LOW2HIGH, G.TEXT_RANK_LOW2HIGH,
                        G.TEXT_RANK_LOW2HIGH],
                 "AV": [G.AUDIO_RANK_LOW2HIGH, G.IMAGE_RANK_LOW2HIGH,
                        G.IMAGE_RANK_LOW2HIGH],
                 "VT": [G.TEXT_RANK_LOW2HIGH, G.TEXT_RANK_LOW2HIGH,
                        G.IMAGE_RANK_LOW2HIGH]}[modality]
        return [name for rank in ranks for name in rank[-topn:]]

    @classmethod
    def build(cls, names, emos, vals, features_root, topn: int,
              modality: str = "AVT", snr: str | None = None) -> "TopNFeatureDataset":
        feats = []
        for fname in cls.feature_names(topn, modality):
            root = os.path.join(features_root,
                                snr_variant(G.feature_dir_name(fname, "UTT"), snr))
            raw, _ = feature_store.read_features(root, names)
            feats.append(align.align_to_utt_np(raw).astype(np.float32))
        return cls(names=list(names), feats=feats,
                   emos=np.asarray(emos, np.int32),
                   vals=np.asarray(vals, np.float32))


def snr_variant(feature_dir: str, snr: str | None) -> str:
    """Insert the noise tag before the level suffix:
    ``name-UTT`` -> ``name-noisesnrmix-UTT`` (MER2024 feat_data.py:13-22;
    the separator char mirrors the one before the suffix)."""
    if not snr:
        return feature_dir
    sep = feature_dir[-4]
    return sep.join([feature_dir[:-4], snr, feature_dir[-3:]])
