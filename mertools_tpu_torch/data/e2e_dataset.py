"""Raw-input dataset for end-to-end fine-tuning (port of
``mertools_tpu/data/e2e_dataset.py``; reference ``toolkit/data/
e2e_data.py``).

Per modality (reference semantics):
- text : transcripts CSV -> tokenizer, longest padding, empty subtitles get
  a placeholder (e2e_data.py:63-70, NaN guard);
- audio: wav -> 8 uniform 2 s windows (ImageBind-style clip sampling) ->
  (8, 32000) float;
- video: face npy -> n_frms uniform frames (e2e_data.py:72-86).

Everything is built into fixed-shape host arrays, which the trainer uploads
once and gathers batches from on the device, as it does the feature
datasets (the ``arrays()`` protocol). Video defaults to the compact layout:
source-resolution uint8 frames (``videos_u8``), resized and normalised on
the device inside the model's forward (~600 KB a clip instead of ~9.6 MB of
float frames).
"""

from __future__ import annotations

import csv
import os
import warnings
from dataclasses import dataclass

import numpy as np

from ..features.vision import CLIP_MEAN, CLIP_STD

SEG_N = 8
SEG_LEN = 2 * 16000


def audio_segments(wav: np.ndarray, n_seg: int = SEG_N,
                   seg_len: int = SEG_LEN) -> np.ndarray:
    """Uniform n_seg windows of seg_len samples; short wavs tile."""
    wav = np.asarray(wav, np.float32)
    if len(wav) < seg_len:
        wav = np.resize(wav, seg_len)
    starts = np.linspace(0, len(wav) - seg_len, n_seg).astype(int)
    return np.stack([wav[s: s + seg_len] for s in starts])


@dataclass
class E2EDataset:
    names: list
    emos: np.ndarray
    vals: np.ndarray
    modality: str
    data: dict            # modality-specific arrays

    def __len__(self):
        return len(self.names)

    # FeatureDataset protocol compat (dims are meaningless for raw inputs)
    adim = tdim = vdim = property(lambda self: -1)
    feat_type = "utt"

    def arrays(self) -> dict:
        out = dict(self.data)
        out["emos"] = self.emos
        out["vals"] = self.vals
        return out

    @classmethod
    def _of(cls, names, emos, vals, modality: str, data: dict) -> "E2EDataset":
        return cls(list(names), np.asarray(emos, np.int32),
                   np.asarray(vals, np.float32), modality, data)

    @classmethod
    def build_audio(cls, names, emos, vals, audio_root, n_seg: int = SEG_N,
                    seg_len: int = SEG_LEN) -> "E2EDataset":
        from ..io import wav as wav_io

        auds = np.stack([audio_segments(
            wav_io.read_wav_16k(os.path.join(audio_root, f"{n}.wav")),
            n_seg, seg_len) for n in names])
        return cls._of(names, emos, vals, "audio", {"audios": auds})

    @classmethod
    def build_text(cls, names, emos, vals, trans_csv, tokenizer,
                   max_length: int = 256) -> "E2EDataset":
        """``tokenizer``: ``encode(text, add_special_tokens=False)`` and
        ``pad_token_id``, as an HF tokenizer has them."""
        with open(trans_csv, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        col = next(c for c in ("sentence", "chinese", "english")
                   if rows and c in rows[0])
        name2trans = {r["name"]: (r.get(col) or "") for r in rows}
        ids_list = []
        for n in names:
            text = name2trans.get(n, "") or "no subtitle."  # NaN guard (:64)
            ids_list.append(tokenizer.encode(text, add_special_tokens=False)[:max_length])
        S = max(len(i) for i in ids_list)
        pad = getattr(tokenizer, "pad_token_id", 0) or 0
        input_ids = np.full((len(names), S), pad, np.int32)
        mask = np.zeros((len(names), S), np.int32)
        for b, ids in enumerate(ids_list):
            input_ids[b, : len(ids)] = ids
            mask[b, : len(ids)] = 1
        return cls._of(names, emos, vals, "text",
                       {"input_ids": input_ids, "attention_mask": mask})

    @classmethod
    def build_video(cls, names, emos, vals, face_root, n_frms: int = 16,
                    image_size: int = 224, mean=CLIP_MEAN, std=CLIP_STD,
                    compact: bool = True) -> "E2EDataset":
        """``compact=True`` (default) keeps frames as source-resolution uint8
        BGR under ``videos_u8``; the model preprocesses them on the device
        (``models/e2e_model.preprocess_video_u8``). ``compact=False`` builds
        the precomputed float frames (RGB, bicubic resize to
        ``image_size`` by ``ops/image.py``'s weights, normalised)."""
        clips = []
        for n in names:
            arr = np.load(os.path.join(face_root, f"{n}.npy"))  # (T,H,W,3) BGR
            idx = np.linspace(0, len(arr) - 1, n_frms).astype(int)
            clips.append(arr[idx])
        if compact:
            if (tuple(mean), tuple(std)) != (CLIP_MEAN, CLIP_STD):
                warnings.warn(
                    "build_video(compact=True) stores raw uint8 frames; the "
                    "MODEL config (E2EConfig pixel_mean/pixel_std) governs "
                    "normalization — the mean/std passed here are ignored. "
                    "Pass compact=False for precomputed float frames.", stacklevel=2)
            return cls._of(names, emos, vals, "video",
                           {"videos_u8": np.stack(clips).astype(np.uint8)})
        import torch

        from ..ops.image import resize_separable

        vids = []
        for arr in clips:
            frames = arr[..., ::-1].astype(np.float32) / 255.0          # RGB
            frames = resize_separable(torch.from_numpy(np.ascontiguousarray(frames)),
                                      image_size, image_size, "bicubic").numpy()
            vids.append((frames - np.asarray(mean)) / np.asarray(std))
        return cls._of(names, emos, vals, "video",
                       {"videos": np.stack(vids).astype(np.float32)})
