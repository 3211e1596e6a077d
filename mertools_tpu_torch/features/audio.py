"""Batched audio feature extraction — port of ``mertools_tpu/features/audio.py``.

Reference execution model (``extract_audio_huggingface.py:72-110``): one clip
per forward —
  1. read 16 kHz wav, zero-mean/unit-var normalize the WHOLE wav
     (Wav2Vec2FeatureExtractor semantics),
  2. if len > 10 s: zero-pad to a multiple of 10 s and split into 10 s
     segments (split_into_batch, :40-50) — the padded tail's frames are KEPT
     in the output,
  3. forward with output_hidden_states, sum the last 4 layers,
  4. FRA = concat of all segment frames (T, D); UTT = temporal mean.

As in the JAX package, segments from MANY clips are pooled, sorted by
length, bucketed to a few fixed shapes and forwarded in large batches; the
encoder's masked GroupNorm and key masking make a batched forward match the
per-clip forwards. Host batches go to the card through pinned memory with
non-blocking copies, every batch is dispatched before any result is read
(the card works while the host builds the next batch), and UTT pooling runs
on the device so only (B, D) sums cross back.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

MAX_SEGMENT = 16000 * 10  # 10 s at 16 kHz (reference maxlen)


def normalize_wav(wav: np.ndarray) -> np.ndarray:
    """Wav2Vec2FeatureExtractor zero-mean unit-variance normalization."""
    wav = np.asarray(wav, np.float32)
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)


def segmentize(wav: np.ndarray, max_segment: int = MAX_SEGMENT
               ) -> list[tuple[np.ndarray, int]]:
    """Split one normalized wav into (segment, valid_len) pairs with the
    reference's padding rule."""
    if len(wav) <= max_segment:
        return [(wav, len(wav))]
    n = math.ceil(len(wav) / max_segment)
    padded = np.zeros(n * max_segment, np.float32)
    padded[: len(wav)] = wav
    # multi-segment clips keep their padded tail (reference behavior)
    return [(padded[i * max_segment:(i + 1) * max_segment], max_segment)
            for i in range(n)]


def segmentize_i16(wav: np.ndarray, max_segment: int = MAX_SEGMENT
                   ) -> list[tuple[np.ndarray, int, int]]:
    """Int16 wire-format segmenting: (segment_i16, valid_len, raw_len) where
    raw_len counts REAL samples (the zero tail past raw_len must become 0.0
    in normalized space on device, exactly like the reference's
    normalize-then-pad order)."""
    if len(wav) <= max_segment:
        return [(wav, len(wav), len(wav))]
    n = math.ceil(len(wav) / max_segment)
    padded = np.zeros(n * max_segment, np.int16)
    padded[: len(wav)] = wav
    return [(padded[i * max_segment:(i + 1) * max_segment], max_segment,
             min(max(len(wav) - i * max_segment, 0), max_segment))
            for i in range(n)]


DEFAULT_BUCKETS = (16000, 32000, 48000, 64000, 96000, 128000, MAX_SEGMENT)


@dataclass
class AudioExtractor:
    """Bucketed batched extractor for wav2vec2-family encoders.

    ``params`` is a state dict in this package's (HF) key names."""

    cfg: Wav2Vec2Config
    params: dict
    layer_ids: tuple = (-4, -3, -2, -1)
    do_normalize: bool = True
    max_segment: int = MAX_SEGMENT
    buckets: tuple = DEFAULT_BUCKETS
    sample_budget: int = 16 * MAX_SEGMENT  # samples per device batch
    # None/"f32": fp32 parity mode (TF32 off for matmuls AND cuDNN convs).
    # "bf16": params and activations in bfloat16, as the JAX package's bf16
    # mode casts them.
    compute_dtype: str | None = None
    # The hand-written CUDA attention kernel (standard attention only); on
    # CPU tensors the same call takes its plain version.
    flash: object = False
    device: object = "cuda"
    # "int16": ship segments to the device in the wav file's native PCM16
    # width (half the bytes of f32) and apply the whole-clip normalization
    # as a per-row affine ON DEVICE. Exact for PCM16 sources; f32 inputs are
    # round-tripped through int16 (~1e-4, the source-format noise floor).
    transfer_dtype: str = "f32"

    def __post_init__(self):
        if self.compute_dtype == "int8":
            raise NotImplementedError(
                "compute_dtype='int8' (w8a8 encoder matmuls, ops/quant.py) is "
                "not ported yet: ROADMAP A17")
        if self.compute_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.transfer_dtype not in ("f32", "int16"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}")
        self._device = torch.device(self.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={self.device!r} but this host has no "
                               f"CUDA device")
        fast = self.compute_dtype == "bf16"
        if not fast and self._device.type == "cuda":
            # parity mode: full-fp32 GEMMs and convolutions (cuDNN would
            # otherwise run the conv frontend in TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._dtype = torch.bfloat16 if fast else torch.float32
        if self.flash is True and self.cfg.attn_type == "standard":
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=True)
        with torch.device("meta"):
            enc = Wav2Vec2Encoder(self.cfg)
        enc.load_state_dict(self.params, strict=True, assign=True)
        self._enc = enc.to(self._device, self._dtype).eval()

    # ----------------------------------------------------------- device side
    def _features(self, wav, lengths):
        hs = self._enc(wav.to(self._dtype), lengths)
        return sum(hs[i] for i in self.layer_ids).float()

    def _pooled(self, feat, lengths):
        """Per-segment masked frame SUM on device, so only (B, D) + counts
        cross back to the host instead of (B, T, D)."""
        frames = self.cfg.feat_lengths(lengths)
        t_idx = torch.arange(feat.shape[1], device=feat.device)
        m = (t_idx[None, :] < frames[:, None]).float()
        return torch.einsum("btd,bt->bd", feat, m), frames

    @staticmethod
    def _dequant(wav_i16, affine, raw_lens):
        # per-row affine = whole-clip normalization folded with the
        # int16->f32 conversion; zeros past raw_len reproduce the
        # reference's normalize-THEN-pad order exactly
        x = wav_i16.float() * affine[:, :1] + affine[:, 1:]
        t_idx = torch.arange(x.shape[1], device=x.device)
        return torch.where(t_idx[None, :] < raw_lens[:, None], x, 0.0)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _bucket_len(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_segment

    # ------------------------------------------------------------- host side
    @torch.inference_mode()
    def extract(self, wavs: dict[str, np.ndarray], level: str = "FRA",
                ) -> dict[str, np.ndarray]:
        """wavs: clip name -> 16 kHz waveform. Returns name -> (T, D) FRA or
        (D,) UTT features, reference-parity."""
        i16 = self.transfer_dtype == "int16"
        jobs = []  # (bucket, seg_len, clip, seg_idx, segment[, raw_len, a, b])
        seg_counts: dict[str, int] = {}
        for name, wav in wavs.items():
            if i16:
                raw = (wav if wav.dtype == np.int16 else
                       np.clip(np.round(np.asarray(wav, np.float32) * 32768.0),
                               -32768, 32767).astype(np.int16))
                f = raw.astype(np.float32) / 32768.0
                if self.do_normalize:
                    inv = 1.0 / np.sqrt(f.var() + 1e-7)
                    a, b = inv / 32768.0, -float(f.mean()) * inv
                else:
                    a, b = 1.0 / 32768.0, 0.0
                segs = segmentize_i16(raw, self.max_segment)
                seg_counts[name] = len(segs)
                for si, (seg, sl, rl) in enumerate(segs):
                    jobs.append((self._bucket_len(len(seg)), sl, name, si,
                                 seg, rl, a, b))
            else:
                w = (normalize_wav(wav) if self.do_normalize
                     else np.asarray(wav, np.float32))
                segs = segmentize(w, self.max_segment)
                seg_counts[name] = len(segs)
                for si, (seg, sl) in enumerate(segs):
                    jobs.append((self._bucket_len(len(seg)), sl, name, si, seg))

        jobs.sort(key=lambda j: (j[0], -j[1]))
        utt = level.upper().startswith("UTT")
        results: dict[str, dict[int, np.ndarray]] = {n: {} for n in wavs}
        counts: dict[str, dict[int, int]] = {n: {} for n in wavs}

        # Phase 1 — dispatch every batch (copies and kernels queue on the
        # stream; the host goes on building batches); Phase 2 — collect.
        pending = []  # (group, device result, lens)
        i = 0
        while i < len(jobs):
            bucket = jobs[i][0]
            bs = max(1, self.sample_budget // bucket)
            group = [j for j in jobs[i: i + bs] if j[0] == bucket]
            i += len(group)

            # FIXED batch shape (bs, bucket): zero-length filler rows keep
            # one shape per bucket; they are dropped below
            batch = np.zeros((bs, bucket), np.int16 if i16 else np.float32)
            lens = np.zeros(bs, np.int32)
            if i16:
                affine = np.zeros((bs, 2), np.float32)
                raw_lens = np.zeros(bs, np.int32)
                for r, (_, sl, _, _, seg, rl, a, b) in enumerate(group):
                    batch[r, : len(seg)] = seg
                    lens[r] = sl
                    raw_lens[r] = rl
                    affine[r] = (a, b)
                wav = self._dequant(self._upload(batch), self._upload(affine),
                                    self._upload(raw_lens))
            else:
                for r, (_, sl, _, _, seg) in enumerate(group):
                    batch[r, : len(seg)] = seg
                    lens[r] = sl
                wav = self._upload(batch)
            dev_lens = self._upload(lens)
            feat = self._features(wav, dev_lens)
            pending.append((group, self._pooled(feat, dev_lens) if utt
                            else feat, lens))

        for group, res, lens in pending:
            if utt:
                sums, frames = res[0].cpu().numpy(), res[1].cpu().numpy()
                for r, j in enumerate(group):
                    name, si = j[2], j[3]
                    results[name][si] = sums[r]
                    counts[name][si] = int(frames[r])
            else:
                feats = res.cpu().numpy()
                frames = self.cfg.feat_lengths(lens)
                for r, j in enumerate(group):
                    name, si = j[2], j[3]
                    results[name][si] = feats[r, : frames[r]]

        out = {}
        for name in wavs:
            parts = [results[name][si] for si in range(seg_counts[name])]
            if utt:
                total = np.sum(parts, axis=0)
                n_frames = sum(counts[name].values())
                out[name] = (total / max(n_frames, 1)).astype(np.float32)
            else:
                out[name] = np.concatenate(parts, axis=0)
        return out


@torch.inference_mode()
def reference_single_clip(cfg: Wav2Vec2Config, params: dict, wav: np.ndarray,
                          layer_ids=(-4, -3, -2, -1), do_normalize=True,
                          max_segment: int = MAX_SEGMENT) -> np.ndarray:
    """Oracle: the reference's exact per-clip path, fp32 on the CPU."""
    enc = Wav2Vec2Encoder(cfg)
    enc.load_state_dict(params, strict=True)
    enc.eval()
    w = normalize_wav(wav) if do_normalize else np.asarray(wav, np.float32)
    if len(w) <= max_segment:
        batch = w[None]
    else:
        n = math.ceil(len(w) / max_segment)
        padded = np.zeros(n * max_segment, np.float32)
        padded[: len(w)] = w
        batch = padded.reshape(n, max_segment)
    hs = enc(torch.from_numpy(np.ascontiguousarray(batch)))
    feat = sum(hs[i] for i in layer_ids)  # (B, T, D)
    return feat.reshape(-1, feat.shape[-1]).numpy()
