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

:class:`WhisperAudioExtractor` is the Whisper branch
(``mertools_tpu/features/audio.py:329-393``): 30 s clips, log-mel, encoder
and a 2-token decoder stub.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device, to_pcm16, upload
from ..encoders.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from ..ops.quant import int8_dot_general

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
    # mode casts them. "int8": bf16, with dynamic w8a8 products
    # (ops.quant.int8_dot_general) at the transformer layers' Dense sites, as
    # the JAX package's int8 mode runs them (~1-2% rel err class).
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
        if self.compute_dtype not in (None, "f32", "bf16", "int8"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.transfer_dtype not in ("f32", "int16"):
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}")
        fast = self.compute_dtype in ("bf16", "int8")
        self._device = resolve_device(self.device, fp32=not fast)
        self._dtype = torch.bfloat16 if fast else torch.float32
        if self.flash is True and self.cfg.attn_type == "standard":
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=True)
        with torch.device("meta"):
            enc = Wav2Vec2Encoder(self.cfg, dot_general=(
                int8_dot_general if self.compute_dtype == "int8" else None))
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
                raw = to_pcm16(wav)
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
                dev = self._device
                wav = self._dequant(upload(batch, dev), upload(affine, dev),
                                    upload(raw_lens, dev))
            else:
                for r, (_, sl, _, _, seg) in enumerate(group):
                    batch[r, : len(seg)] = seg
                    lens[r] = sl
                wav = upload(batch, self._device)
            dev_lens = upload(lens, self._device)
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


class WhisperAudioExtractor:
    """Whisper feature path (``extract_audio_huggingface.py:83-91``): 30 s
    padded log-mel -> full encoder + a 2-token decoder stub
    (decoder_start_token repeated) -> decoder last_hidden (2, D) per clip;
    UTT = mean over the 2 positions. Fixed batches of ``batch_size`` clips
    (zero filler rows); the log-mel runs kernel B2 on a CUDA device.

    ``params`` is a state dict in HF ``WhisperModel`` key names. fp32 only,
    with TF32 off for matmuls and cuDNN (the JAX class has no bf16 mode).
    ``transfer_dtype="int16"`` ships PCM16 over the host link (half the
    bytes); Whisper has no input normalisation, so int16 / 32768 on the
    device is exact for PCM16 sources."""

    def __init__(self, cfg, params: dict, batch_size: int = 8,
                 transfer_dtype: str = "f32", device="cuda"):
        from ..encoders.whisper import build_model
        from ..ops.mel import CHUNK_SAMPLES
        from ..ops.mel_fused import select_log_mel

        if transfer_dtype not in ("f32", "int16"):
            raise ValueError(f"transfer_dtype {transfer_dtype!r}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.chunk = CHUNK_SAMPLES
        self.transfer_dtype = transfer_dtype
        self._device = resolve_device(device, fp32=True)
        self.model = build_model(cfg, params, self._device)
        # the device gate; replace it to run another frontend on the device
        self.log_mel = select_log_mel(self._device)

    def _forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dtype == torch.int16:
            wav = wav.float() / 32768.0
        ids = torch.full((wav.shape[0], 2), self.cfg.decoder_start_token_id,
                         dtype=torch.long, device=wav.device)
        return self.model(self.log_mel(wav), ids)          # (B, 2, D)

    @torch.inference_mode()
    def extract(self, wavs: dict[str, np.ndarray], level: str = "FRA"
                ) -> dict[str, np.ndarray]:
        """wavs: clip name -> 16 kHz waveform. Returns name -> (2, D) FRA or
        (D,) UTT features."""
        names = list(wavs)
        B = self.batch_size
        i16 = self.transfer_dtype == "int16"
        utt = level.upper().startswith("UTT")
        pending = []  # dispatch every batch, then collect
        for i in range(0, len(names), B):
            group = names[i: i + B]
            batch = np.zeros((B, self.chunk), np.int16 if i16 else np.float32)
            for r, n in enumerate(group):
                w = to_pcm16(wavs[n]) if i16 else wavs[n]
                batch[r, : min(len(w), self.chunk)] = w[: self.chunk]
            hs = self._forward(upload(batch, self._device))
            pending.append((group, hs.mean(1) if utt else hs))
        out = {}
        for group, res in pending:
            res = res.cpu().numpy()
            for r, n in enumerate(group):
                out[n] = res[r]
        return out
