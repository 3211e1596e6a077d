"""Batched visual feature extraction (the CLIP family) — port of
``mertools_tpu/features/vision.py``.

Reference semantics (``extract_vision_huggingface.py``): per clip — load the
OpenFace face npy ``(T, 112, 112, 3)`` BGR uint8, resample frames uniformly,
preprocess per CLIP's processor (resize 224 bicubic, rescale, normalise,
RGB), forward the frames (``get_image_features``); FRA = per-frame (T, D),
UTT = frame mean (``:183-189``).

As in the JAX package, frames of many clips are pooled into one stream and
forwarded in fixed-size batches (pad frames are zeros); the uint8 frames
cross to the card (a quarter of float32's bytes) and the preprocessing runs
there, in fp32 even in the bf16 mode. For UTT the per-clip sums accumulate
on the device (pad frames into a scrap slot), so only (n_clips, D) comes
back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device, upload
from ..encoders.vit_clip import CLIPVisionConfig, CLIPVisionEncoder
from ..ops.quant import int8_dot_general

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resample_frames_uniform(n_frames: int, max_frames: int = 64) -> np.ndarray:
    """Uniform frame index sampling (extract_vision_huggingface.py:44-56):
    keep all when short, else evenly spaced indices."""
    if n_frames <= max_frames:
        return np.arange(n_frames)
    step = n_frames / max_frames
    return np.minimum((np.arange(max_frames) * step).astype(np.int64), n_frames - 1)


def preprocess_faces_device(frames: torch.Tensor, image_size: int) -> torch.Tensor:
    """(N, H, W, 3) BGR uint8 -> (N, S, S, 3) normalised RGB float32 on the
    frames' device: separable-product resize with the affine normalisation
    folded around it, equal to the jax.image.resize pipeline
    (:mod:`..ops.image`)."""
    from ..ops.image import fused_face_preprocess

    return fused_face_preprocess(frames, image_size, CLIP_MEAN, CLIP_STD)


@dataclass
class VisionExtractor:
    """Fixed-batch frame-stream extractor for the CLIP vision tower.

    ``params`` is a state dict in this package's (HF) key names."""

    cfg: CLIPVisionConfig
    params: dict
    batch_size: int = 64
    max_frames: int = 64
    # None/"f32": fp32 parity mode (TF32 off). "bf16": params and
    # activations in bfloat16 (the preprocessing stays fp32). "int8": bf16,
    # with dynamic w8a8 products (ops.quant.int8_dot_general) at the
    # transformer layers' Dense sites, as the JAX package's int8 mode.
    compute_dtype: str | None = None
    # kernel B1 for the attention (not with cfg.tome_r > 0: ValueError); on
    # CPU tensors the same call takes its plain version
    flash: bool = False
    device: object = "cuda"

    def __post_init__(self):
        if self.compute_dtype not in (None, "f32", "bf16", "int8"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        fast = self.compute_dtype in ("bf16", "int8")
        self._device = resolve_device(self.device, fp32=not fast)
        self._dtype = torch.bfloat16 if fast else torch.float32
        if self.flash:
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=True)
        with torch.device("meta"):
            enc = CLIPVisionEncoder(self.cfg, dot_general=(
                int8_dot_general if self.compute_dtype == "int8" else None))
        enc.load_state_dict(self.params, strict=True, assign=True)
        self._enc = enc.to(self._device, self._dtype).eval()

    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        pix = preprocess_faces_device(frames, self.cfg.image_size)
        return self._enc(pix.to(self._dtype))["image_embeds"].float()

    @torch.inference_mode()
    def extract(self, faces: dict[str, np.ndarray], level: str = "FRA",
                ) -> dict[str, np.ndarray]:
        """faces: name -> (T, H, W, 3) BGR uint8 face crops. Returns name ->
        (T', D) FRA or (D,) UTT features, T' = min(T, max_frames)."""
        jobs: list[tuple[str, int, np.ndarray]] = []
        counts: dict[str, int] = {}
        for name, arr in faces.items():
            idx = resample_frames_uniform(len(arr), self.max_frames)
            if len(idx) == 0:
                raise ValueError(f"clip {name!r} has no frames to pool "
                                 "(empty face array)")
            counts[name] = len(idx)
            for fi, ai in enumerate(idx):
                jobs.append((name, fi, arr[ai]))

        utt = level.upper().startswith("UTT")
        slot = {n: i for i, n in enumerate(faces)}
        scrap = len(faces)          # pad rows accumulate into a junk slot
        acc = (torch.zeros((scrap + 1, self.cfg.projection_dim),
                           dtype=torch.float32, device=self._device)
               if utt else None)
        bs = self.batch_size
        h, w = jobs[0][2].shape[:2]
        pending = []   # dispatch every batch, then collect
        for i in range(0, len(jobs), bs):
            group = jobs[i: i + bs]
            batch = np.zeros((bs, h, w, 3), np.uint8)   # fixed shape
            for r, (_, _, frame) in enumerate(group):
                batch[r] = frame
            emb = self._embed(upload(batch, self._device))
            if utt:
                ids = np.full((bs,), scrap, np.int64)
                ids[: len(group)] = [slot[n] for n, _, _ in group]
                acc.index_add_(0, upload(ids, self._device), emb)
            else:
                pending.append((group, emb))
        if utt:
            arr = acc.cpu().numpy()
            return {n: arr[slot[n]] / counts[n] for n in faces}

        results: dict[str, dict[int, np.ndarray]] = {n: {} for n in faces}
        for group, res in pending:
            embeds = res.cpu().numpy()
            for r, (name, fi, _) in enumerate(group):
                results[name][fi] = embeds[r]
        return {name: np.stack([results[name][fi] for fi in range(counts[name])])
                for name in faces}
