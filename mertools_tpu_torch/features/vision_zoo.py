"""Batched extraction for the ViT vision zoo — port of
``mertools_tpu/features/vision_zoo.py`` (its ViT backends; the CNN ones,
``resnet_embed_extractor``, ``manet_extractor`` and ``ferplus_spec``, are
ROADMAP A9b2).

Reference semantics (``MERBench/feature_extraction/visual/
extract_vision_huggingface.py:104-169``; MER2025 Track 2-3's
``my_affectgpt/models/encoder.py``):

- data2vec-vision: a frame's last hidden state summed over every token;
- DINOv2: 64 frames resampled uniformly, then the same token sum;
- VideoMAE: 16 frames resampled (a short clip repeat-padded), the tubelet
  tokens meaned a segment -> (T / tubelet, D) a clip;
- EVA-CLIP-G: ``ln_vision`` of the tokens, meaned; SigLIP: the last hidden
  state (before its post-LayerNorm) meaned;
- UTT: the mean over frames (segments for VideoMAE).

Frames of many clips stream through one preprocess -> encode -> pool step
in fixed-size batches (:func:`stream_frames`, shared with the CLIP
extractor): uint8 crops cross to the card, the preprocessing
(:mod:`..ops.image`) runs there in fp32, zero pad rows accumulate into a
scrap slot, and UTT sums pool on the device by ``index_add_``. Under
``compute_dtype="bf16"`` parameters and activations are bf16; otherwise
fp32 with TF32 off (``"int8"`` too: the JAX ViT paths quantize nothing).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device, upload
from ..encoders.siglip import SiglipVisionConfig, SiglipVisionEncoder
from ..encoders.vit import ViTConfig, ViTEncoder
from ..ops.image import fused_face_preprocess
from .vision import resample_frames_uniform, stream_frames

IMAGENET_DEFAULT = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
IMAGENET_STANDARD = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
OPENAI_CLIP = ((0.48145466, 0.4578275, 0.40821073),
               (0.26862954, 0.26130258, 0.27577711))


@dataclass(frozen=True)
class PreprocessSpec:
    """uint8 BGR -> model input, on the device: a direct resize to
    ``image_size`` (the HF processors), or Resize(``resize_short``) +
    CenterCrop(``image_size``) where it is > 0."""
    image_size: int = 224
    mean: tuple = (0.0, 0.0, 0.0)
    std: tuple = (1.0, 1.0, 1.0)
    scale: float = 1.0 / 255.0       # uint8 -> [0, 1]
    bgr_to_rgb: bool = True
    resize_short: int = 0
    method: str = "bicubic"


def preprocess_device(frames: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, S, S, 3) float32 on the frames' device."""
    return fused_face_preprocess(frames, spec.image_size, spec.mean, spec.std,
                                 scale=spec.scale, bgr_to_rgb=spec.bgr_to_rgb,
                                 resize_short=spec.resize_short, method=spec.method)


def _placed(module: torch.nn.Module, params: dict, compute_dtype, device):
    """(``module`` built on the meta device with ``params`` assigned, moved
    to the device and dtype of ``compute_dtype``; the device; the dtype)."""
    if compute_dtype not in (None, "f32", "bf16", "int8"):
        raise ValueError(f"compute_dtype {compute_dtype!r}")
    bf16 = compute_dtype == "bf16"
    dev = resolve_device(device, fp32=not bf16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    module.load_state_dict(params, strict=True, assign=True)
    return module.to(dev, dtype).eval(), dev, dtype


class FrameStreamExtractor:
    """A per-frame backend: ``pool(model, pixels) -> (rows, D)`` on the
    encoder ``module`` (built on the meta device; ``params`` its state
    dict), frames preprocessed by ``spec``, streamed by
    :func:`stream_frames`."""

    def __init__(self, module, pool, params: dict, spec: PreprocessSpec,
                 batch_size: int = 64, max_frames: int | None = None,
                 compute_dtype: str | None = None, device="cuda"):
        self.model, self._device, self._dtype = _placed(module, params, compute_dtype, device)
        self.pool, self.spec = pool, spec
        self.batch_size, self.max_frames = batch_size, max_frames

    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        pix = preprocess_device(frames, self.spec).to(self._dtype)
        return self.pool(self.model, pix).float()

    @torch.inference_mode()
    def extract(self, faces: dict, level: str = "FRA") -> dict:
        return stream_frames(faces, level, self._embed, self.batch_size,
                             self.max_frames, self._device)


def _size_weighted(tokens: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnd,bn->bd", tokens, sizes)


def vit_token_sum_extractor(cfg: ViTConfig, params: dict, spec=None, batch_size=64,
                            max_frames=None, compute_dtype=None, device="cuda"):
    """data2vec-vision / DINOv2: a frame's last hidden state summed over its
    tokens (extract_vision_huggingface.py:130-145); size-weighted under ToMe,
    so it approximates the sum over the original tokens. DINOv2 takes
    ImageNet's stats and resamples 64 frames; the others 0.5 / 0.5 and
    every frame."""
    if spec is None:
        stats = IMAGENET_DEFAULT if cfg.arch == "dinov2" else IMAGENET_STANDARD
        spec = PreprocessSpec(image_size=cfg.image_size, mean=stats[0], std=stats[1])
    if max_frames is None and cfg.arch == "dinov2":
        max_frames = 64   # the reference resamples 64 frames (:136)

    def pool(model, pix):
        tokens, sizes = model(pix)
        return tokens.sum(dim=1) if sizes is None else _size_weighted(tokens, sizes)

    with torch.device("meta"):
        module = ViTEncoder(cfg)
    return FrameStreamExtractor(module, pool, params, spec, batch_size, max_frames,
                                compute_dtype, device)


def eva_clip_g_token_mean_extractor(cfg: ViTConfig, params: dict, ln_vision=None,
                                    batch_size=16, max_frames=64, compute_dtype=None,
                                    device="cuda"):
    """EVA_CLIP_G_NO_QFORMER: ``ln_vision(visual_encoder(image))`` meaned over
    tokens (MER2025_Track23 my_affectgpt/models/encoder.py:160-174; size-
    weighted under ToMe). ``ln_vision`` is a LayerNorm at eps 1e-5 over the
    tower's width: identity affine unless a BLIP-2 checkpoint gives
    ``{"scale", "bias"}``. OpenAI-CLIP's normalisation stats."""
    spec = PreprocessSpec(image_size=cfg.image_size, mean=OPENAI_CLIP[0], std=OPENAI_CLIP[1])
    affine = {}

    def pool(model, pix):
        tokens, sizes = model(pix)
        normed = F.layer_norm(tokens, tokens.shape[-1:], affine.get("scale"),
                              affine.get("bias"), eps=1e-5)
        if sizes is None:
            return normed.mean(dim=1)
        return _size_weighted(normed, sizes) / sizes.sum(-1, keepdim=True)

    with torch.device("meta"):
        module = ViTEncoder(cfg)
    ex = FrameStreamExtractor(module, pool, params, spec, batch_size, max_frames,
                              compute_dtype, device)
    if ln_vision is not None:
        affine.update({k: torch.as_tensor(np.asarray(ln_vision[k], np.float32)).to(
            ex._device, ex._dtype) for k in ("scale", "bias")})
    return ex


def siglip_token_mean_extractor(cfg: SiglipVisionConfig, params: dict, batch_size=32,
                                max_frames=64, compute_dtype=None, device="cuda"):
    """SigLIP_SO: a frame's last hidden state meaned over tokens
    (MER2025_Track23 my_affectgpt/models/encoder.py:269-281; size-weighted
    under ToMe); resized to (S, S), 0.5 / 0.5 stats. The attention-pool head
    is not run."""
    spec = PreprocessSpec(image_size=cfg.image_size, mean=IMAGENET_STANDARD[0],
                          std=IMAGENET_STANDARD[1])

    def pool(model, pix):
        out = model(pix, head=False)
        t = out["last_hidden"]
        if "sizes" not in out:
            return t.mean(dim=1)
        return _size_weighted(t, out["sizes"]) / out["sizes"].sum(-1, keepdim=True)

    with torch.device("meta"):
        module = SiglipVisionEncoder(cfg)
    return FrameStreamExtractor(module, pool, params, spec, batch_size, max_frames,
                                compute_dtype, device)


class VideoMAEExtractor:
    """Clip level: 16 frames resampled uniformly (a short clip repeat-padded
    by ``np.resize``, as the reference's continuous index clamp), tubelet
    tokens meaned a segment -> FRA (T / tubelet, D), UTT the segments' mean
    (extract_vision_huggingface.py:147-159)."""

    def __init__(self, cfg: ViTConfig, params: dict, spec=None, batch_size: int = 8,
                 compute_dtype: str | None = None, device="cuda"):
        if cfg.num_frames <= 0:
            raise ValueError("VideoMAEExtractor needs a tubelet config (num_frames > 0)")
        self.cfg, self.batch_size = cfg, batch_size
        self.spec = spec or PreprocessSpec(image_size=cfg.image_size,
                                           mean=IMAGENET_STANDARD[0], std=IMAGENET_STANDARD[1])
        with torch.device("meta"):
            module = ViTEncoder(cfg)
        self.model, self._device, self._dtype = _placed(module, params, compute_dtype, device)

    def _step(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 -> (B, segments, D) float32."""
        c = self.cfg
        B, T = clips.shape[:2]
        pix = preprocess_device(clips.flatten(0, 1), self.spec).to(self._dtype)
        tokens, _ = self.model(pix.view(B, T, c.image_size, c.image_size, 3))
        return tokens.view(B, c.num_frames // c.tubelet_size, c.grid * c.grid, -1
                           ).mean(dim=2).float()

    @torch.inference_mode()
    def extract(self, faces: dict, level: str = "FRA") -> dict:
        names = list(faces)
        T = self.cfg.num_frames
        pending = []   # every batch dispatched, then collected
        for i in range(0, len(names), self.batch_size):
            group = names[i: i + self.batch_size]
            h, w = faces[group[0]].shape[1:3]
            batch = np.zeros((self.batch_size, T, h, w, 3), np.uint8)
            for r, name in enumerate(group):
                arr = faces[name]
                idx = resample_frames_uniform(len(arr), T)
                batch[r] = arr[np.resize(idx, T) if len(idx) < T else idx]
            pending.append((group, self._step(upload(batch, self._device))))
        utt = level.upper().startswith("UTT")
        out = {}
        for group, res in pending:
            segs = res.cpu().numpy()
            for r, name in enumerate(group):
                out[name] = segs[r].mean(0) if utt else segs[r]
        return out
