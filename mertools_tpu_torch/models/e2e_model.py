"""End-to-end fine-tuning model: a raw pretrained encoder + an MLP head
(port of ``mertools_tpu/models/e2e_model.py``; ``VideoMAEPretrain`` waits
for the port's VideoMAE, ROADMAP A7b).

Reference (``MER2025/MER2025_Track23/toolkit/models/e2e_model.py:7-76``):
fine-tune a raw encoder end-to-end with the fusion contract
``(features, emos_out, vals_out, interloss)``. Pooling rules:

- text : sum of the last 4 hidden states, attention-masked mean over tokens
  (the count clamped at 1);
- audio: (B, n_seg, samples) -> (B * n_seg) clips -> last-4 sum, mean over
  time with no length mask (segments are fixed length), mean over segments;
- video: CLIP image embeddings, mean over frames; a ``videos_u8`` batch
  (source-resolution uint8 BGR) is resized and normalised on the device
  first (:func:`preprocess_video_u8`).

The backbone runs without dropout (the JAX model calls it without
``train``, and the port's encoders have none): only the head's
``MLPEncoder`` drops out in training.

The JAX docstring gives the backbone 1/10 of the head's learning rate
through :func:`e2e_param_labels`, but its trainer never uses the labels:
``run_cv`` steps every parameter with one optimizer. The port's trainer
does the same (one ``ClippedAdam``).

Pretrained weights come from ``{pretrain_dir}/{e2e_name}`` through
``core/checkpoint.py`` (``config.json`` and the weights, no
``transformers``); the ``tiny-audio``, ``tiny-text`` and ``tiny-video``
names build the JAX package's tiny configs without weights.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
from torch import nn

from ..core.registry import registry
from ..encoders import bert, vit_clip, wav2vec2
from ..features.vision import CLIP_MEAN, CLIP_STD
from .base import state_dict_from_flax as heads_from_flax
from .modules import MLPEncoder, SimpleClassifierHeads


@dataclass(frozen=True)
class E2EConfig:
    modality: str            # audio | text | video_clip
    feat_dim: int            # backbone output dim
    hidden_dim: int = 256
    dropout: float = 0.3
    output_dim1: int = 6
    output_dim2: int = 1
    # on-device preprocessing for compact uint8 video batches (videos_u8):
    image_size: int = 224
    pixel_mean: tuple = CLIP_MEAN
    pixel_std: tuple = CLIP_STD


def preprocess_video_u8(v: torch.Tensor, image_size: int, mean, std) -> torch.Tensor:
    """(B, T, h, w, 3) uint8 BGR -> (B, T, S, S, 3) normalised float32 on
    v's device (:func:`..ops.image.fused_face_preprocess`: the separable
    resize with the JAX package's weights)."""
    from ..ops.image import fused_face_preprocess

    B, T = v.shape[0], v.shape[1]
    x = fused_face_preprocess(v.reshape((B * T,) + tuple(v.shape[2:])),
                              image_size, mean, std)
    return x.reshape(B, T, image_size, image_size, 3)


class _CLIPEmbedWrapper(vit_clip.CLIPVisionEncoder):
    """The CLIP vision tower giving its ``image_embeds`` only; its state
    dict is the tower's (HF ``CLIPVisionModelWithProjection`` keys)."""

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return super().forward(pixels)["image_embeds"]


# the encoder module of each modality, for its converters
_ENCODERS = {"audio": wav2vec2, "text": bert, "video_clip": vit_clip}


class E2EModel(nn.Module):
    """``forward(batch, generator=None)`` -> (features, emos_out, vals_out,
    interloss 0). ``batch`` holds ``audios`` (B, n_seg, samples), or
    ``input_ids`` + ``attention_mask`` (B, S), or ``videos`` (B, T, S, S, 3)
    / ``videos_u8`` (B, T, h, w, 3)."""

    def __init__(self, cfg: E2EConfig, backbone: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.encoder = MLPEncoder(cfg.feat_dim, cfg.hidden_dim, cfg.dropout)
        self.heads = SimpleClassifierHeads(cfg.hidden_dim, cfg.output_dim1,
                                           cfg.output_dim2)

    def _video_batch(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        if "videos_u8" in batch:
            return preprocess_video_u8(batch["videos_u8"], c.image_size,
                                       c.pixel_mean, c.pixel_std)
        return batch["videos"]

    def _pool(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        if c.modality == "text":
            hs = self.backbone(batch["input_ids"], batch["attention_mask"])
            x = sum(hs[-4:])                                  # (B, S, D)
            m = batch["attention_mask"][..., None].to(x.dtype)
            return (x * m).sum(1) / m.sum(1).clamp_min(1.0)
        if c.modality == "audio":
            a = batch["audios"]                               # (B, seg, samples)
            B, seg, pts = a.shape
            hs = self.backbone(a.reshape(B * seg, pts), None)
            x = sum(hs[-4:]).mean(dim=1)                      # (B * seg, D)
            return x.reshape(B, seg, -1).mean(dim=1)
        if c.modality == "video_clip":
            v = self._video_batch(batch)                      # (B, T, H, W, 3)
            B, T = v.shape[0], v.shape[1]
            emb = self.backbone(v.reshape((B * T,) + tuple(v.shape[2:])))
            return emb.reshape(B, T, -1).mean(dim=1)
        raise ValueError(c.modality)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        h = self.encoder(self._pool(batch), generator)
        emos, vals = self.heads(h)
        return h, emos, vals, h.new_zeros(())

    def backbone_state_dict_from_flax(self, params: dict) -> dict:
        """The JAX backbone's param tree as this backbone's state dict."""
        tree = params["inner"] if self.cfg.modality == "video_clip" else params
        return _ENCODERS[self.cfg.modality].state_dict_from_flax(self.backbone.cfg, tree)

    def state_dict_from_flax(self, params: dict) -> dict:
        """A JAX ``E2EModel``'s whole ``params`` tree as this model's state
        dict: the backbone through its encoder's converter, the head
        (``encoder``, ``heads``) through ``models/base``'s."""
        sd = {f"backbone.{k}": v for k, v in
              self.backbone_state_dict_from_flax(params["backbone"]).items()}
        sd.update(heads_from_flax({k: params[k] for k in ("encoder", "heads")}))
        return sd

    def init_backbone(self, generator: torch.Generator) -> dict:
        """A freshly drawn backbone state dict (the encoder's own
        ``init_params``)."""
        return _ENCODERS[self.cfg.modality].init_params(self.backbone.cfg, generator)


def e2e_param_labels(names) -> dict:
    """Parameter name -> ``"head"`` (under ``encoder`` or ``heads``) or
    ``"backbone"``, the JAX label tree's split, for ``names`` (a state dict
    or any iterable of dotted names). Like the JAX trainer, ``run_cv`` does
    not use it."""
    return {n: "head" if n.split(".")[0] in ("encoder", "heads") else "backbone"
            for n in names}


def e2e_modality(e2e_name: str) -> str:
    from ..core import globals_mer as G

    if e2e_name in G.WHOLE_AUDIO or "tiny-audio" in e2e_name:
        return "audio"
    if e2e_name in G.WHOLE_TEXT or "tiny-text" in e2e_name:
        return "text"
    if e2e_name in G.WHOLE_IMAGE or "tiny-video" in e2e_name:
        return "video_clip"
    raise ValueError(f"unknown e2e_name {e2e_name!r}")


def _tiny_config(modality: str):
    """The JAX package's tiny backbone configs (``build_e2e_model``)."""
    if modality == "audio":
        return wav2vec2.Wav2Vec2Config(
            hidden_size=16, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3),
            conv_stride=(5, 2), num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=2)
    if modality == "text":
        return bert.BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=4,
                               num_attention_heads=2, intermediate_size=32,
                               max_position_embeddings=64)
    return vit_clip.CLIPVisionConfig(hidden_size=16, num_hidden_layers=2,
                                     num_attention_heads=2, intermediate_size=32,
                                     image_size=32, patch_size=16, projection_dim=12)


def _read_config(modality: str, raw: dict):
    if modality == "audio":
        return wav2vec2.Wav2Vec2Config.from_config_json(raw)
    if modality == "text":
        return bert.BertConfig.from_hf(raw)
    return vit_clip.CLIPVisionConfig.from_hf(raw)


def build_e2e_model(args) -> tuple[E2EModel, dict | None]:
    """``args.e2e_name`` -> (E2EModel with an uninitialised backbone, the
    pretrained backbone state dict or None). A real encoder is read from
    ``{pretrain_dir}/{e2e_name}`` (or ``e2e_name`` as a path); a ``tiny-*``
    name has no weights."""
    from ..core.checkpoint import read_hf_config, read_hf_weights

    name = args.e2e_name
    modality = e2e_modality(name)
    pretrain = args.get("pretrain_dir")
    path = os.path.join(pretrain, name) if pretrain else name
    sd = None
    if "tiny" in name:
        bcfg = _tiny_config(modality)
    else:
        bcfg = _read_config(modality, read_hf_config(path))
        sd = _ENCODERS[modality].load_hf_state_dict(read_hf_weights(path))
    cls = {"audio": wav2vec2.Wav2Vec2Encoder, "text": bert.BertEncoder,
           "video_clip": _CLIPEmbedWrapper}[modality]
    with torch.device("meta"):       # storage comes with the weights
        backbone = cls(bcfg)
    backbone = backbone.to_empty(device="cpu")
    feat_dim = bcfg.projection_dim if modality == "video_clip" else bcfg.hidden_size
    cfg = E2EConfig(
        modality=modality, feat_dim=feat_dim,
        hidden_dim=args.get("hidden_dim") or 128,
        dropout=args.get("dropout") if args.get("dropout") is not None else 0.3,
        output_dim1=args.get("output_dim1") or 6,
        output_dim2=args.get("output_dim2")
        if args.get("output_dim2") is not None else 1,
        image_size=getattr(bcfg, "image_size", 224))
    return E2EModel(cfg, backbone), sd


@registry.register_model("e2e_model")
class _E2EFactory:
    """Registry shim: ``get_model(args, dims)`` -> the configured
    E2EModel (``dims`` unused: raw inputs have no feature widths)."""

    @classmethod
    def from_args(cls, args, dims=None) -> E2EModel:
        model, backbone_sd = build_e2e_model(args)
        # the trainer loads the pretrained backbone after it draws the head
        # (train/loop.py), as the JAX trainer overlays it after init
        args["_e2e_backbone_params"] = backbone_sd
        return model
