"""ImageBind audio encoder (the reference AffectGPT's ``IMAGEBIND`` acoustic
encoder) in PyTorch — port of ``mertools_tpu/encoders/imagebind.py``.

Reference: ``MER2025/MER2025_Track23/my_affectgpt/models/encoder.py:285-311``
feeds mel "images" [b, t, 1, 128, 204] to ``ImageBindModel.get_audio_feature``
(``models/ImageBind/models/imagebind_model.py:477-511``): AudioPreprocessor
(patch conv k16/s10 + LayerNorm + CLS + learned pos-embed) -> SimpleTransformer
trunk (12 pre-LN blocks, torch ``nn.MultiheadAttention`` with
``add_bias_kv=True``) -> head (LayerNorm -> CLS -> Linear 768->1024 without
bias) -> postprocess (L2 normalise x logit_scale 20).

The module carries the ``imagebind_huge.pth`` audio subtree's key names
(``modality_preprocessors.audio.*``, ``modality_trunks.audio.*``,
``modality_heads.audio.*``) and their shapes, so the subtree loads with
``load_state_dict``. ``add_bias_kv`` is written out as the JAX package
writes it: one learned (projected-space) k/v slot appended to the keys and
values of every attention call, dense softmax attention.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import select_keys
from ..core.flax_init import init_flax_style, lecun_normal_


@dataclass(frozen=True)
class ImageBindAudioConfig:
    embed_dim: int = 768
    num_blocks: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    out_embed_dim: int = 1024
    kernel_size: int = 16
    stride: int = 10
    num_mel_bins: int = 128
    target_len: int = 204
    logit_scale: float = 20.0
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> tuple[int, int]:
        g = lambda n: (n - self.kernel_size) // self.stride + 1
        return g(self.num_mel_bins), g(self.target_len)

    @property
    def num_patches(self) -> int:
        gm, gt = self.grid
        return gm * gt


class _BiasKVAttention(nn.Module):
    """torch ``nn.MultiheadAttention(bias=True, add_bias_kv=True)``'s
    parameters, with its arithmetic written out (batch first)."""

    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        H = cfg.embed_dim
        self.in_proj_weight = nn.Parameter(torch.empty(3 * H, H))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * H))
        self.bias_k = nn.Parameter(torch.empty(1, 1, H))
        self.bias_v = nn.Parameter(torch.empty(1, 1, H))
        self.out_proj = nn.Linear(H, H)
        self.nh = cfg.num_heads

    def flax_init_(self, generator: torch.Generator) -> None:
        """The JAX module's q, k and v Dense layers (lecun-normal, zero
        bias) and its normal(0.02) k/v slots."""
        lecun_normal_(self.in_proj_weight, generator)
        self.in_proj_bias.zero_()
        self.bias_k.normal_(0.0, 0.02, generator=generator)
        self.bias_v.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, H = x.shape
        hd = H // self.nh
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        k = torch.cat([k, self.bias_k.expand(B, 1, H)], dim=1)
        v = torch.cat([v, self.bias_v.expand(B, 1, H)], dim=1)
        q = q.view(B, N, self.nh, hd) * hd ** -0.5
        k = k.view(B, N + 1, self.nh, hd)
        v = v.view(B, N + 1, self.nh, hd)
        w = torch.einsum("bqnd,bknd->bnqk", q, k).softmax(-1)
        return self.out_proj(torch.einsum("bnqk,bknd->bqnd", w, v).reshape(B, N, H))


class _Mlp(nn.Module):
    def __init__(self, H: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(H, hidden)
        self.fc2 = nn.Linear(hidden, H)


class _Block(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        H = cfg.embed_dim
        self.attn = _BiasKVAttention(cfg)
        self.norm_1 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.norm_2 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(H, H * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm_1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm_2(x))))


class _Stem(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.kernel_size, cfg.stride, bias=False)
        self.norm_layer = nn.LayerNorm(cfg.embed_dim, eps=1e-6)


class _Preprocessor(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.rgbt_stem = _Stem(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.embed_dim))
        self.pos_embedding_helper = nn.Module()
        self.pos_embedding_helper.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, cfg.embed_dim))

    def flax_init_(self, generator: torch.Generator) -> None:
        """The JAX module's zero class token and normal(0.02) positions."""
        self.cls_token.zero_()
        self.pos_embedding_helper.pos_embed.normal_(0.0, 0.02, generator=generator)


class ImageBindAudioEncoder(nn.Module):
    """mel clips (B, num_mel_bins, target_len) -> dict(embed, feature):
    ``embed`` the L2-normalised x logit_scale projected CLS (B,
    out_embed_dim), the reference's per-clip audio embedding; ``feature``
    the pre-projection layer-normed CLS (B, embed_dim)."""

    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.cfg = cfg
        self.modality_preprocessors = nn.ModuleDict({"audio": _Preprocessor(cfg)})
        trunk = nn.Module()
        trunk.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_blocks))
        self.modality_trunks = nn.ModuleDict({"audio": trunk})
        self.modality_heads = nn.ModuleDict({"audio": nn.Sequential(
            nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps), nn.Identity(),
            nn.Linear(cfg.embed_dim, cfg.out_embed_dim, bias=False))})

    def forward(self, mels: torch.Tensor) -> dict:
        pre = self.modality_preprocessors["audio"]
        x = pre.rgbt_stem.proj(mels[:, None])              # (B, H, gm, gt)
        # mel-row-major patch order, as the JAX package's NHWC reshape
        x = pre.rgbt_stem.norm_layer(x.flatten(2).transpose(1, 2))
        x = torch.cat([pre.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + pre.pos_embedding_helper.pos_embed
        for blk in self.modality_trunks["audio"].blocks:
            x = blk(x)
        head = self.modality_heads["audio"]
        feature = head[0](x)[:, 0]
        embed = head[2](feature)
        embed = embed / torch.linalg.vector_norm(embed, dim=-1, keepdim=True)
        return {"embed": embed * self.cfg.logit_scale, "feature": feature}


def init_params(cfg: ImageBindAudioConfig, generator: torch.Generator) -> dict:
    """Seeded weights with the JAX module's initialisers, as its
    ``--random_init`` draws them: Flax defaults, normal(0.02) for the k/v
    slots and the position table, a zero class token."""
    with torch.device("meta"):
        model = ImageBindAudioEncoder(cfg)
    return init_flax_style(model.to_empty(device=generator.device), generator).state_dict()


def from_imagebind_checkpoint(sd: dict) -> tuple[ImageBindAudioConfig, dict]:
    """An ``imagebind_huge.pth`` state dict -> (the huge audio config, its
    audio subtree); the other modalities and the postprocessor's fixed
    logit scale are left out, as ``convert_torch_state`` leaves them."""
    cfg = ImageBindAudioConfig()
    with torch.device("meta"):
        keys = ImageBindAudioEncoder(cfg).state_dict().keys()
    return cfg, select_keys(sd, keys, "imagebind audio")


def state_dict_from_flax(cfg: ImageBindAudioConfig, params) -> dict:
    """The JAX package's ImageBindAudioEncoder param tree -> this module's
    (checkpoint-layout) state dict; the inverse of ``convert_torch_state``
    (``imagebind.py:154-197``)."""
    pre_p, pre_t, pre_h = ("modality_preprocessors.audio.", "modality_trunks.audio.",
                           "modality_heads.audio.")
    H = cfg.embed_dim

    def t(x, shape=None):
        a = np.array(x, np.float32)
        return torch.from_numpy(a.reshape(shape) if shape else a)

    sd = {
        f"{pre_p}rgbt_stem.proj.weight": t(np.asarray(params["patch_conv"]["kernel"]
                                                      ).transpose(3, 2, 0, 1)),
        f"{pre_p}rgbt_stem.norm_layer.weight": t(params["stem_norm"]["scale"]),
        f"{pre_p}rgbt_stem.norm_layer.bias": t(params["stem_norm"]["bias"]),
        f"{pre_p}cls_token": t(params["cls_token"], (1, 1, H)),
        f"{pre_p}pos_embedding_helper.pos_embed": t(params["pos_embed"][None]),
        f"{pre_h}0.weight": t(params["head_norm"]["scale"]),
        f"{pre_h}0.bias": t(params["head_norm"]["bias"]),
        f"{pre_h}2.weight": t(np.asarray(params["head_proj"]["kernel"]).T),
    }
    for i in range(cfg.num_blocks):
        p, bp = params[f"block_{i}"], f"{pre_t}blocks.{i}"
        a = p["attn"]
        sd[f"{bp}.attn.in_proj_weight"] = t(np.concatenate(
            [np.asarray(a[n]["kernel"]).T for n in "qkv"]))
        sd[f"{bp}.attn.in_proj_bias"] = t(np.concatenate([np.asarray(a[n]["bias"])
                                                          for n in "qkv"]))
        sd[f"{bp}.attn.bias_k"] = t(a["bias_k"], (1, 1, H))
        sd[f"{bp}.attn.bias_v"] = t(a["bias_v"], (1, 1, H))
        sd[f"{bp}.attn.out_proj.weight"] = t(np.asarray(a["out_proj"]["kernel"]).T)
        sd[f"{bp}.attn.out_proj.bias"] = t(a["out_proj"]["bias"])
        for n in ("norm_1", "norm_2"):
            sd[f"{bp}.{n}.weight"] = t(p[n]["scale"])
            sd[f"{bp}.{n}.bias"] = t(p[n]["bias"])
        for n in ("fc1", "fc2"):
            sd[f"{bp}.mlp.{n}.weight"] = t(np.asarray(p[n]["kernel"]).T)
            sd[f"{bp}.mlp.{n}.bias"] = t(p[n]["bias"])
    return sd
