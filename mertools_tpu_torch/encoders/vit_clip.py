"""CLIP-ViT vision encoder in PyTorch — port of
``mertools_tpu/encoders/vit_clip.py``.

Backs the reference's visual feature extraction
(``MERBench/feature_extraction/visual/extract_vision_huggingface.py:104-122``):
face frames -> CLIP vision tower -> pooled CLS (post-LN) -> visual
projection (``get_image_features``). Architecture (HF CLIPVisionModel): a
patch conv without bias, the CLS token, learned position embeddings,
pre-layernorm, pre-LN blocks with quick_gelu MLPs, post-layernorm on the CLS
token, a linear projection without bias.

Parameters carry HF ``CLIPVisionModelWithProjection`` key names
(``vision_model.*`` + ``visual_projection.weight``, HF's misspelt
``pre_layrnorm`` included), so :func:`load_hf_state_dict` is a key filter.
Pixels come in NHWC as in the JAX package; the patch conv runs in NCHW with
HF's OIHW weight. With ``use_flash_attention`` the attention is kernel B1
(every key valid), or its plain version on CPU tensors; Token Merging
(``tome_r``) adds log(sizes) to the logits, which B1 does not take, so the
two exclude each other. ``dot_general`` (e.g. ``ops.quant.int8_dot_general``)
replaces the product of the transformer layers' Dense sites only (q/k/v/out
and the MLP pair); the patch conv and the visual projection stay float, as
in the JAX encoder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import with_class_defaults
from ..ops.flash_attention import flash_attention
from ..ops.quant import DotGeneralLinear, set_dot_general
from .random_init import normal_state_dict
from .vit import tome_merge

# transformers' class defaults of the keys ``CLIPVisionConfig.from_hf``
# reads: a CLIPModel's config nests the tower's and keeps the projection's
# width at its top
HF_CLASS_DEFAULTS = {
    "clip": dict(projection_dim=512, vision_config={}),
    "clip_vision_model": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, image_size=224, patch_size=32, projection_dim=512,
        layer_norm_eps=1e-5),
}
# HF's CLIPVisionConfig.initializer_range: the std of a fresh tower's patch
# conv and position table
INITIALIZER_RANGE = 0.02


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    # Token Merging (arXiv:2210.09461) production mode: r merges per layer.
    # CLIP pools the protected CLS token, so the output contract is
    # unchanged — only the attention context is approximated.
    tome_r: int = 0
    use_flash_attention: bool = False

    def __post_init__(self):
        if self.tome_r > 0 and self.use_flash_attention:
            raise ValueError(
                "tome_r > 0 adds log(sizes) to the attention logits, which "
                "kernel B1 does not take: use flash=False with ToMe")

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def from_hf(cls, hf: dict) -> "CLIPVisionConfig":
        """From a ``config.json`` dict: a ``CLIPVisionModelWithProjection``
        one (flat), or a ``CLIPModel`` one, which nests ``vision_config`` and
        keeps ``projection_dim`` at the top. Every key either lacks is
        taken from ``transformers``' class defaults."""
        top = with_class_defaults(hf, HF_CLASS_DEFAULTS)
        v = with_class_defaults(
            {**(top["vision_config"] if top["model_type"] == "clip" else top),
             "model_type": "clip_vision_model"}, HF_CLASS_DEFAULTS)
        return cls(hidden_size=v["hidden_size"],
                   num_hidden_layers=v["num_hidden_layers"],
                   num_attention_heads=v["num_attention_heads"],
                   intermediate_size=v["intermediate_size"],
                   image_size=v["image_size"], patch_size=v["patch_size"],
                   projection_dim=top["projection_dim"],
                   layer_norm_eps=v["layer_norm_eps"])

    def to_config_json(self) -> dict:
        """A ``CLIPVisionModelWithProjection`` ``config.json`` dict that
        :meth:`from_hf` reads back as this config (ToMe and the kernel
        switch are run-time choices, not checkpoint keys)."""
        return dict(model_type="clip_vision_model", hidden_size=self.hidden_size,
                    num_hidden_layers=self.num_hidden_layers,
                    num_attention_heads=self.num_attention_heads,
                    intermediate_size=self.intermediate_size,
                    image_size=self.image_size, patch_size=self.patch_size,
                    projection_dim=self.projection_dim,
                    layer_norm_eps=self.layer_norm_eps)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(H))
        self.patch_embedding = nn.Conv2d(3, H, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, H)

    def forward(self, pixel_values):
        """(B, S, S, 3) NHWC -> (B, 1 + patches, H)."""
        B = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)     # (B, g*g, H), row-major
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]][None]


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.q_proj = DotGeneralLinear(H, H)
        self.k_proj = DotGeneralLinear(H, H)
        self.v_proj = DotGeneralLinear(H, H)
        self.out_proj = DotGeneralLinear(H, H)


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = DotGeneralLinear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = DotGeneralLinear(cfg.intermediate_size, cfg.hidden_size)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = _Attention(cfg)
        self.layer_norm1 = nn.LayerNorm(H, eps=eps)
        self.mlp = _MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(H, eps=eps)

    def forward(self, x, sizes, kv_len):
        c = self.cfg
        B, N, H = x.shape
        nh = c.num_attention_heads
        hd = H // nh
        a = self.self_attn
        xn = self.layer_norm1(x)
        q = a.q_proj(xn).view(B, N, nh, hd) * hd ** -0.5   # CLIP scales q
        k = a.k_proj(xn).view(B, N, nh, hd)
        v = a.v_proj(xn).view(B, N, nh, hd)
        if c.use_flash_attention:
            attn = flash_attention(q, k, v, kv_len)
        else:
            logits = torch.einsum("bqnd,bknd->bnqk", q, k)
            if sizes is not None:            # ToMe proportional attention
                logits = logits + torch.log(sizes)[:, None, None, :]
            attn = torch.einsum("bnqk,bknd->bqnd",
                                torch.softmax(logits, dim=-1), v)
        x = x + a.out_proj(attn.reshape(B, N, H))

        if sizes is not None:
            r_eff = min(c.tome_r, (N - 1) // 2)
            if r_eff > 0:
                x, sizes = tome_merge(x, k.mean(dim=2), sizes, r_eff, 1)

        x = x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))
        return x, sizes


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(H, eps=eps)   # sic: HF's key
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(H, eps=eps)


class CLIPVisionEncoder(nn.Module):
    """pixel_values (B, S, S, 3) -> dict(image_embeds (B, P), pooled (B, H),
    last_hidden (B, N, H)); N is 1 + patches less the ToMe merges."""

    def __init__(self, cfg: CLIPVisionConfig, dot_general=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                           bias=False)
        set_dot_general(self.vision_model.encoder, dot_general)

    def forward(self, pixel_values: torch.Tensor) -> dict:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        B, N = x.shape[:2]
        sizes = (torch.ones((B, N), dtype=x.dtype, device=x.device)
                 if self.cfg.tome_r > 0 else None)
        kv_len = torch.full((B,), N, dtype=torch.int32, device=x.device)
        for layer in vm.encoder.layers:
            x, sizes = layer(x, sizes, kv_len)
        pooled = vm.post_layernorm(x[:, 0])
        return {"image_embeds": self.visual_projection(pooled),
                "pooled": pooled, "last_hidden": x}


# ---------------------------------------------------------------------------
# parameters: HF checkpoints, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
def load_hf_state_dict(sd: dict) -> dict:
    """A raw HF ``CLIPVisionModelWithProjection`` or ``CLIPModel`` state dict
    -> this module's state dict: ``vision_model.*`` and
    ``visual_projection.weight`` are kept (the text tower, its projection,
    ``logit_scale`` and the position-id buffer go). Load the result with
    ``strict=True``."""
    return {k: v for k, v in sd.items()
            if (k.startswith("vision_model.") or k == "visual_projection.weight")
            and not k.endswith("position_ids")}


def state_dict_from_flax(cfg: CLIPVisionConfig, params) -> dict:
    """The JAX package's ``CLIPVisionEncoder`` param tree (numpy-convertible
    leaves) -> this module's state dict; the inverse of its
    ``convert_torch_state``."""
    sd: dict = {}
    pre = "vision_model."

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{key}.bias"] = t(p["bias"])

    def ln(key, p):
        sd[f"{key}.weight"] = t(p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    sd[f"{pre}embeddings.class_embedding"] = t(params["class_embedding"])
    # flax conv (kh, kw, in, out) -> torch (out, in, kh, kw)
    sd[f"{pre}embeddings.patch_embedding.weight"] = t(
        np.asarray(params["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{pre}embeddings.position_embedding.weight"] = t(params["position_embedding"])
    ln(f"{pre}pre_layrnorm", params["pre_layernorm"])
    ln(f"{pre}post_layernorm", params["post_layernorm"])
    sd["visual_projection.weight"] = t(
        np.asarray(params["visual_projection"]["kernel"]).T)
    for i in range(cfg.num_hidden_layers):
        p, lp = params[f"layer_{i}"], f"{pre}encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{lp}.self_attn.{n}", p[n])
        ln(f"{lp}.layer_norm1", p["layer_norm1"])
        ln(f"{lp}.layer_norm2", p["layer_norm2"])
        dense(f"{lp}.mlp.fc1", p["fc1"])
        dense(f"{lp}.mlp.fc2", p["fc2"])
    return sd


def init_params(cfg: CLIPVisionConfig, generator: torch.Generator) -> dict:
    """Seeded random state dict drawn as HF's ``CLIPPreTrainedModel``
    initialises a fresh vision tower (``initializer_factor`` 1): the class
    token and the projections normal(0, H^-1/2), q/k/v and fc2 H^-1/2 (2L)^-1/2,
    fc1 (2H)^-1/2, the patch conv and the position table
    ``INITIALIZER_RANGE``."""
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    deep = H ** -0.5 * (2 * L) ** -0.5

    def std(key: str) -> float:
        if key.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight",
                         "fc2.weight")):
            return deep
        if key.endswith("fc1.weight"):
            return (2 * H) ** -0.5
        if key.endswith(("class_embedding", "out_proj.weight",
                         "visual_projection.weight")):
            return H ** -0.5
        return INITIALIZER_RANGE      # the patch conv, the position table

    with torch.device("meta"):
        model = CLIPVisionEncoder(cfg)
    return normal_state_dict(model, generator, std)
