"""SigLIP vision tower in PyTorch (the reference AffectGPT's ``SigLIP_SO``
frozen encoder) — port of ``mertools_tpu/encoders/siglip.py``.

Backs ``MER2025/MER2025_Track23/my_affectgpt/models/encoder.py:249-282``:
frames -> ``model.vision_model(..., output_hidden_states=True)`` -> the last
hidden state before the post-LayerNorm, meaned over every token -> (B,
hidden) a frame. SigLIP has no CLS token; the canonical checkpoint is
``siglip-so400m-patch14-384`` (hidden 1152, 27 layers, 729 tokens).

Architecture (HF ``SiglipVisionTransformer``): a patch conv with bias (no
padding) and learned position embeddings; pre-LN blocks with full-bias
q/k/v/out, q scaled before the product, and a tanh-approximated GELU MLP;
``post_layernorm``; the attention-pooling head (a learned probe
cross-attends over the tokens through torch ``nn.MultiheadAttention``'s
packed q/k/v, then LayerNorm and a residual MLP). Token Merging protects no
token here, so a token mean becomes size-weighted.

Parameters carry HF ``SiglipVisionModel`` key names (``vision_model.*``), so
:func:`load_hf_state_dict` is a key filter that also takes the vision half
of a full ``SiglipModel``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import with_class_defaults
from .random_init import normal_state_dict
from .vit import INITIALIZER_RANGE, tome_merge

# transformers' class defaults of the keys ``SiglipVisionConfig.from_hf``
# reads: a SiglipModel's config nests the tower's
HF_CLASS_DEFAULTS = {
    "siglip": dict(vision_config={}),
    "siglip_vision_model": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, image_size=224, patch_size=16, layer_norm_eps=1e-6),
}


@dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    use_head: bool = True
    # Token Merging (arXiv:2210.09461); SigLIP has no CLS, so nothing is
    # protected and the token-mean feature becomes size-weighted
    tome_r: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "SiglipVisionConfig":
        """From a ``config.json`` dict: a ``SiglipVisionModel`` one (flat) or
        a ``SiglipModel`` one, which nests ``vision_config``; keys either
        lacks are ``transformers``' class defaults. The head is kept, as
        the JAX converter keeps it."""
        top = with_class_defaults(hf, HF_CLASS_DEFAULTS)
        v = with_class_defaults(
            {**(top["vision_config"] if top["model_type"] == "siglip" else top),
             "model_type": "siglip_vision_model"}, HF_CLASS_DEFAULTS)
        return cls(hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
                   num_heads=v["num_attention_heads"],
                   intermediate_size=v["intermediate_size"], image_size=v["image_size"],
                   patch_size=v["patch_size"], layer_norm_eps=v["layer_norm_eps"])

    def to_config_json(self) -> dict:
        """A ``SiglipVisionModel`` ``config.json`` dict that :meth:`from_hf`
        reads back as this config (ToMe is a run-time choice)."""
        return dict(model_type="siglip_vision_model", hidden_size=self.hidden_size,
                    num_hidden_layers=self.num_layers, num_attention_heads=self.num_heads,
                    intermediate_size=self.intermediate_size, image_size=self.image_size,
                    patch_size=self.patch_size, layer_norm_eps=self.layer_norm_eps)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _attend(q, k, v, sizes=None):
    """(B, Nq, nh, hd) x (B, N, nh, hd) -> (B, Nq, nh, hd), q already
    scaled; ToMe's log sizes added to the logits."""
    logits = torch.einsum("bqnd,bknd->bnqk", q, k)
    if sizes is not None:
        logits = logits + torch.log(sizes)[:, None, None, :]
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1), v)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size)

    def forward(self, pixel_values):
        """(B, S, S, 3) NHWC -> (B, patches, H), row-major patches."""
        x = self.patch_embedding(pixel_values.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        return x + self.position_embedding.weight[: x.shape[1]][None]


class _Attention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(H, H), nn.Linear(H, H)
        self.v_proj, self.out_proj = nn.Linear(H, H), nn.Linear(H, H)


class _MLP(nn.Module):
    def __init__(self, H: int, inter: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(H, inter), nn.Linear(inter, H)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class _Layer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.cfg = cfg
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(H, eps=eps)
        self.self_attn = _Attention(H)
        self.layer_norm2 = nn.LayerNorm(H, eps=eps)
        self.mlp = _MLP(H, cfg.intermediate_size)

    def forward(self, x, sizes):
        c = self.cfg
        B, N, H = x.shape
        nh = c.num_heads
        hd = H // nh
        a = self.self_attn
        xn = self.layer_norm1(x)
        q = a.q_proj(xn).view(B, N, nh, hd) * hd ** -0.5     # q scaled first
        k = a.k_proj(xn).view(B, N, nh, hd)
        v = a.v_proj(xn).view(B, N, nh, hd)
        x = x + a.out_proj(_attend(q, k, v, sizes).reshape(B, N, H))
        if sizes is not None:
            r_eff = min(c.tome_r, N // 2)
            if r_eff > 0:
                x, sizes = tome_merge(x, k.mean(dim=2), sizes, r_eff, 0)
        return x + self.mlp(self.layer_norm2(x)), sizes


class _PackedAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed q/k/v)."""

    def __init__(self, H: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * H, H))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * H))
        self.out_proj = nn.Linear(H, H)


class _AttentionPoolHead(nn.Module):
    """SiglipMultiheadAttentionPoolingHead: the learned probe attends over
    the tokens, then LayerNorm and a residual MLP."""

    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.probe = nn.Parameter(torch.zeros(1, 1, H))
        self.attention = _PackedAttention(H)
        self.layernorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(H, cfg.intermediate_size)

    def forward(self, tokens):
        B, N, H = tokens.shape
        nh = self.cfg.num_heads
        hd = H // nh
        wq, wk, wv = self.attention.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.attention.in_proj_bias.chunk(3, dim=0)
        q = F.linear(self.probe.expand(B, 1, H), wq, bq).view(B, 1, nh, hd) * hd ** -0.5
        k = F.linear(tokens, wk, bk).view(B, N, nh, hd)
        v = F.linear(tokens, wv, bv).view(B, N, nh, hd)
        x = self.attention.out_proj(_attend(q, k, v).reshape(B, 1, H))
        return (x + self.mlp(self.layernorm(x)))[:, 0]


class _Encoder(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if cfg.use_head:
            self.head = _AttentionPoolHead(cfg)


class SiglipVisionEncoder(nn.Module):
    """pixel_values (B, S, S, 3) -> dict(last_hidden, post_ln, and sizes
    under ToMe, pooled with the head). ``last_hidden`` is HF's
    ``hidden_states[-1]`` (before ``post_layernorm``), the tensor the
    reference mean-pools; ``pooled`` is the attention-pool head's output,
    computed unless ``head=False``."""

    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)

    def forward(self, pixel_values: torch.Tensor, head: bool = True) -> dict:
        vm = self.vision_model
        x = vm.embeddings(pixel_values)
        sizes = (torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
                 if self.cfg.tome_r > 0 else None)
        for layer in vm.encoder.layers:
            x, sizes = layer(x, sizes)
        out = {"last_hidden": x, "post_ln": vm.post_layernorm(x)}
        if sizes is not None:
            out["sizes"] = sizes
        if self.cfg.use_head and head:
            out["pooled"] = vm.head(out["post_ln"])
        return out


# ---------------------------------------------------------------------------
# parameters: HF checkpoints, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
def load_hf_state_dict(sd: dict) -> dict:
    """A raw HF ``SiglipVisionModel`` or ``SiglipModel`` state dict -> this
    module's state dict: the ``vision_model.*`` keys (the text tower,
    ``logit_scale``, ``logit_bias`` and the position-id buffers go); a bare
    ``SiglipVisionTransformer``'s keys get the prefix. Load the result with
    ``strict=True``."""
    if not any(k.startswith("vision_model.") for k in sd):
        sd = {f"vision_model.{k}": v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if k.startswith("vision_model.") and not k.endswith("position_ids")}


def state_dict_from_flax(cfg: SiglipVisionConfig, params) -> dict:
    """The JAX package's ``SiglipVisionEncoder`` param tree (numpy-convertible
    leaves) -> this module's state dict; the inverse of its
    ``convert_torch_state``."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd: dict = {}
    pre = "vision_model."

    def put(key, p):          # Dense (kernel in, out) and LayerNorm leaves
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T if "kernel" in p else p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    sd[f"{pre}embeddings.patch_embedding.weight"] = t(
        np.asarray(params["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{pre}embeddings.patch_embedding.bias"] = t(params["patch_embedding"]["bias"])
    sd[f"{pre}embeddings.position_embedding.weight"] = t(params["position_embedding"])
    put(f"{pre}post_layernorm", params["post_layernorm"])
    for i in range(cfg.num_layers):
        p, lp = params[f"layer_{i}"], f"{pre}encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{lp}.self_attn.{n}", p[n])
        for n in ("layer_norm1", "layer_norm2"):
            put(f"{lp}.{n}", p[n])
        for n in ("fc1", "fc2"):
            put(f"{lp}.mlp.{n}", p[n])
    if cfg.use_head:
        h, hp = params["head"], f"{pre}head"
        sd[f"{hp}.probe"] = t(h["probe"]).reshape(1, 1, -1)
        sd[f"{hp}.attention.in_proj_weight"] = torch.cat(
            [t(np.asarray(h[n]["kernel"]).T) for n in ("attn_q", "attn_k", "attn_v")])
        sd[f"{hp}.attention.in_proj_bias"] = torch.cat(
            [t(h[n]["bias"]) for n in ("attn_q", "attn_k", "attn_v")])
        put(f"{hp}.attention.out_proj", h["attn_out"])
        put(f"{hp}.layernorm", h["layernorm"])
        for n in ("fc1", "fc2"):
            put(f"{hp}.mlp.{n}", h[n])
    return sd


def init_params(cfg: SiglipVisionConfig, generator: torch.Generator) -> dict:
    """Seeded random state dict, drawn on the generator's device: every
    weight, table and the probe normal(0, ``INITIALIZER_RANGE``), unit
    LayerNorm scales, zero biases."""
    with torch.device("meta"):
        model = SiglipVisionEncoder(cfg)
    sd = normal_state_dict(model, generator, lambda key: INITIALIZER_RANGE)
    if cfg.use_head:
        sd["vision_model.head.attention.in_proj_bias"].zero_()
    return sd
