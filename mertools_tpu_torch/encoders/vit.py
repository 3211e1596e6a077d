"""Generic ViT encoder family in PyTorch — port of
``mertools_tpu/encoders/vit.py``: DINOv2, data2vec-vision (BEiT), VideoMAE,
EVA-CLIP-G and EVA-02 as one architecture with switches, and Token Merging
(:func:`tome_merge`), which the CLIP and SigLIP towers share.

Backs the reference's non-CLIP visual extractors
(``MERBench/feature_extraction/visual/extract_vision_huggingface.py``):
data2vec-vision and DINOv2 sum the last hidden state over tokens (DINOv2
resamples 64 frames), VideoMAE mean-pools tubelet tokens a segment, and
AffectGPT's EVA-CLIP-G means its layernormed tokens
(:mod:`..features.vision_zoo`). The switches, as in the JAX module:

- a 2D patch conv, or a 3D tubelet conv over (frames, H, W) (VideoMAE), both
  padded as Flax's ``SAME`` pads (no padding where the image size divides by
  the patch);
- learned, fixed-sinusoid (added without a CLS token) or no absolute
  position embeddings; an optional CLS token;
- pre-LN blocks with exact GELU, or SwiGLU with ``fc1_gate`` the silu
  branch; optional LayerScale ``ls1``/``ls2``;
- q/v-only bias (BEiT, VideoMAE, EVA-CLIP-G; k bias-free), else an optional
  k bias;
- BEiT's per-layer relative position bias (``blocks.{i}.rel_bias_table``
  gathered by the ``(1+N)²`` index of :func:`beit_relative_position_index`);
- EVA-02's 2D rotary embedding after the CLS token;
- an optional final LayerNorm;
- Token Merging after each block's attention (log-size attention bias, the
  head-mean of k as the metric), refused with per-layer positional
  attention as the JAX module's assert refuses it.

The attention is a dense product, as the JAX module's einsum is (no Pallas
kernel there, so no kernel of the port here). Weights come from an HF or a
timm checkpoint through :func:`load_hf_state_dict` (HF ``Dinov2Model``,
``Data2VecVisionModel``/``BeitModel``, ``VideoMAEModel``; BLIP-2's
``eva_vit_g.pth``, :func:`eva_clip_g_from_checkpoint`), which reads the
checkpoint's own key names; :func:`hf_state_dict` writes them back. The
CNN half of the JAX vision zoo (ResNet, MANet, EmoNet) is ROADMAP A9b2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import with_class_defaults
from ..core.device import on_device
from .random_init import normal_state_dict

# transformers' class defaults of the keys the family configs read
HF_CLASS_DEFAULTS = {
    "dinov2": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   mlp_ratio=4, image_size=224, patch_size=14, layerscale_value=1.0,
                   layer_norm_eps=1e-6, use_swiglu_ffn=False),
    "data2vec-vision": dict(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        intermediate_size=3072, image_size=224, patch_size=16, layer_norm_eps=1e-12,
        layer_scale_init_value=0.1, use_absolute_position_embeddings=False,
        use_relative_position_bias=False, use_mean_pooling=True),
    "videomae": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                     intermediate_size=3072, image_size=224, patch_size=16,
                     layer_norm_eps=1e-12, use_mean_pooling=True, num_frames=16,
                     tubelet_size=2, qkv_bias=True),
}
HF_CLASS_DEFAULTS["beit"] = HF_CLASS_DEFAULTS["data2vec-vision"]
# the std of every weight a seeded tower draws (HF's initializer_range)
INITIALIZER_RANGE = 0.02


@dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    # VideoMAE: > 0 turns on the 3D tubelet embedding over (frames, H, W)
    num_frames: int = 0
    tubelet_size: int = 2
    use_cls_token: bool = True
    pos_embed: str = "learned"          # learned | sincos | none
    layerscale: float = 0.0             # > 0: LayerScale (its init value)
    rel_pos_bias: bool = False          # BEiT per-layer relative bias
    qv_bias_only: bool = False          # q, v bias; k bias-free
    use_rope: bool = False              # EVA-02 2D rotary embeddings
    use_swiglu: bool = False            # SwiGLU MLP (EVA-02, dinov2-giant)
    final_layernorm: bool = True
    layer_norm_eps: float = 1e-6
    # Token Merging (arXiv:2210.09461): r most-similar token pairs merged
    # after every block's attention; not with per-layer positional attention
    tome_r: int = 0
    arch: str = "dinov2"

    def __post_init__(self):
        if self.tome_r > 0 and (self.rel_pos_bias or self.use_rope):
            raise ValueError("ToMe is incompatible with per-layer positional "
                             "attention (rel_pos_bias or use_rope)")

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        n = self.grid * self.grid
        if self.num_frames:
            n *= self.num_frames // self.tubelet_size
        return n

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


# ---------------------------------------------------------------------------
# framework-free tables (the JAX module's numpy code)
# ---------------------------------------------------------------------------
def sinusoid_table(n_pos: int, dim: int) -> np.ndarray:
    """VideoMAE's fixed table (modeling_videomae.get_sinusoid_encoding_table)."""
    pos = np.arange(n_pos)[:, None]
    den = np.power(10000.0, 2 * (np.arange(dim) // 2) / dim)
    tab = pos / den
    tab[:, 0::2] = np.sin(tab[:, 0::2])
    tab[:, 1::2] = np.cos(tab[:, 1::2])
    return tab.astype(np.float32)


def beit_relative_position_index(grid: int) -> np.ndarray:
    """BEiT relative position index over (1+N, 1+N) with the three CLS slots
    (modeling_beit.BeitRelativePositionBias.generate_relative_position_index)."""
    num_rel = (2 * grid - 1) ** 2 + 3
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    n = grid * grid
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def _rope_2d(grid: int, head_dim: int) -> np.ndarray:
    """EVA-02-style 2D axial rotary tables, stacked (sin, cos), each (N,
    head_dim)."""
    half = head_dim // 2
    quarter = half // 2
    freqs = 1.0 / (100.0 ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    ang = np.concatenate([ys.reshape(-1, 1) * freqs[None, :],
                          xs.reshape(-1, 1) * freqs[None, :]], axis=-1)   # (N, half)
    ang = np.concatenate([ang, ang], axis=-1)                          # (N, head_dim)
    return np.stack([np.sin(ang), np.cos(ang)]).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def tome_merge(x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor,
               r: int, n_protected: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ToMe bipartite soft matching (arXiv:2210.09461 §3): split tokens
    alternately into sets A/B, match each A token to its most similar B
    token (cosine on the attention-key metric), merge the r best-scoring A
    tokens into their matches by size-weighted mean. Fixed r -> static
    output shape (B, N - r, D). The first ``n_protected`` tokens (CLS) are
    never merged. Ties rank as ``jnp.argsort``'s stable order does, so
    identical tokens merge as in the JAX package."""
    B = x.shape[0]
    prot_x = x[:, :n_protected]
    xm = x[:, n_protected:]
    m = metric[:, n_protected:]
    sm = sizes[:, n_protected:]
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    a, b = m[:, ::2], m[:, 1::2]
    xa, xb = xm[:, ::2], xm[:, 1::2]
    sa, sb = sm[:, ::2], sm[:, 1::2]

    scores = torch.einsum("bad,bkd->bak", a, b)
    node_max = scores.amax(dim=-1)                    # (B, Na)
    node_idx = scores.argmax(dim=-1)                  # (B, Na) first max
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merge_src, keep_src = order[:, :r], order[:, r:]

    def take(t, idx):                                 # t[b, idx[b]]
        return torch.gather(t, 1, idx if t.dim() == 2 else
                            idx[..., None].expand(-1, -1, t.shape[-1]))

    sa_m = take(sa, merge_src)                        # (B, r)
    xa_m = take(xa, merge_src) * sa_m[..., None]
    # a row's destinations, offset into the flattened (B * Nb) set B
    Nb = xb.shape[1]
    dst = (take(node_idx, merge_src)
           + torch.arange(B, device=x.device)[:, None] * Nb).reshape(-1)
    num = (xb * sb[..., None]).reshape(B * Nb, -1).index_add(
        0, dst, xa_m.reshape(B * r, -1)).view(B, Nb, -1)
    den = sb.reshape(-1).index_add(0, dst, sa_m.reshape(-1)).view(B, Nb)
    out = torch.cat([prot_x, take(xa, keep_src), num / den[..., None]], dim=1)
    out_sizes = torch.cat([sizes[:, :n_protected], take(sa, keep_src), den],
                          dim=1)
    return out, out_sizes


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------
class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(H, eps=eps)
        self.q = nn.Linear(H, H)
        self.k = nn.Linear(H, H, bias=not cfg.qv_bias_only)
        self.v = nn.Linear(H, H)
        self.proj = nn.Linear(H, H)
        self.norm2 = nn.LayerNorm(H, eps=eps)
        self.fc1 = nn.Linear(H, cfg.intermediate_size)
        if cfg.use_swiglu:
            self.fc1_gate = nn.Linear(H, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, H)
        if cfg.layerscale > 0:
            self.ls1 = nn.Parameter(torch.full((H,), cfg.layerscale))
            self.ls2 = nn.Parameter(torch.full((H,), cfg.layerscale))
        if cfg.rel_pos_bias:
            self.rel_bias_table = nn.Parameter(
                torch.zeros((2 * cfg.grid - 1) ** 2 + 3, cfg.num_heads))

    def forward(self, x, rel_index=None, rope=None, sizes=None):
        c = self.cfg
        B, N, H = x.shape
        nh = c.num_heads
        hd = H // nh
        xn = self.norm1(x)
        q = self.q(xn).view(B, N, nh, hd)
        k = self.k(xn).view(B, N, nh, hd)
        v = self.v(xn).view(B, N, nh, hd)
        if rope is not None:          # rotate every token after the CLS token
            sin, cos = rope[0][:, None], rope[1][:, None]
            ncls = 1 if c.use_cls_token else 0

            def rot(t):
                tail = t[:, ncls:]
                return torch.cat([t[:, :ncls], tail * cos + _rotate_half(tail) * sin], dim=1)
            q, k = rot(q), rot(k)
        logits = torch.einsum("bqnd,bknd->bnqk", q * hd ** -0.5, k)
        if rel_index is not None:
            logits = logits + self.rel_bias_table[rel_index].permute(2, 0, 1)[None]
        if sizes is not None:          # ToMe proportional attention (§3)
            logits = logits + torch.log(sizes)[:, None, None, :]
        attn = torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1), v)
        out = self.proj(attn.reshape(B, N, H))
        x = x + (out * self.ls1 if c.layerscale > 0 else out)

        if sizes is not None:
            ncls = 1 if c.use_cls_token else 0
            # cap r so the bipartite sets stay non-empty (the paper caps at N/2)
            r_eff = min(c.tome_r, (N - ncls) // 2)
            if r_eff > 0:
                x, sizes = tome_merge(x, k.mean(dim=2), sizes, r_eff, ncls)

        xn = self.norm2(x)
        h = (F.silu(self.fc1_gate(xn)) * self.fc1(xn) if c.use_swiglu
             else F.gelu(self.fc1(xn)))
        out = self.fc2(h)
        return x + (out * self.ls2 if c.layerscale > 0 else out), sizes


def _same_pad(x: torch.Tensor, dims: tuple, kernel: tuple) -> torch.Tensor:
    """Flax's ``SAME`` padding of a conv whose stride equals its kernel,
    over channel-first ``dims``: out = ceil(n / k), the pad split low-half
    first. Nothing where n divides by k."""
    pads = []
    for n, k in zip(reversed(dims), reversed(kernel)):
        total = -(-n // k) * k - n
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ViTEncoder(nn.Module):
    """(B, S, S, C) images, or (B, T, S, S, C) frame stacks for VideoMAE ->
    (tokens (B, N, hidden), sizes (B, N) under ToMe, else None)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        H, p = cfg.hidden_size, cfg.patch_size
        if cfg.num_frames:
            k = (cfg.tubelet_size, p, p)
            self.patch_embed = nn.Conv3d(cfg.num_channels, H, k, stride=k)
        else:
            self.patch_embed = nn.Conv2d(cfg.num_channels, H, p, stride=p)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(H))
        if cfg.pos_embed == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(cfg.seq_len, H))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers))
        if cfg.final_layernorm:
            self.final_norm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor):
        c = self.cfg
        B = pixels.shape[0]
        # channels first: (B, C, [T,] S, S)
        x = pixels.permute(0, pixels.dim() - 1, *range(1, pixels.dim() - 1))
        x = _same_pad(x, x.shape[2:], self.patch_embed.kernel_size)
        # tokens in (t', h', w') order, as the JAX module's NDHWC reshape
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        if c.use_cls_token:
            x = torch.cat([self.cls_token.expand(B, 1, -1), x], dim=1)
        if c.pos_embed == "learned":
            x = x + self.pos_embed[None]
        elif c.pos_embed == "sincos":
            x = x + on_device(sinusoid_table, x.device, c.num_patches,
                              c.hidden_size).to(x.dtype)[None]
        rel_index = (on_device(beit_relative_position_index, x.device, c.grid)
                     if c.rel_pos_bias else None)
        rope = (on_device(_rope_2d, x.device, c.grid, c.hidden_size // c.num_heads
                          ).to(x.dtype) if c.use_rope else None)
        sizes = (torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
                 if c.tome_r > 0 else None)
        for blk in self.blocks:
            x, sizes = blk(x, rel_index, rope, sizes)
        if c.final_layernorm:
            x = self.final_norm(x)
        # merged tokens carry their size: size-weighted pooling gives sums
        # and means over the original token count
        return x, sizes


# ---------------------------------------------------------------------------
# the family configs
# ---------------------------------------------------------------------------
def dinov2_config(hf: dict | None = None, **kw) -> ViTConfig:
    """From a ``Dinov2Model`` ``config.json`` dict (keys it lacks from the
    class defaults), else the defaults with ``kw``."""
    if hf is None:
        return ViTConfig(arch="dinov2", patch_size=14, layerscale=1.0, **kw)
    h = with_class_defaults(hf, HF_CLASS_DEFAULTS)
    swiglu = bool(h["use_swiglu_ffn"])
    inter = int(h["hidden_size"] * h["mlp_ratio"])
    if swiglu:   # dinov2-giant: HF rounds 2/3 of the MLP width up to 8
        inter = (int(inter * 2 / 3) + 7) // 8 * 8
    return ViTConfig(
        hidden_size=h["hidden_size"], num_layers=h["num_hidden_layers"],
        num_heads=h["num_attention_heads"], intermediate_size=inter, use_swiglu=swiglu,
        image_size=h["image_size"], patch_size=h["patch_size"],
        layerscale=h["layerscale_value"], pos_embed="learned", final_layernorm=True,
        layer_norm_eps=h["layer_norm_eps"], arch="dinov2")


def beit_config(hf: dict | None = None, **kw) -> ViTConfig:
    """data2vec-vision == the BEiT architecture (HF ``Data2VecVisionModel``,
    ``BeitModel``). Reads ``use_relative_position_bias`` only, as the JAX
    function does: a shared table (``use_shared_relative_position_bias``)
    is left out."""
    if hf is None:
        return ViTConfig(arch="beit", pos_embed="none", rel_pos_bias=True,
                         qv_bias_only=True, layerscale=0.1, final_layernorm=False, **kw)
    h = with_class_defaults(hf, HF_CLASS_DEFAULTS)
    return ViTConfig(
        hidden_size=h["hidden_size"], num_layers=h["num_hidden_layers"],
        num_heads=h["num_attention_heads"], intermediate_size=h["intermediate_size"],
        image_size=h["image_size"], patch_size=h["patch_size"],
        layerscale=h["layer_scale_init_value"],
        pos_embed="learned" if h["use_absolute_position_embeddings"] else "none",
        rel_pos_bias=h["use_relative_position_bias"], qv_bias_only=True,
        final_layernorm=not h["use_mean_pooling"], layer_norm_eps=h["layer_norm_eps"],
        arch="beit")


def videomae_config(hf: dict | None = None, **kw) -> ViTConfig:
    if hf is None:
        kw.setdefault("num_frames", 16)
        return ViTConfig(arch="videomae", use_cls_token=False, pos_embed="sincos",
                         qv_bias_only=True, final_layernorm=False, **kw)
    h = with_class_defaults(hf, HF_CLASS_DEFAULTS)
    return ViTConfig(
        hidden_size=h["hidden_size"], num_layers=h["num_hidden_layers"],
        num_heads=h["num_attention_heads"], intermediate_size=h["intermediate_size"],
        image_size=h["image_size"], patch_size=h["patch_size"],
        num_frames=h["num_frames"], tubelet_size=h["tubelet_size"],
        use_cls_token=False, pos_embed="sincos", qv_bias_only=h["qkv_bias"],
        final_layernorm=not h["use_mean_pooling"], layer_norm_eps=h["layer_norm_eps"],
        arch="videomae")


def eva_clip_g_config(**kw) -> ViTConfig:
    """BLIP-2 / Video-LLaMA EVA-ViT-g (the reference AffectGPT's EVA_CLIP_G
    frozen encoder, ``my_affectgpt/models/eva_vit.py:389-402``): patch 14,
    1408 hidden x 39 layers x 16 heads, MLP 6144 (ratio 4.3637), q/v-only
    bias, learned position table with CLS, no final LayerNorm (AffectGPT
    applies its own ``ln_vision``)."""
    kw.setdefault("hidden_size", 1408)
    kw.setdefault("num_layers", 39)
    kw.setdefault("num_heads", 16)
    kw.setdefault("intermediate_size", int(kw["hidden_size"] * 4.3637))
    kw.setdefault("patch_size", 14)
    return ViTConfig(arch="eva_clip_g", qv_bias_only=True, final_layernorm=False,
                     layer_norm_eps=1e-6, **kw)


def eva02_config(**kw) -> ViTConfig:
    """EVA-02's structure (timm ``eva02_*``): rotary + SwiGLU. No checkpoint
    route: the JAX CLI sends ``eva02-*`` names to its CLIP default."""
    return ViTConfig(arch="eva02", patch_size=14, use_rope=True, use_swiglu=True,
                     final_layernorm=True, **kw)


# ---------------------------------------------------------------------------
# parameters: checkpoint key names, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
# a block's tensors: this module's name -> the layer's name in each layout
_HF_BLOCK = {
    "dinov2": dict(norm1="norm1", norm2="norm2", q="attention.attention.query",
                   k="attention.attention.key", v="attention.attention.value",
                   proj="attention.output.dense", fc1="mlp.fc1", fc2="mlp.fc2",
                   ls1="layer_scale1.lambda1", ls2="layer_scale2.lambda1"),
    "beit": dict(norm1="layernorm_before", norm2="layernorm_after",
                 q="attention.attention.query", k="attention.attention.key",
                 v="attention.attention.value", proj="attention.output.dense",
                 fc1="intermediate.dense", fc2="output.dense", ls1="lambda_1",
                 ls2="lambda_2", rel_bias_table="attention.attention.relative_position_bias."
                 "relative_position_bias_table"),
    "eva_clip_g": dict(norm1="norm1", norm2="norm2", proj="attn.proj", fc1="mlp.fc1",
                       fc2="mlp.fc2"),
}
_HF_BLOCK["videomae"] = _HF_BLOCK["beit"]
_HF_TOP = {
    "eva_clip_g": dict(patch_embed="patch_embed.proj", cls_token="cls_token",
                       pos_embed="pos_embed"),
    "hf": dict(patch_embed="embeddings.patch_embeddings.projection",
               cls_token="embeddings.cls_token", pos_embed="embeddings.position_embeddings",
               final_norm="layernorm"),
}


def _checkpoint_keys(cfg: ViTConfig) -> dict:
    """This module's key -> (the checkpoint's key, (chunk, of n) of its dim 0
    or None) for ``cfg.arch``'s layout: HF's for dinov2, beit and videomae,
    BLIP-2's timm keys for eva_clip_g."""
    if cfg.arch not in _HF_BLOCK:
        raise ValueError(f"no checkpoint layout for arch {cfg.arch!r}")
    with torch.device("meta"):
        keys = ViTEncoder(cfg).state_dict().keys()
    top = _HF_TOP["eva_clip_g" if cfg.arch == "eva_clip_g" else "hf"]
    block, layer = _HF_BLOCK[cfg.arch], "blocks" if cfg.arch == "eva_clip_g" else "encoder.layer"
    out = {}
    for key in keys:
        head, _, leaf = key.rpartition(".")
        if not key.startswith("blocks."):
            name = top[head or key]
            out[key] = (f"{name}.{leaf}" if head else name, None)
            continue
        i, part = key.split(".")[1], key.split(".", 2)[2]
        pre = f"{layer}.{i}"
        mod, _, leaf = part.rpartition(".")
        if cfg.arch == "eva_clip_g" and mod in ("q", "k", "v"):
            out[key] = ((f"{pre}.attn.qkv.weight", ("qkv".index(mod), 3)) if leaf == "weight"
                        else (f"{pre}.attn.{mod}_bias", None))
        elif cfg.arch == "videomae" and leaf == "bias" and mod in ("q", "v"):
            out[key] = (f"{pre}.attention.attention.{mod}_bias", None)
        elif cfg.use_swiglu and mod in ("fc1", "fc1_gate"):
            # HF Dinov2SwiGLUFFN: x1, x2 = chunk(weights_in(x)); silu(x1) * x2
            out[key] = (f"{pre}.mlp.weights_in.{leaf}", (int(mod == "fc1"), 2))
        elif cfg.use_swiglu and mod == "fc2":
            out[key] = (f"{pre}.mlp.weights_out.{leaf}", None)
        else:
            out[key] = (f"{pre}.{block[mod or part]}" + (f".{leaf}" if mod else ""), None)
    return out


def load_hf_state_dict(cfg: ViTConfig, sd: dict) -> dict:
    """A raw checkpoint state dict in ``cfg.arch``'s layout -> this module's
    state dict (on the CPU), read by the checkpoint's own key names, as the
    JAX converters ``from_hf_{dinov2,beit,videomae}`` and
    ``from_eva_clip_g_checkpoint`` read them: dinov2-giant's packed
    ``mlp.weights_in`` split x1 -> ``fc1_gate``, x2 -> ``fc1``; VideoMAE's
    separate ``q_bias``/``v_bias``; BLIP-2's packed bias-free ``qkv``. Keys
    the module has no place for (``embeddings.mask_token``, ``pooler.*``, a
    shared relative bias table) are left out; a q/k/v bias a checkpoint
    lacks is zero, as the layer without one computes."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ViTEncoder(cfg).state_dict().items()}
    out = {}
    for key, (src, part) in _checkpoint_keys(cfg).items():
        if src not in sd and key.endswith("bias") and key.split(".")[-2] in ("q", "k", "v"):
            out[key] = torch.zeros(shapes[key])
            continue
        t = sd[src]
        if part is not None:
            t = t.chunk(part[1], dim=0)[part[0]]
        out[key] = t.reshape(shapes[key]).float()
    return out


def hf_state_dict(cfg: ViTConfig, sd: dict) -> dict:
    """This module's state dict -> ``cfg.arch``'s checkpoint layout (the
    inverse of :func:`load_hf_state_dict`): the class token (1, 1, H) and the
    position table (1, N, H) as HF and timm keep them."""
    packed: dict = {}
    out = {}
    for key, (dst, part) in _checkpoint_keys(cfg).items():
        t = sd[key].detach().cpu()
        if key in ("cls_token", "pos_embed"):
            t = t.reshape(1, -1, cfg.hidden_size)
        if part is None:
            out[dst] = t
        else:
            packed.setdefault(dst, {})[part[0]] = t
    for dst, chunks in packed.items():
        out[dst] = torch.cat([chunks[i] for i in sorted(chunks)], dim=0)
    return out


def eva_clip_g_from_checkpoint(sd: dict, cfg: ViTConfig | None = None
                               ) -> tuple[ViTConfig, dict]:
    """A BLIP-2 ``eva_vit_g.pth`` state dict (timm naming: ``patch_embed.proj
    / cls_token / pos_embed / blocks.N.{norm1,norm2,attn.{qkv,q_bias,v_bias,
    proj},mlp.{fc1,fc2}}``) -> (its config, this module's state dict); the
    config is read from the shapes as the JAX converter reads it."""
    if cfg is None:
        n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
        patch = sd["patch_embed.proj.weight"].shape[-1]
        grid = math.isqrt(sd["pos_embed"].shape[1] - 1)
        cfg = eva_clip_g_config(hidden_size=sd["cls_token"].shape[-1], num_layers=n_layers,
                                intermediate_size=sd["blocks.0.mlp.fc1.weight"].shape[0],
                                image_size=grid * patch, patch_size=patch)
    return cfg, load_hf_state_dict(cfg, sd)


def state_dict_from_flax(cfg: ViTConfig, params) -> dict:
    """The JAX package's ``ViTEncoder`` param tree (numpy-convertible leaves)
    -> this module's state dict."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd: dict = {}

    def put(key, p):          # Dense (kernel in, out) and LayerNorm leaves
        if "kernel" in p:
            sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)
        if "scale" in p:
            sd[f"{key}.weight"] = t(p["scale"])
        if "bias" in p:
            sd[f"{key}.bias"] = t(p["bias"])

    k = np.asarray(params["patch_embed"]["kernel"])   # ([kt,] kh, kw, in, out)
    sd["patch_embed.weight"] = t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
    sd["patch_embed.bias"] = t(params["patch_embed"]["bias"])
    for name in ("cls_token", "pos_embed"):
        if name in params:
            sd[name] = t(params[name])
    if "final_norm" in params:
        put("final_norm", params["final_norm"])
    for i in range(cfg.num_layers):
        p, pre = params[f"block_{i}"], f"blocks.{i}"
        for name, leaf in p.items():
            if name in ("ls1", "ls2"):
                sd[f"{pre}.{name}"] = t(leaf)
            else:
                put(f"{pre}.{name}", leaf)
        if cfg.rel_pos_bias:
            sd[f"{pre}.rel_bias_table"] = t(params[f"rel_bias_table_{i}"])
    return sd


def init_params(cfg: ViTConfig, generator: torch.Generator) -> dict:
    """Seeded random state dict, drawn on the generator's device: every
    weight, table and the class token normal(0, ``INITIALIZER_RANGE``), unit
    LayerNorm scales, zero biases and LayerScale at ``cfg.layerscale``."""
    with torch.device("meta"):
        model = ViTEncoder(cfg)
    sd = normal_state_dict(model, generator, lambda key: INITIALIZER_RANGE)
    for key in sd:
        if key.endswith((".ls1", ".ls2")):
            sd[key].fill_(cfg.layerscale)
    return sd

