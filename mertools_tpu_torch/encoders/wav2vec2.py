"""wav2vec2-family audio encoders (wav2vec2 / HuBERT / data2vec-audio / WavLM)
in PyTorch — port of ``mertools_tpu/encoders/wav2vec2.py``.

raw 16 kHz wav -> strided conv feature extractor -> projection -> conv
positional embedding -> transformer stack, returning every hidden state for
the last-4-layer sum. Two norm regimes, selected like HF:

  * ``group`` + post-LN (base models): a masked GroupNorm(C, C) on conv
    layer 0 only; the encoder LayerNorm comes BEFORE the layers.
  * ``layer`` + pre-LN / "stable layer norm" (large models): LayerNorm after
    every conv; pre-LN blocks with a final LayerNorm.

Parameters carry HF state-dict key names, so an HF checkpoint loads through
:func:`load_hf_state_dict` alone; the one difference is that the
weight-normed positional conv is stored materialised as
``encoder.pos_conv_embed.conv.weight``. Public layouts follow the JAX
package: wav (B, T), hidden states (B, T, H); the conv stack runs in NCW.
With ``use_flash_attention`` the standard attention calls the hand-written
CUDA kernel (:mod:`..ops.flash_attention`), or its plain version on CPU.
``dot_general`` (e.g. ``ops.quant.int8_dot_general``) replaces the product
of the transformer layers' Dense sites only (q/k/v/out projections and the
feed-forward pair); the conv frontend, the feature projection and the
positional conv stay float, as in the JAX encoder.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import with_class_defaults
from ..ops.flash_attention import flash_attention
from ..ops.quant import DotGeneralLinear, set_dot_general

# transformers' class defaults of the keys ``Wav2Vec2Config.from_hf`` reads,
# by model type (a key a class lacks keeps from_hf's own fallback)
_W2V_DEFAULTS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=False,
    num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5)
_W2V_GROUP_NORM = dict(_W2V_DEFAULTS, feat_extract_norm="group",
                       do_stable_layer_norm=False, num_conv_pos_embeddings=128)
HF_CLASS_DEFAULTS = {
    "wav2vec2": _W2V_GROUP_NORM,
    "hubert": _W2V_GROUP_NORM,
    "wavlm": dict(_W2V_GROUP_NORM, num_buckets=320, max_bucket_distance=800),
    "data2vec-audio": dict(_W2V_DEFAULTS, num_conv_pos_embeddings=5,
                           conv_pos_kernel_size=19),
}


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" | "layer"
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # WavLM: gated relative-position-bias attention (modeling_wavlm.py:108-271)
    attn_type: str = "standard"       # "standard" | "wavlm"
    num_buckets: int = 320
    max_distance: int = 800
    # data2vec-audio: stack of pos-conv layers with non-affine LN
    # (modeling_data2vec_audio.py:93-124) instead of one weight-normed conv
    pos_conv_depth: int = 0
    conv_pos_kernel_size: int = 19
    # The hand-written attention kernel (standard attention only): fused
    # online softmax, the (B, nh, T, T) logits never reach device memory.
    use_flash_attention: bool = False

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def large(cls):
        return cls(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096, conv_bias=True,
                   feat_extract_norm="layer", do_stable_layer_norm=True)

    @classmethod
    def from_config_json(cls, raw: dict) -> "Wav2Vec2Config":
        """From a checkpoint's ``config.json`` dict, every key it lacks
        taken from ``transformers``' class defaults."""
        return cls.from_hf(SimpleNamespace(**with_class_defaults(raw, HF_CLASS_DEFAULTS)))

    @classmethod
    def from_hf(cls, hf_cfg) -> "Wav2Vec2Config":
        return cls(hidden_size=hf_cfg.hidden_size,
                   num_hidden_layers=hf_cfg.num_hidden_layers,
                   num_attention_heads=hf_cfg.num_attention_heads,
                   intermediate_size=hf_cfg.intermediate_size,
                   conv_dim=tuple(hf_cfg.conv_dim),
                   conv_kernel=tuple(hf_cfg.conv_kernel),
                   conv_stride=tuple(hf_cfg.conv_stride),
                   conv_bias=getattr(hf_cfg, "conv_bias", False),
                   # data2vec-audio has no feat_extract_norm knob: every conv
                   # carries a LayerNorm ("layer" mode), post-LN encoder
                   feat_extract_norm=getattr(hf_cfg, "feat_extract_norm",
                                             "layer"),
                   do_stable_layer_norm=getattr(hf_cfg,
                                                "do_stable_layer_norm", False),
                   num_conv_pos_embeddings=hf_cfg.num_conv_pos_embeddings,
                   num_conv_pos_embedding_groups=hf_cfg.num_conv_pos_embedding_groups,
                   layer_norm_eps=hf_cfg.layer_norm_eps,
                   attn_type=("wavlm" if hf_cfg.model_type == "wavlm"
                              else "standard"),
                   num_buckets=getattr(hf_cfg, "num_buckets", 320),
                   max_distance=getattr(hf_cfg, "max_bucket_distance", 800),
                   pos_conv_depth=(hf_cfg.num_conv_pos_embeddings
                                   if hf_cfg.model_type == "data2vec-audio"
                                   else 0),
                   conv_pos_kernel_size=getattr(hf_cfg,
                                                "conv_pos_kernel_size", 19))

    def to_config_json(self) -> dict:
        """An HF ``config.json`` dict that :meth:`from_config_json` reads
        back as this config (model type ``wavlm`` for the gated relative
        attention, ``data2vec-audio`` for the positional conv stack, else
        ``hubert``)."""
        model_type = ("wavlm" if self.attn_type == "wavlm" else
                      "data2vec-audio" if self.pos_conv_depth > 0 else "hubert")
        return dict(
            model_type=model_type, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size, conv_dim=list(self.conv_dim),
            conv_kernel=list(self.conv_kernel), conv_stride=list(self.conv_stride),
            conv_bias=self.conv_bias, feat_extract_norm=self.feat_extract_norm,
            do_stable_layer_norm=self.do_stable_layer_norm,
            num_conv_pos_embeddings=(self.pos_conv_depth if self.pos_conv_depth > 0
                                     else self.num_conv_pos_embeddings),
            num_conv_pos_embedding_groups=self.num_conv_pos_embedding_groups,
            layer_norm_eps=self.layer_norm_eps, num_buckets=self.num_buckets,
            max_bucket_distance=self.max_distance,
            conv_pos_kernel_size=self.conv_pos_kernel_size)

    def feat_lengths(self, wav_lengths):
        """conv output frame count per sample (HF _get_feat_extract_output_lengths).
        Works on ints, numpy arrays and tensors alike."""
        L = wav_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            L = (L - k) // s + 1
        return L


class MaskedChannelNorm(nn.Module):
    """GroupNorm(C, C) (per-channel instance norm over time) with the
    statistics restricted to valid frames, so a batched padded forward
    matches per-clip forwards (HF's GroupNorm counts the padding)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None):
        # x: (B, T, C); frame_mask: (B, T) bool or None
        if frame_mask is None:
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, correction=0, keepdim=True)
        else:
            m = frame_mask[:, :, None].to(x.dtype)
            n = m.sum(dim=1, keepdim=True).clamp_min(1.0)
            mean = (x * m).sum(dim=1, keepdim=True) / n
            var = ((x - mean) ** 2 * m).sum(dim=1, keepdim=True) / n
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, i: int):
        super().__init__()
        c_in = 1 if i == 0 else cfg.conv_dim[i - 1]
        dim = cfg.conv_dim[i]
        self.conv = nn.Conv1d(c_in, dim, cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "group" and i == 0:
            self.layer_norm = MaskedChannelNorm(dim, cfg.layer_norm_eps)
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        else:
            self.layer_norm = None


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, wav, wav_lengths):
        """(B, T) wav -> (B, F, C) features."""
        x = wav[:, None, :]                                  # NCW
        lengths = wav_lengths
        for layer in self.conv_layers:
            x = layer.conv(x)
            k, s = layer.conv.kernel_size[0], layer.conv.stride[0]
            if lengths is not None:
                lengths = (lengths - k) // s + 1
            if isinstance(layer.layer_norm, MaskedChannelNorm):
                fm = None
                if lengths is not None:
                    t_idx = torch.arange(x.shape[2], device=x.device)
                    fm = t_idx[None, :] < lengths[:, None]
                x = layer.layer_norm(x.transpose(1, 2), fm).transpose(1, 2)
            elif layer.layer_norm is not None:
                x = layer.layer_norm(x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


def _pos_conv(cfg: Wav2Vec2Config, k: int) -> nn.Conv1d:
    return nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                     groups=cfg.num_conv_pos_embedding_groups)


class _PositionalConvEmbedding(nn.Module):
    """One weight-normed conv (stored materialised) + gelu, or the
    data2vec-audio stack of conv -> LN (no affine) -> gelu."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        if cfg.pos_conv_depth > 0:
            self.layers = nn.ModuleList(
                nn.ModuleDict({"conv": _pos_conv(cfg, cfg.conv_pos_kernel_size)})
                for _ in range(cfg.pos_conv_depth))
        else:
            self.conv = _pos_conv(cfg, cfg.num_conv_pos_embeddings)

    def forward(self, x):
        """(B, T, H) -> positional term (B, T, H)."""
        c = self.cfg
        if c.pos_conv_depth > 0:
            pos = x
            for layer in self.layers:
                pos = layer["conv"](pos.transpose(1, 2)).transpose(1, 2)
                if c.conv_pos_kernel_size % 2 == 0:
                    pos = pos[:, :-1]
                pos = F.layer_norm(pos, (c.hidden_size,), eps=c.layer_norm_eps)
                pos = F.gelu(pos)
            return pos
        pos = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if c.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        return F.gelu(pos)


def _softmax_attention(q, k, v, bias):
    """(B, T, nh, hd) q (pre-scaled), k, v + additive logit bias -> (B, T, nh, hd)."""
    logits = torch.einsum("bqnd,bknd->bnqk", q, k)
    if bias is not None:
        logits = logits + bias
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1), v)


class _Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.q_proj = DotGeneralLinear(H, H)
        self.k_proj = DotGeneralLinear(H, H)
        self.v_proj = DotGeneralLinear(H, H)
        self.out_proj = DotGeneralLinear(H, H)

    def _qkv(self, x):
        B, T, H = x.shape
        nh = self.cfg.num_attention_heads
        hd = H // nh
        return (self.q_proj(x).view(B, T, nh, hd) * (hd ** -0.5),
                self.k_proj(x).view(B, T, nh, hd),
                self.v_proj(x).view(B, T, nh, hd))

    def forward(self, x, bias, kv_len, pos_bias=None):
        q, k, v = self._qkv(x)
        out = (flash_attention(q, k, v, kv_len) if self.cfg.use_flash_attention
               else _softmax_attention(q, k, v, bias))
        return self.out_proj(out.reshape(x.shape))


def wavlm_rel_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style bidirectional log buckets (modeling_wavlm.py:253-271)."""
    half = num_buckets // 2
    rel = np.arange(T)[None, :] - np.arange(T)[:, None]     # memory - context
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    is_small = rel < max_exact
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact) /
                         np.log(max_distance / max_exact) *
                         (half - max_exact)).astype(np.int64)
    large = np.minimum(large, half - 1)
    return buckets + np.where(is_small, rel, large)


class _WavLMAttention(_Attention):
    """WavLM gated relative-position attention: the shared (nh, T, T) bias is
    gated per layer/query from projected head states
    (modeling_wavlm.py:147-186). Never takes the flash kernel."""

    def __init__(self, cfg: Wav2Vec2Config, has_rel_embed: bool):
        super().__init__(cfg)
        nh = cfg.num_attention_heads
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, nh, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(cfg.hidden_size // nh, 8)
        # HF keeps the shared table in layer 0 only
        self.rel_attn_embed = (nn.Embedding(cfg.num_buckets, nh)
                               if has_rel_embed else None)

    def forward(self, x, bias, kv_len, pos_bias=None):
        c = self.cfg
        B, T, H = x.shape
        nh = c.num_attention_heads
        hd = H // nh
        heads = x.view(B, T, nh, hd).transpose(1, 2)            # (B,nh,T,hd)
        g = self.gru_rel_pos_linear(heads).view(B, nh, T, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
        gated_bias = gate * pos_bias[None]                      # (B,nh,T,T)
        if bias is not None:
            gated_bias = gated_bias + bias
        out = _softmax_attention(*self._qkv(x), gated_bias)
        return self.out_proj(out.reshape(B, T, H))


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = DotGeneralLinear(cfg.hidden_size,
                                                   cfg.intermediate_size)
        self.output_dense = DotGeneralLinear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, i: int):
        super().__init__()
        self.cfg = cfg
        self.attention = (_WavLMAttention(cfg, has_rel_embed=i == 0)
                          if cfg.attn_type == "wavlm" else _Attention(cfg))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x, bias, kv_len, pos_bias=None):
        if self.cfg.do_stable_layer_norm:  # pre-LN
            x = x + self.attention(self.layer_norm(x), bias, kv_len, pos_bias)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, bias, kv_len, pos_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            _Layer(cfg, i) for i in range(cfg.num_hidden_layers))


class Wav2Vec2Encoder(nn.Module):
    """wav (B, T) [+ wav lengths (B,)] -> tuple of hidden states
    (num_layers + 1, each (B, F, H)). No dropout anywhere: the JAX encoder
    has none, so training mode computes what eval mode does."""

    def __init__(self, cfg: Wav2Vec2Config, dot_general=None):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)
        set_dot_general(self.encoder.layers, dot_general)

    def forward(self, wav: torch.Tensor,
                wav_lengths: torch.Tensor | None = None) -> tuple:
        c = self.cfg
        x = self.feature_extractor(wav, wav_lengths)         # (B, F, C)
        B, Fr = x.shape[0], x.shape[1]

        mask = None
        if wav_lengths is not None:
            frames = c.feat_lengths(wav_lengths)
            mask = torch.arange(Fr, device=x.device)[None, :] < frames[:, None]
            kv_len = frames.clamp(-1, Fr).to(torch.int32)
        else:
            kv_len = torch.full((B,), Fr, dtype=torch.int32, device=x.device)

        x = self.feature_projection(x)
        if mask is not None:
            x = torch.where(mask[:, :, None], x, 0.0)  # HF zeroes masked frames
        x = x + self.encoder.pos_conv_embed(x)

        bias = None
        if mask is not None:
            bias = torch.where(mask[:, None, None, :], 0.0, -1e30).to(x.dtype)

        pos_bias = None
        if c.attn_type == "wavlm":
            buckets = torch.from_numpy(
                wavlm_rel_buckets(Fr, c.num_buckets, c.max_distance)).to(x.device)
            table = self.encoder.layers[0].attention.rel_attn_embed.weight
            pos_bias = table[buckets].permute(2, 0, 1)              # (nh, T, T)

        hidden_states = []
        if not c.do_stable_layer_norm:
            x = self.encoder.layer_norm(x)
        hidden_states.append(x)
        for layer in self.encoder.layers:
            x = layer(x, bias, kv_len, pos_bias)
            hidden_states.append(x)
        if c.do_stable_layer_norm:
            hidden_states[-1] = self.encoder.layer_norm(x)
        return tuple(hidden_states)


# ---------------------------------------------------------------------------
# parameters: HF checkpoints, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
_HF_TRAINING_ONLY = ("masked_spec_embed",)
# the body's prefix in a checkpoint saved with a head (e.g. HubertForCTC)
_HF_PREFIXES = ("wav2vec2.", "hubert.", "data2vec_audio.", "wavlm.")


def load_hf_state_dict(sd: dict) -> dict:
    """HF Wav2Vec2Model/HubertModel/Data2VecAudioModel/WavLMModel state dict
    (or a raw checkpoint saved with a head: the body's ``hubert.``-style
    prefix is stripped and the head dropped) -> this module's state dict:
    the weight-normed positional conv (``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0/1``) is folded to ``g * v / ||v||``
    over dims (0, 1), and the training-only ``masked_spec_embed`` is
    dropped. Load the result with ``strict=True``."""
    pre = next((p for p in _HF_PREFIXES if any(k.startswith(p) for k in sd)), "")
    sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out = {k: v for k, v in sd.items() if k not in _HF_TRAINING_ONLY}
    base = "encoder.pos_conv_embed.conv"
    for g_key, v_key in ((f"{base}.parametrizations.weight.original0",
                          f"{base}.parametrizations.weight.original1"),
                         (f"{base}.weight_g", f"{base}.weight_v")):
        if g_key in out:
            g, v = out.pop(g_key), out.pop(v_key)
            norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
            out[f"{base}.weight"] = g * v / norm               # (out, in/g, k)
    return out


def state_dict_from_flax(cfg: Wav2Vec2Config, params) -> dict:
    """The JAX package's Flax param tree (numpy-convertible leaves) -> this
    module's state dict; the inverse of ``convert_torch_state``
    (``mertools_tpu/encoders/wav2vec2.py:390-459``)."""
    sd: dict = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)      # (in,out)->(out,in)
        sd[f"{key}.bias"] = t(p["bias"])

    def conv(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).transpose(2, 1, 0))
        if "bias" in p:
            sd[f"{key}.bias"] = t(p["bias"])

    def ln(key, p):
        sd[f"{key}.weight"] = t(p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    for i in range(len(cfg.conv_dim)):
        conv(f"feature_extractor.conv_layers.{i}.conv", params[f"conv_{i}"])
        if f"conv_norm_{i}" in params:
            ln(f"feature_extractor.conv_layers.{i}.layer_norm",
               params[f"conv_norm_{i}"])
    ln("feature_projection.layer_norm", params["fp_layer_norm"])
    dense("feature_projection.projection", params["fp_projection"])
    if cfg.pos_conv_depth > 0:
        for j in range(cfg.pos_conv_depth):
            conv(f"encoder.pos_conv_embed.layers.{j}.conv", params[f"pos_conv_{j}"])
    else:
        conv("encoder.pos_conv_embed.conv", params["pos_conv"])
    ln("encoder.layer_norm", params["encoder_layer_norm"])
    if cfg.attn_type == "wavlm":
        sd["encoder.layers.0.attention.rel_attn_embed.weight"] = t(
            params["rel_attn_embed"])
    for i in range(cfg.num_hidden_layers):
        p, pre = params[f"layer_{i}"], f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{pre}.attention.{n}", p["attention"][n])
        if cfg.attn_type == "wavlm":
            dense(f"{pre}.attention.gru_rel_pos_linear",
                  p["attention"]["gru_rel_pos_linear"])
            sd[f"{pre}.attention.gru_rel_pos_const"] = t(
                p["attention"]["gru_rel_pos_const"])
        ln(f"{pre}.layer_norm", p["layer_norm"])
        ln(f"{pre}.final_layer_norm", p["final_layer_norm"])
        dense(f"{pre}.feed_forward.intermediate_dense", p["ffn_intermediate"])
        dense(f"{pre}.feed_forward.output_dense", p["ffn_output"])
    return sd


def init_params(cfg: Wav2Vec2Config, generator: torch.Generator) -> dict:
    """Random state dict with Flax's default initialisers, as the JAX
    package's ``--random_init`` draws them: lecun-normal (truncated at two
    standard deviations) kernels with fan_in = in_features or
    in_channels/groups * kernel, zero biases, unit norm scales and
    ``gru_rel_pos_const``, normal(0.02) WavLM bucket table. The draws differ
    from JAX's (another generator); the scales match through every layer."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Wav2Vec2Encoder(cfg).state_dict().items()}
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("rel_attn_embed.weight"):
            sd[key] = torch.randn(shape, generator=generator) * 0.02
        elif key.endswith("gru_rel_pos_const") or (
                key.endswith(".weight") and len(shape) == 1):
            sd[key] = torch.ones(shape)
        elif key.endswith(".bias"):
            sd[key] = torch.zeros(shape)
        else:  # Linear (out, in) or Conv1d (out, in/groups, k) kernel
            fan_in = math.prod(shape[1:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            sd[key] = nn.init.trunc_normal_(torch.empty(shape), std=std,
                                            a=-2 * std, b=2 * std,
                                            generator=generator)
    return sd
