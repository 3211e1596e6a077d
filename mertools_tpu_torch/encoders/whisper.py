"""Whisper (encoder + decoder) in PyTorch — port of ``mertools_tpu/encoders/whisper.py``.

Two reference roles:
  1. audio features: the reference feeds [1, 80, 3000] log-mels plus a 2-token
     decoder stub and keeps the decoder ``last_hidden_state``
     (``extract_audio_huggingface.py:83-91``) -> (2, D) per clip;
  2. ASR transcripts through the KV-cached greedy decoder (``asr/decode.py``).

Pre-LN transformer both sides (LayerNorm eps 1e-5, exact GELU); encoder conv
stem (k3 gelu, k3 stride-2 gelu) on the (B, 80, 3000) mel, which is already
``nn.Conv1d``'s NCW layout, plus positions stored as weights; decoder with
learned positions, causal self-attention (bias -1e30) and cross-attention.
q is scaled by hd**-0.5 after its biased projection; k has no bias. The
attention is the plain einsum/softmax of the JAX module: the JAX Whisper
path calls no Pallas kernel. Parameters carry HF ``WhisperModel``
state-dict key names.
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

LN_EPS = 1e-5  # torch's default, and the JAX modules' epsilon
# transformers' class defaults of the keys ``WhisperConfig.from_hf`` reads
HF_CLASS_DEFAULTS = {"whisper": dict(
    d_model=384, encoder_layers=4, decoder_layers=4, encoder_attention_heads=6,
    encoder_ffn_dim=1536, num_mel_bins=80, max_source_positions=1500,
    max_target_positions=448, vocab_size=51865, decoder_start_token_id=50257,
    eos_token_id=50256)}


@dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257

    @classmethod
    def large_v2(cls):
        """``openai/whisper-large-v2`` geometry (its published config.json)."""
        return cls(d_model=1280, encoder_layers=32, decoder_layers=32,
                   num_heads=20, ffn_dim=5120)

    @classmethod
    def from_config_json(cls, raw: dict) -> "WhisperConfig":
        """From a checkpoint's ``config.json`` dict, every key it lacks
        taken from ``transformers``' class defaults."""
        return cls.from_hf(SimpleNamespace(**with_class_defaults(raw, HF_CLASS_DEFAULTS)))

    @classmethod
    def from_hf(cls, hf):
        return cls(d_model=hf.d_model, encoder_layers=hf.encoder_layers,
                   decoder_layers=hf.decoder_layers,
                   num_heads=hf.encoder_attention_heads,
                   ffn_dim=hf.encoder_ffn_dim, num_mel_bins=hf.num_mel_bins,
                   max_source_positions=hf.max_source_positions,
                   max_target_positions=hf.max_target_positions,
                   vocab_size=hf.vocab_size,
                   decoder_start_token_id=hf.decoder_start_token_id,
                   eos_token_id=hf.eos_token_id)


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        H = cfg.d_model
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H, bias=False)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def split(self, y: torch.Tensor) -> torch.Tensor:
        """(..., H) -> (..., nh, hd)."""
        return y.unflatten(-1, (self.num_heads, -1))

    def query(self, x: torch.Tensor) -> torch.Tensor:
        q = self.split(self.q_proj(x))
        return q * (q.shape[-1] ** -0.5)

    def forward(self, x, kv, bias=None):
        """x: (B, S, H) queries, kv: (B, T, H) -> (B, S, H)."""
        q = self.query(x)
        k, v = self.split(self.k_proj(kv)), self.split(self.v_proj(kv))
        logits = torch.einsum("bqnd,bknd->bnqk", q, k)
        if bias is not None:
            logits = logits + bias
        out = torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.flatten(-2))


class _Mlp(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def mlp(self, x):
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperEncoderLayer(_Mlp):
    def __init__(self, cfg: WhisperConfig):
        super().__init__(cfg)
        self.self_attn = WhisperAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, x):
        h = self.self_attn_layer_norm(x)
        return self.mlp(x + self.self_attn(h, h))


class WhisperDecoderLayer(_Mlp):
    def __init__(self, cfg: WhisperConfig):
        super().__init__(cfg)
        self.self_attn = WhisperAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.encoder_attn = WhisperAttention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def forward(self, x, enc, causal_bias):
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, causal_bias)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), enc)
        return self.mlp(x)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, D, 3, padding=1)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, D)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, 80, 3000) -> (B, 1500, D)."""
        x = F.gelu(self.conv2(F.gelu(self.conv1(mel)))).transpose(1, 2)
        x = x + self.embed_positions.weight[: x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, D)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S); enc: (B, T, D) -> (B, S, D) last hidden."""
        S = input_ids.shape[1]
        x = self.embed_tokens(input_ids) + self.embed_positions.weight[:S]
        pos = torch.arange(S, device=x.device)
        causal = torch.where(pos[:, None] >= pos[None, :], 0.0, -1e30).to(x.dtype)
        for layer in self.layers:
            x = layer(x, enc, causal)
        return self.layer_norm(x)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    def forward(self, mel, decoder_input_ids):
        return self.decode(decoder_input_ids, self.encode(mel))

    def encode(self, mel):
        return self.encoder(mel)

    def decode(self, input_ids, enc):
        return self.decoder(input_ids, enc)


def build_model(cfg: WhisperConfig, params: dict, device) -> WhisperModel:
    """A :class:`WhisperModel` on ``device`` holding the state dict
    ``params`` (no second copy where the tensors already lie there)."""
    with torch.device("meta"):
        model = WhisperModel(cfg)
    model.load_state_dict(params, strict=True, assign=True)
    return model.to(device).eval()


def whisper_logits(model: WhisperModel, mel, decoder_input_ids) -> torch.Tensor:
    """Tied-embedding LM head (proj_out = embed_tokens.T): (B, S, vocab)."""
    h = model(mel, decoder_input_ids)
    return torch.einsum("bsd,vd->bsv", h, model.decoder.embed_tokens.weight)


# ---------------------------------------------------------------------------
# parameters: HF checkpoints, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
def load_hf_state_dict(sd: dict) -> dict:
    """HF ``WhisperModel`` state dict, or ``WhisperForConditionalGeneration``'s
    (``model.`` prefix; its ``proj_out`` is the tied embedding and is
    dropped) -> this module's state dict. Load it with ``strict=True``."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    return dict(sd)


def state_dict_from_flax(cfg: WhisperConfig, params) -> dict:
    """The JAX package's Flax param tree (numpy-convertible leaves) -> this
    module's state dict; the inverse of ``convert_torch_state``
    (``mertools_tpu/encoders/whisper.py:182-232``)."""
    sd: dict = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)      # (in,out)->(out,in)
        if "bias" in p:
            sd[f"{key}.bias"] = t(p["bias"])

    def ln(key, p):
        sd[f"{key}.weight"] = t(p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    def attn(key, p, name):
        for proj in ("q", "k", "v", "out"):
            dense(f"{key}.{proj}_proj", p[f"{name}_{proj}"])

    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        sd[f"encoder.{c}.weight"] = t(np.asarray(enc[c]["kernel"]).transpose(2, 1, 0))
        sd[f"encoder.{c}.bias"] = t(enc[c]["bias"])
    sd["encoder.embed_positions.weight"] = t(enc["embed_positions"])
    ln("encoder.layer_norm", enc["layer_norm"])
    for i in range(cfg.encoder_layers):
        p, pre = enc[f"layer_{i}"], f"encoder.layers.{i}"
        attn(f"{pre}.self_attn", p, "self_attn")
        ln(f"{pre}.self_attn_layer_norm", p["self_attn_layer_norm"])
        ln(f"{pre}.final_layer_norm", p["final_layer_norm"])
        dense(f"{pre}.fc1", p["fc1"])
        dense(f"{pre}.fc2", p["fc2"])

    sd["decoder.embed_tokens.weight"] = t(dec["embed_tokens"]["embedding"])
    sd["decoder.embed_positions.weight"] = t(dec["embed_positions"])
    ln("decoder.layer_norm", dec["layer_norm"])
    for i in range(cfg.decoder_layers):
        p, pre = dec[f"layer_{i}"], f"decoder.layers.{i}"
        attn(f"{pre}.self_attn", p, "self_attn")
        attn(f"{pre}.encoder_attn", p, "encoder_attn")
        for n in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                  "final_layer_norm"):
            ln(f"{pre}.{n}", p[n])
        dense(f"{pre}.fc1", p["fc1"])
        dense(f"{pre}.fc2", p["fc2"])
    return sd


def init_params(cfg: WhisperConfig, generator: torch.Generator) -> dict:
    """Random state dict with the JAX modules' initialisers, on the
    generator's device: lecun-normal (truncated at two standard deviations)
    Linear and Conv1d kernels with fan_in = in_features or in_channels *
    kernel, zero biases, unit LayerNorm scales, normal(1/sqrt(D)) token
    embeddings (Flax ``nn.Embed``), zero position tables (the JAX modules
    declare both with a zeros initialiser). The draws differ from JAX's
    (another generator); the scales match through every layer."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in WhisperModel(cfg).state_dict().items()}
    dev = generator.device
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("embed_positions.weight") or key.endswith(".bias"):
            sd[key] = torch.zeros(shape, device=dev)
        elif key == "decoder.embed_tokens.weight":
            sd[key] = torch.randn(shape, generator=generator, device=dev) \
                * cfg.d_model ** -0.5
        elif len(shape) == 1:                      # LayerNorm scale
            sd[key] = torch.ones(shape, device=dev)
        else:  # Linear (out, in) or Conv1d (out, in, k) kernel
            std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
            sd[key] = nn.init.trunc_normal_(torch.empty(shape, device=dev),
                                            std=std, a=-2 * std, b=2 * std,
                                            generator=generator)
    return sd
