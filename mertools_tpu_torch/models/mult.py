"""MULT: Multimodal Transformer (pairwise directional crossmodal attention;
port of ``mertools_tpu/models/mult.py``).

Reference behavior (``MERBench/toolkit/models/mult.py`` + custom stack in
``modules/transformers_encoder/``):
  * per-modality Conv1d (VALID padding, no bias) to hidden_dim,
  * 6 crossmodal transformers (q from one modality, k/v from another) with
    pre-LN layers, inputs scaled by sqrt(H), ReLU FFN of width 4H, final LN,
  * an "offset-causal" mask: query i may attend key j iff
    j <= i + |T_k - T_q| (transformer.py buffered_future_mask),
  * 3 self-attention "mem" transformers (width 2H, >=3 layers) over the
    concatenated pair outputs; take the LAST timestep,
  * concat the three last states (6H) -> residual Linear block -> out layer
    (H // 2) -> heads.

The attention is plain ``torch.matmul``/softmax, as the JAX package computes
it outside any kernel. LayerNorms use Flax's eps 1e-6.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import FLAX_LN_EPS, Dropout, SimpleClassifierHeads

@functools.lru_cache(maxsize=64)
def offset_causal_bias(t_q: int, t_k: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(T_q, T_k) additive bias: 0 where j <= i + |T_k - T_q|, else -inf.
    Cached: every layer of a batch asks for the same few shapes."""
    i = torch.arange(t_q, device=device)[:, None]
    j = torch.arange(t_k, device=device)[None, :]
    allowed = j <= i + abs(t_k - t_q)
    return torch.zeros((t_q, t_k), dtype=dtype, device=device).masked_fill(
        ~allowed, float("-inf"))


class MaskedMHA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, attn_dropout: float):
        super().__init__()
        self.nh = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = Dropout(attn_dropout)

    def forward(self, q, k, v, generator=None, masked: bool = True):
        B, Tq, H = q.shape
        hd = H // self.nh

        def heads(lin, x):  # (B, T, H) -> (B, nh, T, hd)
            return lin(x).reshape(B, x.shape[1], self.nh, hd).transpose(1, 2)

        qh = heads(self.q_proj, q) * hd ** -0.5
        logits = qh @ heads(self.k_proj, k).transpose(-1, -2)  # (B, nh, Tq, Tk)
        if masked:
            logits = logits + offset_causal_bias(Tq, k.shape[1], logits.dtype, logits.device)
        w = self.dropout(torch.softmax(logits, dim=-1), generator)
        out = (w @ heads(self.v_proj, v)).transpose(1, 2).reshape(B, Tq, H)
        return self.out_proj(out)


class CrossmodalTransformer(nn.Module):
    """Pre-LN transformer stack over (B, T, H); optional cross k/v source.
    Layer ``li``'s modules carry Flax's names (``ln1_{li}``, ``attn_{li}``,
    ...)."""

    def __init__(self, embed_dim: int, num_heads: int, layers: int,
                 dropout: float, cross: bool):
        super().__init__()
        self.layers, self.cross = layers, cross
        self.scale = math.sqrt(embed_dim)
        self.dropout = Dropout(dropout)
        for li in range(layers):
            setattr(self, f"ln1_{li}", nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS))
            if cross:
                setattr(self, f"ln1kv_{li}", nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS))
            setattr(self, f"attn_{li}", MaskedMHA(embed_dim, num_heads, dropout))
            setattr(self, f"ln2_{li}", nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS))
            setattr(self, f"fc1_{li}", nn.Linear(embed_dim, 4 * embed_dim))
            setattr(self, f"fc2_{li}", nn.Linear(4 * embed_dim, embed_dim))
        self.ln_final = nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS)

    def forward(self, x, x_kv=None, generator=None):
        drop = lambda y: self.dropout(y, generator)  # noqa: E731
        x = drop(self.scale * x)
        if x_kv is not None:
            x_kv = drop(self.scale * x_kv)
        for li in range(self.layers):
            layer = lambda name: getattr(self, f"{name}_{li}")  # noqa: E731
            xn = layer("ln1")(x)
            kvn = xn if x_kv is None else layer("ln1kv")(x_kv)
            x = x + drop(layer("attn")(xn, kvn, kvn, generator))
            ff = torch.relu(layer("fc1")(layer("ln2")(x)))
            x = x + drop(layer("fc2")(drop(ff)))
        return self.ln_final(x)


@registry.register_model("mult")
class MULT(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, num_heads: int = 8, layers: int = 4,
                 dropout: float = 0.1, conv1d_kernel_size: int = 3,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        H = hidden_dim
        for m, d in (("l", text_dim), ("a", audio_dim), ("v", video_dim)):
            setattr(self, f"proj_{m}", nn.Conv1d(d, H, conv1d_kernel_size, bias=False))
        for q in "lav":
            for kv in "lav".replace(q, ""):
                setattr(self, f"trans_{q}_with_{kv}",
                        CrossmodalTransformer(H, num_heads, layers, dropout, cross=True))
            setattr(self, f"trans_{q}_mem",
                    CrossmodalTransformer(2 * H, num_heads, max(layers, 3), dropout,
                                          cross=False))
        self.proj1 = nn.Linear(6 * H, 6 * H)
        self.proj2 = nn.Linear(6 * H, 6 * H)
        self.dropout = Dropout(dropout)
        self.out_layer = nn.Linear(6 * H, H // 2)
        self.heads = SimpleClassifierHeads(H // 2, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        # (B, T, D) -> Conv1d over time, VALID -> (B, T - K + 1, H)
        x = {m: getattr(self, f"proj_{m}")(batch[key].transpose(1, 2)).transpose(1, 2)
             for m, key in (("l", "texts"), ("a", "audios"), ("v", "videos"))}
        last = []
        for q in "lav":
            pair = [getattr(self, f"trans_{q}_with_{kv}")(x[q], x[kv], generator)
                    for kv in "lav".replace(q, "")]
            mem = getattr(self, f"trans_{q}_mem")(torch.cat(pair, dim=2), None, generator)
            last.append(mem[:, -1])
        last_hs = torch.cat(last, dim=1)  # (B, 6H)

        x = self.dropout(torch.relu(self.proj1(last_hs)), generator)
        features = self.out_layer(self.proj2(x) + last_hs)

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
