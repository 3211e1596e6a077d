"""MISA: modality-invariant and -specific representations (port of
``mertools_tpu/models/misa.py``).

Reference behavior (``MERBench/toolkit/models/misa.py:99-271``):
  * per-modality encoders -> project (Linear+ReLU+LayerNorm),
  * private (per-modality Linear+Sigmoid) and shared (one Linear+Sigmoid,
    weight-tied across modalities) spaces,
  * reconstruction: Linear(private+shared) vs the projected input (MSE/3),
  * diff loss: squared Frobenius norm of cross-correlation between
    column-centered, row-normalized pairs (norms are DETACHED), over 6 pairs,
  * CMD loss with 5 moments over the 3 shared pairs, /3,
  * fusion: stack 6 tokens -> 1 torch-style post-LN transformer layer
    (nhead=2, ffn 2048, its own dropout 0.1) -> concat -> Linear stack ->
    heads,
  * interloss = diff_weight*diff + sim_weight*cmd + recon_weight*recon.

Every LayerNorm is Flax's ``nn.LayerNorm()`` of the JAX package: eps 1e-6,
not torch's 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import FLAX_LN_EPS, Dropout, LSTMEncoder, MLPEncoder, SimpleClassifierHeads

def _mse(a, b):
    return ((a - b) ** 2).mean()


def diff_loss(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Orthogonality penalty with detached L2 norms (misa.py:37-62)."""
    x1 = x1 - x1.mean(dim=0, keepdim=True)
    x2 = x2 - x2.mean(dim=0, keepdim=True)
    n1 = torch.linalg.norm(x1, dim=1, keepdim=True).detach()
    n2 = torch.linalg.norm(x2, dim=1, keepdim=True).detach()
    x1 = x1 / (n1 + 1e-6)
    x2 = x2 / (n2 + 1e-6)
    return ((x1.T @ x2) ** 2).mean()


def cmd_loss(x1: torch.Tensor, x2: torch.Tensor, n_moments: int = 5) -> torch.Tensor:
    """Central moment discrepancy (misa.py:65-96)."""
    m1, m2 = x1.mean(dim=0), x2.mean(dim=0)
    s1, s2 = x1 - m1, x2 - m2

    def matchnorm(a, b):
        return torch.sqrt(((a - b) ** 2).sum())

    total = matchnorm(m1, m2)
    for k in range(2, n_moments + 1):
        total = total + matchnorm((s1 ** k).mean(dim=0), (s2 ** k).mean(dim=0))
    return total


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` (self-attention, no mask):
    query/key/value/out projections over ``num_heads`` heads, queries
    scaled by hd^-1/2, and dropout on the attention weights with one mask
    broadcast over batch and heads (Flax's ``broadcast_dropout``)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float):
        super().__init__()
        self.nh = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.nh

        def heads(lin):  # (B, S, D) -> (B, nh, S, hd)
            return lin(x).reshape(B, S, self.nh, hd).transpose(1, 2)

        q, k, v = heads(self.query) / hd ** 0.5, heads(self.key), heads(self.value)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        w = self.dropout(w, generator, shape=(1, 1, S, S))
        return self.out((w @ v).transpose(1, 2).reshape(B, S, D))


class TorchTransformerLayer(nn.Module):
    """Post-LN transformer encoder layer (torch nn.TransformerEncoderLayer
    defaults: ffn 2048, ReLU, dropout 0.1) on (S, B, D) like the
    reference."""

    def __init__(self, d_model: int, nhead: int = 2, dim_ff: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        drop = lambda y: self.dropout(y, generator)  # noqa: E731
        xb = x.transpose(0, 1)  # (B, S, D)
        xb = self.norm1(xb + drop(self.self_attn(xb, generator)))
        ff = self.linear2(drop(torch.relu(self.linear1(xb))))
        xb = self.norm2(xb + drop(ff))
        return xb.transpose(0, 1)


@registry.register_model("misa")
class MISA(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.3,
                 sim_weight: float = 0.1, diff_weight: float = 0.1,
                 recon_weight: float = 0.1, output_dim1: int = 6,
                 output_dim2: int = 1, feat_type: str = "utt"):
        super().__init__()
        H = hidden_dim
        self.weights = (diff_weight, sim_weight, recon_weight)
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, H, dropout)
        self.text_encoder = enc(text_dim, H, dropout)
        self.video_encoder = enc(video_dim, H, dropout)
        for m in "tva":
            setattr(self, f"project_{m}", nn.Linear(H, H))
            setattr(self, f"project_{m}_ln", nn.LayerNorm(H, eps=FLAX_LN_EPS))
            setattr(self, f"private_{m}", nn.Linear(H, H))
            setattr(self, f"recon_{m}", nn.Linear(H, H))
        self.shared = nn.Linear(H, H)  # weight-tied across modalities
        self.transformer = TorchTransformerLayer(H, nhead=2)
        self.fusion_layer_1 = nn.Linear(6 * H, 3 * H)
        self.dropout = Dropout(dropout)
        self.fusion_layer_3 = nn.Linear(3 * H, H // 2)
        self.heads = SimpleClassifierHeads(H // 2, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        u = {"a": self.audio_encoder(batch["audios"], generator),
             "t": self.text_encoder(batch["texts"], generator),
             "v": self.video_encoder(batch["videos"], generator)}
        o, p, s, r = {}, {}, {}, {}
        for m in "tva":
            o[m] = getattr(self, f"project_{m}_ln")(
                torch.relu(getattr(self, f"project_{m}")(u[m])))
            p[m] = torch.sigmoid(getattr(self, f"private_{m}")(o[m]))
            s[m] = torch.sigmoid(self.shared(o[m]))
            r[m] = getattr(self, f"recon_{m}")(p[m] + s[m])

        # fusion through one transformer layer over the 6 component tokens
        h = torch.stack([p["t"], p["v"], p["a"], s["t"], s["v"], s["a"]], dim=0)
        h = self.transformer(h, generator)  # (6, B, H)
        h = torch.cat(list(h), dim=1)  # (B, 6H)
        x = torch.relu(self.dropout(self.fusion_layer_1(h), generator))
        features = self.fusion_layer_3(x)

        emos_out, vals_out = self.heads(features)

        recon = sum(_mse(r[m], o[m]) for m in "tva") / 3.0
        diff = (diff_loss(p["t"], s["t"]) + diff_loss(p["v"], s["v"])
                + diff_loss(p["a"], s["a"]) + diff_loss(p["a"], p["t"])
                + diff_loss(p["a"], p["v"]) + diff_loss(p["t"], p["v"]))
        cmd = (cmd_loss(s["t"], s["v"]) + cmd_loss(s["t"], s["a"])
               + cmd_loss(s["a"], s["v"])) / 3.0
        diff_w, sim_w, recon_w = self.weights
        interloss = diff_w * diff + sim_w * cmd + recon_w * recon
        return features, emos_out, vals_out, interloss
