"""LMF: Low-rank Multimodal Fusion (port of ``mertools_tpu/models/lmf.py``).

Reference behavior (``MERBench/toolkit/models/lmf.py:11-92``): per-modality
encoders -> append constant 1 -> per-modality rank-R factor projections ->
elementwise product across modalities -> weighted sum over rank -> heads.
Output feature dim is hidden_dim // 2. The factors are raw parameters of
Flax's shapes, drawn ``xavier_normal`` as Flax draws them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.flax_init import xavier_normal_
from ..core.registry import registry
from .base import FromArgsMixin
from .modules import LSTMEncoder, MLPEncoder, SimpleClassifierHeads


@registry.register_model("lmf")
class LMF(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 64, dropout: float = 0.3, rank: int = 4,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "utt"):
        super().__init__()
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, hidden_dim, dropout)
        self.text_encoder = enc(text_dim, hidden_dim, dropout)
        self.video_encoder = enc(video_dim, hidden_dim, dropout)
        out_dim = hidden_dim // 2
        for name in ("audio_factor", "video_factor", "text_factor"):
            setattr(self, name, nn.Parameter(torch.empty(rank, hidden_dim + 1, out_dim)))
        self.fusion_weights = nn.Parameter(torch.empty(1, rank))
        self.fusion_bias = nn.Parameter(torch.zeros(1, out_dim))
        self.heads = SimpleClassifierHeads(out_dim, output_dim1, output_dim2)

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        for w in (self.audio_factor, self.video_factor, self.text_factor,
                  self.fusion_weights):
            xavier_normal_(w, generator)
        self.fusion_bias.zero_()

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        audio_h = self.audio_encoder(batch["audios"], generator)
        text_h = self.text_encoder(batch["texts"], generator)
        video_h = self.video_encoder(batch["videos"], generator)
        ones = audio_h.new_ones(audio_h.shape[:1] + (1,))

        def factor(w, h):  # (B, H+1) x (R, H+1, out) -> (R, B, out)
            return torch.einsum("bh,rho->rbo", torch.cat([ones, h], dim=1), w)

        fz = (factor(self.audio_factor, audio_h) * factor(self.video_factor, video_h)
              * factor(self.text_factor, text_h))
        features = torch.einsum("r,rbo->bo", self.fusion_weights[0], fz) + self.fusion_bias

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
