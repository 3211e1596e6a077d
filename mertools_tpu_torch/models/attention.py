"""Attention fusion: per-modality encoders + learned modality weights (port
of ``mertools_tpu/models/attention.py``).

Reference: ``MERBench/toolkit/models/attention.py:8-57`` — MLP (utt) or LSTM
(frm) encoders per modality; concat -> MLP -> 3 modality scores (NO softmax,
by reference design) -> weighted sum of the modality encodings -> heads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import LSTMEncoder, MLPEncoder, SimpleClassifierHeads


@registry.register_model("attention")
class Attention(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.3,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "utt"):
        super().__init__()
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, hidden_dim, dropout)
        self.text_encoder = enc(text_dim, hidden_dim, dropout)
        self.video_encoder = enc(video_dim, hidden_dim, dropout)
        self.attention_mlp = MLPEncoder(3 * hidden_dim, hidden_dim, dropout)
        self.fc_att = nn.Linear(hidden_dim, 3)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        """-> (features, emos_out, vals_out, interloss)."""
        audio_h = self.audio_encoder(batch["audios"], generator)
        text_h = self.text_encoder(batch["texts"], generator)
        video_h = self.video_encoder(batch["videos"], generator)

        concat = torch.cat([audio_h, text_h, video_h], dim=1)  # (B, 3H)
        att = self.fc_att(self.attention_mlp(concat, generator))  # (B, 3), unnormalized

        stacked = torch.stack([audio_h, text_h, video_h], dim=2)  # (B, H, 3)
        features = torch.einsum("bhm,bm->bh", stacked, att)

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
