"""LF_DNN: late fusion — unimodal encoders + concat + MLP (port of
``mertools_tpu/models/lf_dnn.py``).

Reference behavior: ``MER2024/toolkit/models/lf_dnn.py:12-30``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import Dropout, LSTMEncoder, MLPEncoder, SimpleClassifierHeads


@registry.register_model("lf_dnn")
class LF_DNN(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.3,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "utt"):
        super().__init__()
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, hidden_dim, dropout)
        self.text_encoder = enc(text_dim, hidden_dim, dropout)
        self.video_encoder = enc(video_dim, hidden_dim, dropout)
        self.dropout = Dropout(dropout)
        self.post_fusion_layer_1 = nn.Linear(3 * hidden_dim, hidden_dim)
        self.post_fusion_layer_2 = nn.Linear(hidden_dim, hidden_dim)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        audio_h = self.audio_encoder(batch["audios"], generator)
        text_h = self.text_encoder(batch["texts"], generator)
        video_h = self.video_encoder(batch["videos"], generator)

        x = self.dropout(torch.cat([audio_h, video_h, text_h], dim=-1), generator)
        x = torch.relu(self.post_fusion_layer_1(x))
        features = torch.relu(self.post_fusion_layer_2(x))

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
