"""TFN: Tensor Fusion Network (outer-product fusion; port of
``mertools_tpu/models/tfn.py``).

Reference behavior (``MERBench/toolkit/models/tfn.py:11-82``): per-modality
MLP/LSTM encoders -> append a constant 1 to each hidden vector -> 3-way outer
product flattened to (H+1)^3 -> dropout -> two Linear+ReLU -> heads.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import Dropout, LSTMEncoder, MLPEncoder, SimpleClassifierHeads


@registry.register_model("tfn")
class TFN(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 64, dropout: float = 0.3,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "utt"):
        super().__init__()
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, hidden_dim, dropout)
        self.text_encoder = enc(text_dim, hidden_dim, dropout)
        self.video_encoder = enc(video_dim, hidden_dim, dropout)
        self.dropout = Dropout(dropout)
        self.post_fusion_layer_1 = nn.Linear((hidden_dim + 1) ** 3, hidden_dim)
        self.post_fusion_layer_2 = nn.Linear(hidden_dim, hidden_dim)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        audio_h = self.audio_encoder(batch["audios"], generator)
        text_h = self.text_encoder(batch["texts"], generator)
        video_h = self.video_encoder(batch["videos"], generator)

        ones = audio_h.new_ones(audio_h.shape[:1] + (1,))
        a = torch.cat([ones, audio_h], dim=1)  # (B, H+1)
        v = torch.cat([ones, video_h], dim=1)
        t = torch.cat([ones, text_h], dim=1)
        # 3-way outer product "bi,bj,bk->bijk", flattened: (B, (H+1)^3)
        fusion = (a[:, :, None, None] * v[:, None, :, None]
                  * t[:, None, None, :]).reshape(a.shape[0], -1)

        x = torch.relu(self.post_fusion_layer_1(self.dropout(fusion, generator)))
        features = torch.relu(self.post_fusion_layer_2(x))

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
