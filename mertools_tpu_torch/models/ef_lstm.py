"""EF_LSTM: early fusion — concat frame-aligned modalities + LSTM (port of
``mertools_tpu/models/ef_lstm.py``).

Reference behavior (``MER2024/toolkit/models/ef_lstm.py:11-56``): concat the
three aligned sequences on the feature axis, run a (possibly multi-layer)
LSTM, take the final hidden state of the last layer, dropout -> Linear+ReLU
-> dropout -> heads. Requires frame-aligned inputs.

The stack is one cuDNN ``nn.LSTM(num_layers=...)`` with every input-side
bias frozen at 0 (Flax's cells have one bias a gate). Dropout between
layers draws from the caller's generator, so in training with dropout the
layers run one ``torch.lstm`` call each on the stack's own weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin, freeze_input_biases
from .modules import Dropout, SimpleClassifierHeads


@registry.register_model("ef_lstm")
class EF_LSTM(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.3, num_layers: int = 1,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        self.num_layers = num_layers
        self.lstm = freeze_input_biases(nn.LSTM(audio_dim + text_dim + video_dim, hidden_dim,
                                         num_layers=num_layers, batch_first=True))
        self.dropout = Dropout(dropout)
        self.linear = nn.Linear(hidden_dim, hidden_dim)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    def _stack(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The last layer's final hidden state (B, H)."""
        if not self.training or self.dropout.p == 0.0 or self.num_layers == 1:
            _, (h_n, _) = self.lstm(x)
            return h_n[-1]
        for k in range(self.num_layers):
            w = [getattr(self.lstm, f"{n}_l{k}")
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            x, h_n, _ = torch.lstm(x, (x.new_zeros(1, x.shape[0], self.lstm.hidden_size),) * 2,
                                   w, True, 1, 0.0, True, False, True)
            if k + 1 < self.num_layers:
                x = self.dropout(x, generator)
        return h_n[0]

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        x = torch.cat([batch["texts"], batch["audios"], batch["videos"]], dim=-1)
        h = self.dropout(self._stack(x, generator), generator)
        h = torch.relu(self.linear(h))
        features = self.dropout(h, generator)

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
