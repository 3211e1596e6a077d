"""Shared fusion-model building blocks (port of ``mertools_tpu/models/modules.py``).

Reference counterparts in ``MERBench/toolkit/models/modules/encoder.py:9-72``:
  * :class:`MLPEncoder`  — dropout, then three Linear+ReLU layers.
  * :class:`LSTMEncoder` — single-layer LSTM; the *final hidden state* is the
    encoding (so inputs must be **front**-padded), then dropout + Linear.

Dropout draws its mask from the ``torch.Generator`` the caller passes, so a
run is reproducible from its seed; ``F.dropout`` takes no generator.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator: in training mode each
    element is kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``
    (Flax's ``nn.Dropout``); in eval mode, or at ``p == 0``, the identity."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class MLPEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.dense_1 = nn.Linear(in_dim, hidden_dim)
        self.dense_2 = nn.Linear(hidden_dim, hidden_dim)
        self.dense_3 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        x = self.dropout(x, generator)
        for dense in (self.dense_1, self.dense_2, self.dense_3):
            x = torch.relu(dense(x))
        return x


class LSTMEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(in_dim, hidden_dim, batch_first=True)
        # Flax's cell has one bias a gate (on the recurrent side): the
        # input-side bias stays 0, or the gate bias would learn twice as fast
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """x: (B, T, D) front-padded -> (B, hidden_dim) from the final step."""
        _, (h_n, _) = self.lstm(x)
        return self.fc(self.dropout(h_n[-1], generator))


class SimpleClassifierHeads(nn.Module):
    """The (emotion, valence) output-head pair every fusion model ends with;
    a head of width 0 is absent and gives a (B, 0) output."""

    def __init__(self, in_dim: int, output_dim1: int, output_dim2: int):
        super().__init__()
        self.fc_out_1 = nn.Linear(in_dim, output_dim1) if output_dim1 > 0 else None
        self.fc_out_2 = nn.Linear(in_dim, output_dim2) if output_dim2 > 0 else None

    def forward(self, features: torch.Tensor):
        empty = features.new_zeros(features.shape[:1] + (0,))
        emos_out = self.fc_out_1(features) if self.fc_out_1 is not None else empty
        vals_out = self.fc_out_2(features) if self.fc_out_2 is not None else empty
        return emos_out, vals_out
