"""Shared fusion-model building blocks (port of ``mertools_tpu/models/modules.py``).

Reference counterparts in ``MERBench/toolkit/models/modules/encoder.py:9-72``:
  * :class:`MLPEncoder`  — dropout, then three Linear+ReLU layers.
  * :class:`LSTMEncoder` — single-layer LSTM; the *final hidden state* is the
    encoding (so inputs must be **front**-padded), then dropout + Linear.

:func:`lstm_step` is one step of a Flax ``OptimizedLSTMCell`` on an
``nn.LSTMCell`` (carry ``(c, h)`` as Flax orders it), for the recurrences
whose steps interleave with other layers (MFN, Graph-MFN, MFM's and MCTN's
decoders).

Dropout draws its mask from the ``torch.Generator`` the caller passes, so a
run is reproducible from its seed; ``F.dropout`` takes no generator.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import freeze_input_biases


# Flax's nn.LayerNorm eps, which the JAX package's zoo uses (torch's is 1e-5)
FLAX_LN_EPS = 1e-6


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator: in training mode each
    element is kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``
    (Flax's ``nn.Dropout``); in eval mode, or at ``p == 0``, the identity."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                shape: tuple[int, ...] | None = None) -> torch.Tensor:
        """``shape``: draw one mask of that shape and broadcast it over
        ``x`` (Flax's ``broadcast_dropout`` of attention weights)."""
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        # one Bernoulli draw scaled in place, then one product: three
        # kernels a call, which the zoo's per-step loops make by the thousand
        keep = x.new_empty(shape or x.shape).bernoulli_(1.0 - self.p, generator=generator)
        return x * keep.mul_(1.0 / (1.0 - self.p))


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
        self.lstm = freeze_input_biases(nn.LSTM(in_dim, hidden_dim, batch_first=True))
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """x: (B, T, D) front-padded -> (B, hidden_dim) from the final step."""
        _, (h_n, _) = self.lstm(x)
        return self.fc(self.dropout(h_n[-1], generator))


def lstm_step(cell: nn.LSTMCell, carry: tuple[torch.Tensor, torch.Tensor] | None,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of ``cell`` from ``carry`` = (c, h) (None: zeros) on ``x``
    (B, in) -> the new (c, h)."""
    h, c = cell(x, None if carry is None else (carry[1], carry[0]))
    return c, h


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
