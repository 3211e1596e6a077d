"""Attention_TOPN: attention fusion over N (<=18) feature sets (port of
``mertools_tpu/models/attention_topn.py``).

Reference behavior (``MER2024/toolkit/models/attention_topn.py:8-63``): one
MLP encoder per feature set, concat -> attention MLP -> N weights (no
softmax) -> weighted sum -> heads. The batch carries the feature sets as
``feat0..feat{N-1}``; the widths come from the top-N dataset's
``feat_dims``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.config import Args
from ..core.registry import registry
from .modules import MLPEncoder, SimpleClassifierHeads


@registry.register_model("attention_topn")
class AttentionTopN(nn.Module):
    def __init__(self, feat_dims: Sequence[int], hidden_dim: int = 128,
                 dropout: float = 0.3, output_dim1: int = 6, output_dim2: int = 1):
        super().__init__()
        self.n = len(feat_dims)
        if self.n < 1:
            raise ValueError("attention_topn needs at least one feature set")
        for i, d in enumerate(feat_dims):
            setattr(self, f"encoder{i}", MLPEncoder(d, hidden_dim, dropout))
        self.attention_mlp = MLPEncoder(self.n * hidden_dim, hidden_dim, dropout)
        self.fc_att = nn.Linear(hidden_dim, self.n)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    @classmethod
    def from_args(cls, args: Args, dims: Sequence[int]):
        """``dims``: one width a feature set (the dataset's ``feat_dims``)."""
        return cls(tuple(dims), hidden_dim=args.hidden_dim or 128,
                   dropout=args.dropout if args.dropout is not None else 0.3,
                   output_dim1=args.output_dim1 if args.output_dim1 is not None else 6,
                   output_dim2=args.output_dim2 if args.output_dim2 is not None else 1)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        hiddens = [getattr(self, f"encoder{i}")(batch[f"feat{i}"], generator)
                   for i in range(self.n)]
        att = self.fc_att(self.attention_mlp(torch.cat(hiddens, dim=1), generator))
        stacked = torch.stack(hiddens, dim=2)  # (B, H, N)
        features = torch.einsum("bhn,bn->bh", stacked, att)

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
