"""MMIM: hierarchical mutual-information maximization fusion (port of
``mertools_tpu/models/mmim.py``).

Reference behavior (``MERBench/toolkit/models/mmim.py``): per-modality
encoders; two MMILB modules give a Gaussian log-likelihood lower bound
lld(text->vision) + lld(text->audio) (the label/memory entropy path is unused
in the reference forward, mmim.py:232-238); fusion = dropout + 2 tanh Linear
over the concat; three CPC heads give an InfoNCE score between each modality
encoding and the fusion; interloss = alpha * nce - beta * lld.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin
from .modules import Dropout, LSTMEncoder, MLPEncoder, SimpleClassifierHeads


class MMILB(nn.Module):
    """Gaussian-prior modality MI lower bound (mmim.py:12-55, lld path)."""

    def __init__(self, x_size: int, y_size: int):
        super().__init__()
        self.mu_1 = nn.Linear(x_size, y_size)
        self.mu_2 = nn.Linear(y_size, y_size)
        self.logvar_1 = nn.Linear(x_size, y_size)
        self.logvar_2 = nn.Linear(y_size, y_size)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mu = self.mu_2(torch.relu(self.mu_1(x)))
        logvar = self.logvar_2(torch.relu(self.logvar_1(x)))
        positive = -((mu - y) ** 2) / 2.0 / torch.exp(logvar)
        return positive.sum(dim=-1).mean()


class CPC(nn.Module):
    """InfoNCE score between x and a prediction of x from y (mmim.py:93-131);
    a tanh follows the first of several layers only."""

    def __init__(self, x_size: int, y_size: int, n_layers: int = 1):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"net_{i}", nn.Linear(y_size if i == 0 else x_size, x_size))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = y
        for i in range(self.n_layers):
            h = getattr(self, f"net_{i}")(h)
            if self.n_layers > 1 and i == 0:
                h = torch.tanh(h)
        x_pred = h / torch.linalg.norm(h, dim=1, keepdim=True)
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        pos = (x * x_pred).sum(dim=-1)
        neg = torch.logsumexp(x @ x_pred.T, dim=-1)
        return -(pos - neg).mean()


@registry.register_model("mmim")
class MMIM(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.1, cpc_layers: int = 1,
                 alpha: float = 0.1, beta: float = 0.1,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "utt"):
        super().__init__()
        H = hidden_dim
        self.alpha, self.beta = alpha, beta
        enc = MLPEncoder if feat_type == "utt" else LSTMEncoder
        self.audio_encoder = enc(audio_dim, H, dropout)
        self.text_encoder = enc(text_dim, H, dropout)
        self.video_encoder = enc(video_dim, H, dropout)
        self.mi_tv = MMILB(H, H)
        self.mi_ta = MMILB(H, H)
        self.dropout = Dropout(dropout)
        self.fusion_1 = nn.Linear(3 * H, H)
        self.fusion_2 = nn.Linear(H, H)
        self.cpc_zt = CPC(H, H, cpc_layers)
        self.cpc_zv = CPC(H, H, cpc_layers)
        self.cpc_za = CPC(H, H, cpc_layers)
        self.heads = SimpleClassifierHeads(H, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        audio_h = self.audio_encoder(batch["audios"], generator)
        text_h = self.text_encoder(batch["texts"], generator)
        vision_h = self.video_encoder(batch["videos"], generator)

        lld = self.mi_tv(text_h, vision_h) + self.mi_ta(text_h, audio_h)

        x = self.dropout(torch.cat([text_h, audio_h, vision_h], dim=1), generator)
        x = torch.tanh(self.fusion_1(x))
        fusion = torch.tanh(self.fusion_2(x))

        nce = (self.cpc_zt(text_h, fusion) + self.cpc_zv(vision_h, fusion)
               + self.cpc_za(audio_h, fusion))

        emos_out, vals_out = self.heads(fusion)
        return fusion, emos_out, vals_out, self.alpha * nce - self.beta * lld
