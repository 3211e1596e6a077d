"""MFN: Memory Fusion Network (delta-memory attention over 3 LSTMs; port of
``mertools_tpu/models/mfn.py``).

Reference behavior (``MERBench/toolkit/models/mfn.py:9-144``): one LSTM cell
per modality stepped in lockstep over aligned sequences; at each step the
previous+current cell states (cStar, 6H with window 2) pass through a
softmax attention MLP, the attended vector through a tanh MLP to a memory
candidate, and two sigmoid gates blend the running memory; the final hidden
states + memory feed an MLP to hidden_dim//2 features.

The JAX package's ``nn.scan`` is a per-step loop over :class:`MFNStep`
(its modules carry the scan body's Flax names under ``step``); each step
draws fresh dropout masks from the caller's generator, as the scan splits
its dropout key a step.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin, freeze_input_biases
from .modules import Dropout, SimpleClassifierHeads, lstm_step


class MFNStep(nn.Module):
    """One MFN step: ``carry`` = ((c_l, h_l), (c_a, h_a), (c_v, h_v), mem)."""

    def __init__(self, dims: tuple[int, int, int], hidden_dim: int, mem_dim: int,
                 dropout: float):
        super().__init__()
        H = hidden_dim
        for m, d in zip("lav", dims):
            setattr(self, f"lstm_{m}", nn.LSTMCell(d, H))
        freeze_input_biases(self)
        self.att1_fc1 = nn.Linear(6 * H, H)
        self.att1_fc2 = nn.Linear(H, 6 * H)
        self.att2_fc1 = nn.Linear(6 * H, H)
        self.att2_fc2 = nn.Linear(H, mem_dim)
        for g in ("gamma1", "gamma2"):
            setattr(self, f"{g}_fc1", nn.Linear(6 * H + mem_dim, H))
            setattr(self, f"{g}_fc2", nn.Linear(H, mem_dim))
        self.dropout = Dropout(dropout)

    def forward(self, carry, xs, generator=None):
        *cells, mem = carry
        new = [lstm_step(getattr(self, f"lstm_{m}"), c, x)
               for m, c, x in zip("lav", cells, xs)]
        c_star = torch.cat([c for c, _ in cells] + [c for c, _ in new], dim=1)  # (B, 6H)

        drop = lambda x: self.dropout(x, generator)  # noqa: E731
        att = drop(torch.relu(self.att1_fc1(c_star)))
        att = torch.softmax(self.att1_fc2(att), dim=1)
        attended = att * c_star

        chat = drop(torch.relu(self.att2_fc1(attended)))
        chat = torch.tanh(self.att2_fc2(chat))
        return (*new, gate_memory(self, attended, mem, chat, drop))


def gate_memory(step: nn.Module, attended, mem, chat, drop):
    """The two sigmoid gates that blend the running memory with the
    candidate ``chat`` (MFN and Graph-MFN)."""
    both = torch.cat([attended, mem], dim=1)
    g1 = torch.sigmoid(step.gamma1_fc2(drop(torch.relu(step.gamma1_fc1(both)))))
    g2 = torch.sigmoid(step.gamma2_fc2(drop(torch.relu(step.gamma2_fc1(both)))))
    return g1 * mem + g2 * chat


def run_steps(step: nn.Module, batch: dict, hidden_dim: int, mem_dim: int,
              generator=None):
    """Run ``step`` over the aligned (texts, audios, videos) sequences from
    a zero carry; returns the final carry."""
    xs = (batch["texts"], batch["audios"], batch["videos"])
    if not xs[0].shape[1] == xs[1].shape[1] == xs[2].shape[1]:
        raise ValueError("MFN requires frame-aligned inputs")
    B = xs[0].shape[0]
    zeros = lambda d: xs[0].new_zeros(B, d)  # noqa: E731
    carry = ((zeros(hidden_dim), zeros(hidden_dim)),) * 3 + (zeros(mem_dim),)
    for t in range(xs[0].shape[1]):
        carry = step(carry, [x[:, t] for x in xs], generator)
    return carry


class MFNBackbone(nn.Module):
    """Runs the MFN recurrence; returns (last_hs (B, 3H+mem), features).
    ``with_features=False`` leaves out the output MLP (MFM uses last_hs
    only; its parameters stay, as in the JAX package's tree)."""

    def __init__(self, dims, hidden_dim: int, mem_dim: int, dropout: float):
        super().__init__()
        self.hidden_dim, self.mem_dim = hidden_dim, mem_dim
        self.step = MFNStep(dims, hidden_dim, mem_dim, dropout)
        self.out_fc1 = nn.Linear(3 * hidden_dim + mem_dim, hidden_dim)
        self.dropout = Dropout(dropout)
        self.out_fc2 = nn.Linear(hidden_dim, hidden_dim // 2)

    def forward(self, batch: dict, generator=None, with_features: bool = True):
        (_, h_l), (_, h_a), (_, h_v), mem = run_steps(
            self.step, batch, self.hidden_dim, self.mem_dim, generator)
        last_hs = torch.cat([h_l, h_a, h_v, mem], dim=1)
        if not with_features:
            return last_hs, None
        x = self.dropout(torch.relu(self.out_fc1(last_hs)), generator)
        return last_hs, self.out_fc2(x)


@registry.register_model("mfn")
class MFN(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, mem_dim: int = 128, dropout: float = 0.3,
                 window_dim: int = 2, output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        if window_dim != 2:
            raise ValueError("reference cStar uses a prev+new window (=2)")
        self.backbone = MFNBackbone((text_dim, audio_dim, video_dim), hidden_dim,
                                    mem_dim, dropout)
        self.heads = SimpleClassifierHeads(hidden_dim // 2, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        _, features = self.backbone(batch, generator)
        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
