"""Graph_MFN: MFN with a Dynamic Fusion Graph instead of the attention block
(port of ``mertools_tpu/models/graph_mfn.py``).

Reference behavior (``MERBench/toolkit/models/graph_mfn.py``): per step, each
modality's (prev_h, new_h) pair passes a ReLU transform to a singleton node;
the DFG builds every 2-subset and the 3-subset node, scaling each incoming
vertex by a learned per-sample efficacy (19 efficacies for 3 modalities,
inner node width 100); the top node t_output drives the MFN-style memory
gates. Final features as in MFN. The recurrence is a per-step loop with
fresh dropout masks a step, as in :mod:`.mfn`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin, freeze_input_biases
from .mfn import gate_memory, run_steps
from .modules import Dropout, SimpleClassifierHeads, lstm_step

_INNER = 100  # hardcoded pattern/efficacy inner width (graph_mfn.py:137-139)
_PAIRS = [(0, 1), (0, 2), (1, 2)]


class DynamicFusionGraph3(nn.Module):
    """3-modality DFG. Input: three (B, H) singletons -> (B, H) top node."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        H = hidden_dim
        self.efficacy_1 = nn.Linear(3 * H, _INNER)
        self.efficacy_2 = nn.Linear(_INNER, H)
        self.efficacy_3 = nn.Linear(H, 19)  # 6 pair + 6 triple + 7 top
        for n_in, name in [(2, f"{a}{b}") for a, b in _PAIRS] + [(6, "012")]:
            setattr(self, f"net_{name}_1", nn.Linear(n_in * H, _INNER))
            setattr(self, f"net_{name}_2", nn.Linear(_INNER, H))
        self.t_network_1 = nn.Linear(7 * H, _INNER)
        self.t_network_2 = nn.Linear(_INNER, H)

    def forward(self, s0, s1, s2):
        eff = self.efficacy_3(self.efficacy_2(self.efficacy_1(torch.cat([s0, s1, s2], dim=1))))
        outputs = {0: s0, 1: s1, 2: s2}
        k = 0

        def node(members, name):
            inp = torch.cat([outputs[m] * eff[:, k + j, None]
                             for j, m in enumerate(members)], dim=1)
            return getattr(self, f"{name}_2")(getattr(self, f"{name}_1")(inp))

        for pair in _PAIRS:  # each consumes its 2 singletons
            outputs[pair] = node(pair, f"net_{pair[0]}{pair[1]}")
            k += 2
        # the triple node consumes the 3 singletons + 3 pair nodes
        outputs[(0, 1, 2)] = node([0, 1, 2] + _PAIRS, "net_012")
        k += 6
        return node([0, 1, 2] + _PAIRS + [(0, 1, 2)], "t_network")


class GraphMFNStep(nn.Module):
    def __init__(self, dims, hidden_dim: int, mem_dim: int, dropout: float):
        super().__init__()
        H = hidden_dim
        for m, d in zip("lav", dims):
            setattr(self, f"lstm_{m}", nn.LSTMCell(d, H))
            setattr(self, f"{m}_transform", nn.Linear(2 * H, H))
        freeze_input_biases(self)
        self.graph = DynamicFusionGraph3(H)
        self.att2_fc1 = nn.Linear(H, H)
        self.att2_fc2 = nn.Linear(H, mem_dim)
        for g in ("gamma1", "gamma2"):
            setattr(self, f"{g}_fc1", nn.Linear(H + mem_dim, H))
            setattr(self, f"{g}_fc2", nn.Linear(H, mem_dim))
        self.dropout = Dropout(dropout)

    def forward(self, carry, xs, generator=None):
        *cells, mem = carry
        new = [lstm_step(getattr(self, f"lstm_{m}"), c, x)
               for m, c, x in zip("lav", cells, xs)]
        singles = [torch.relu(getattr(self, f"{m}_transform")(torch.cat([h, nh], dim=1)))
                   for m, (_, h), (_, nh) in zip("lav", cells, new)]
        attended = self.graph(*singles)

        drop = lambda x: self.dropout(x, generator)  # noqa: E731
        chat = torch.tanh(self.att2_fc2(drop(torch.relu(self.att2_fc1(attended)))))
        return (*new, gate_memory(self, attended, mem, chat, drop))


@registry.register_model("graph_mfn")
class GraphMFN(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, mem_dim: int = 128, dropout: float = 0.3,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        self.hidden_dim, self.mem_dim = hidden_dim, mem_dim
        self.step = GraphMFNStep((text_dim, audio_dim, video_dim), hidden_dim,
                                 mem_dim, dropout)
        self.out_fc1 = nn.Linear(3 * hidden_dim + mem_dim, hidden_dim)
        self.dropout = Dropout(dropout)
        self.out_fc2 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.heads = SimpleClassifierHeads(hidden_dim // 2, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        (_, h_l), (_, h_a), (_, h_v), mem = run_steps(
            self.step, batch, self.hidden_dim, self.mem_dim, generator)
        last_hs = torch.cat([h_l, h_a, h_v, mem], dim=1)
        x = self.dropout(torch.relu(self.out_fc1(last_hs)), generator)
        features = self.out_fc2(x)

        emos_out, vals_out = self.heads(features)
        return features, emos_out, vals_out, features.new_zeros(())
