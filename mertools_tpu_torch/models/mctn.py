"""MCTN: Multimodal Cyclic Translation Network (port of
``mertools_tpu/models/mctn.py``).

Reference behavior (``MERBench/toolkit/models/mctn.py``): all modalities are
zero-padded on the feature axis to a common width D = max(dims). A shared
seq2seq (bi-LSTM encoder, attention LSTM decoder) translates text->vision and
then vision_hat->text; a second seq2seq translates the encoder join ->audio.
The classifier runs an LSTM encoder over the first seq2seq's join states.
interloss = loss_weight * (MSE(video_hat, video) + MSE(text_hat, text) +
MSE(audio_hat, audio)).

As in the JAX package: the recurrence runs over time (the reference's runs
over the batch axis), and teacher forcing is always on (the reference's
branch is a no-op), with ``outputs[:, 0]`` zero. The encoder is one
bidirectional cuDNN ``nn.LSTM`` (the JAX package's backward scan from a zero
carry, outputs in time order). Each decoder step runs a fresh bidirectional
LSTM on a length-1 input from a zero carry — two ``nn.LSTMCell`` steps
from zeros — and carries ``s = h_f + h_b`` into the next step's attention
only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin, freeze_input_biases
from .modules import Dropout, LSTMEncoder, SimpleClassifierHeads, lstm_step


class Seq2SeqEncoder(nn.Module):
    """Bidirectional LSTM; join = dropout(fwd+bwd outputs); s = tanh(fc(h_fwd
    + h_bwd)) (reference Encoder.forward)."""

    def __init__(self, in_dim: int, hidden: int, dropout: float):
        super().__init__()
        self.lstm = freeze_input_biases(nn.LSTM(in_dim, hidden, batch_first=True,
                                         bidirectional=True))
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(hidden, hidden, bias=False)

    def forward(self, x, generator=None):
        hs, (h_n, _) = self.lstm(x)  # (B, T, 2H), (2, B, H)
        H = h_n.shape[-1]
        join = self.dropout(hs[..., :H] + hs[..., H:], generator)
        s = torch.tanh(self.fc(h_n[0] + h_n[1]))
        return join, s  # (B, T, H), (B, H)


class DecoderStep(nn.Module):
    """One decoder step: attention over join, a bi-LSTM over a length-1
    input from a zero carry, prediction from (dec_output, context)
    (reference Decoder.forward)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden, hidden, bias=False)
        self.v = nn.Linear(hidden, 1, bias=False)
        self.fwd = nn.LSTMCell(in_dim + hidden, hidden)
        self.bwd = nn.LSTMCell(in_dim + hidden, hidden)
        freeze_input_biases(self)
        self.fc_out = nn.Linear(2 * hidden, out_dim)

    def forward(self, s, join, join_proj, trg_t):
        """``join_proj``: join's half of the attention projection, the same
        every step."""
        H = s.shape[-1]
        s_proj = F.linear(s, self.attn.weight[:, :H])
        energy = torch.tanh(s_proj[:, None, :] + join_proj)  # (B, T, H)
        a = torch.softmax(self.v(energy)[..., 0], dim=1)
        c = torch.einsum("bt,bth->bh", a, join)  # context
        rnn_in = torch.cat([trg_t, c], dim=1)
        dec_out = lstm_step(self.fwd, None, rnn_in)[1] + lstm_step(self.bwd, None, rnn_in)[1]
        return dec_out, self.fc_out(torch.cat([dec_out, c], dim=1))


class Seq2Seq(nn.Module):
    """Translate src (B, T, D_in) into trg (B, T, D_out) with always-on
    teacher forcing; step t consumes trg[t-1]; output[0] stays zero."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, dropout: float):
        super().__init__()
        self.encoder = Seq2SeqEncoder(in_dim, hidden, dropout)
        self.decoder = DecoderStep(out_dim, hidden, out_dim)

    def forward(self, src, trg, generator=None):
        join, s = self.encoder(src, generator)
        H = s.shape[-1]
        join_proj = F.linear(join, self.decoder.attn.weight[:, H:])
        preds = [trg.new_zeros(trg.shape[0], trg.shape[2])]
        for t in range(trg.shape[1] - 1):
            s, pred = self.decoder(s, join, join_proj, trg[:, t])
            preds.append(pred)
        return join, torch.stack(preds, dim=1)  # (B, T, D_out)


@registry.register_model("mctn")
class MCTN(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, dropout: float = 0.1,
                 teacher_forcing_ratio: float = 0.5, loss_weight: float = 0.5,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        # teacher_forcing_ratio is kept for config parity; see the docstring
        self.loss_weight = loss_weight
        self.D = D = max(audio_dim, text_dim, video_dim)
        self.seq2seq1 = Seq2Seq(D, hidden_dim, D, dropout)
        self.seq2seq2 = Seq2Seq(hidden_dim, hidden_dim, D, dropout)
        self.fc_out_0 = LSTMEncoder(hidden_dim, hidden_dim, dropout)
        self.heads = SimpleClassifierHeads(hidden_dim, output_dim1, output_dim2)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        T = batch["texts"].shape[1]
        if not batch["audios"].shape[1] == T == batch["videos"].shape[1]:
            raise ValueError("MCTN requires frame-aligned inputs")
        pad = lambda x: F.pad(x, (0, self.D - x.shape[-1]))  # noqa: E731
        text, audio, vision = pad(batch["texts"]), pad(batch["audios"]), pad(batch["videos"])

        join, video_1 = self.seq2seq1(text, vision, generator)
        _, text_1 = self.seq2seq1(video_1, text, generator)
        join, audio_1 = self.seq2seq2(join, audio, generator)

        features = self.fc_out_0(join, generator)
        emos_out, vals_out = self.heads(features)

        interloss = self.loss_weight * (((video_1 - vision) ** 2).mean()
                                        + ((text_1 - text) ** 2).mean()
                                        + ((audio_1 - audio) ** 2).mean())
        return features, emos_out, vals_out, interloss
