"""MFM: factorized multimodal representations (generative-discriminative;
port of ``mertools_tpu/models/mfm.py``).

Reference behavior (``MERBench/toolkit/models/mfm.py``): per-modality LSTM
encoders give z_l/z_a/z_v; an inner MFN gives last_hs -> z_y; MMD losses pull
every z toward a standard Gaussian; factor MLPs give f_* (hidden//2); LSTM
decoders reconstruct each modality sequence from concat(f_y, f_modality)
(step 0 consumes that seed, every later step the decoder's own previous
hidden state); interloss = lda_mmd * sum(MMD) + sum(lda_x* · MSE(recon,
input)); features = MLP(f_y) of dim hidden//2.

The encoders are cuDNN ``nn.LSTM``s (a whole sequence through one cell);
the decoders are a per-step loop on an ``nn.LSTMCell``. The prior's four
N(0, I) samples are drawn fresh each call from the caller's generator, as
the reference's ``torch.randn`` does (the JAX package draws them from a
fixed key unless it is given an ``mmd`` stream); ``prior_samples`` is the
seam that hands the model given samples instead (a test, or the card and
the CPU compared on the same draw).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import registry
from .base import FromArgsMixin, freeze_input_biases
from .mfn import MFNBackbone
from .modules import Dropout, SimpleClassifierHeads, lstm_step


def mmd_gaussian(z: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """RBF-kernel MMD between z and the N(0, I) sample ``real``
    (mfm.py:11-31)."""

    def kernel(x, y):
        sq = ((x[:, None, :] - y[None, :, :]) ** 2).mean(dim=-1) / x.shape[-1]
        return torch.exp(-sq)

    return kernel(real, real).mean() + kernel(z, z).mean() - 2.0 * kernel(real, z).mean()


class EncoderLSTM(nn.Module):
    """(B, T, D) -> last hidden -> Linear (mfm.py:33-55)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.lstm = freeze_input_biases(nn.LSTM(in_dim, hidden, batch_first=True))
        self.fc1 = nn.Linear(hidden, hidden)

    def forward(self, x):
        _, (h_n, _) = self.lstm(x)
        return self.fc1(h_n[-1])


class DecoderLSTM(nn.Module):
    """Seed vector -> ``steps`` hidden states -> Linear to ``out_dim``
    (mfm.py:57-85: step 0 consumes the seed, later steps the previous h)."""

    def __init__(self, hidden: int, out_dim: int):
        super().__init__()
        self.cell = freeze_input_biases(nn.LSTMCell(hidden, hidden))
        self.fc1 = nn.Linear(hidden, out_dim)

    def forward(self, seed: torch.Tensor, steps: int) -> torch.Tensor:
        carry, inp, hs = None, seed, []
        for _ in range(steps):
            carry = lstm_step(self.cell, carry, inp)
            inp = carry[1]
            hs.append(inp)
        return self.fc1(torch.stack(hs, dim=1))  # (B, T, D)


@registry.register_model("mfm")
class MFM(FromArgsMixin, nn.Module):
    def __init__(self, audio_dim: int, text_dim: int, video_dim: int,
                 hidden_dim: int = 128, mem_dim: int = 128, dropout: float = 0.3,
                 window_dim: int = 2, lda_xl: float = 0.1, lda_xa: float = 0.1,
                 lda_xv: float = 0.1, lda_mmd: float = 10.0,
                 output_dim1: int = 6, output_dim2: int = 1,
                 feat_type: str = "frm_align"):
        super().__init__()
        H = hidden_dim
        f_dim = H // 2
        self.lda = (lda_xl, lda_xa, lda_xv, lda_mmd)
        dims = {"l": text_dim, "a": audio_dim, "v": video_dim}
        for m, d in dims.items():
            setattr(self, f"encoder_{m}", EncoderLSTM(d, H))
        self.mfn_encoder = MFNBackbone((text_dim, audio_dim, video_dim), H, mem_dim,
                                       dropout)
        self.last_to_zy_fc1 = nn.Linear(3 * H + mem_dim, H)
        for name in ("zy_to_fy", "zl_to_fl", "za_to_fa", "zv_to_fv"):
            setattr(self, f"{name}_fc1", nn.Linear(H, f_dim))
            setattr(self, f"{name}_fc2", nn.Linear(f_dim, f_dim))
        for m, d in dims.items():
            setattr(self, f"decoder_{m}", DecoderLSTM(2 * f_dim, d))
        self.fy_to_y_fc1 = nn.Linear(f_dim, f_dim)
        self.fy_to_y_fc2 = nn.Linear(f_dim, f_dim)
        self.dropout = Dropout(dropout)
        self.heads = SimpleClassifierHeads(f_dim, output_dim1, output_dim2)
        # the seam: four (B, H) N(0, I) samples for z_l, z_a, z_v, z_y
        self.prior_samples: list[torch.Tensor] | None = None

    def _prior(self, zs, generator):
        if self.prior_samples is not None:
            return [s.to(z.device, z.dtype) for s, z in zip(self.prior_samples, zs)]
        return [torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
                for z in zs]

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        x = {"l": batch["texts"], "a": batch["audios"], "v": batch["videos"]}
        T = x["l"].shape[1]
        if not x["a"].shape[1] == T == x["v"].shape[1]:
            raise ValueError("MFM requires frame-aligned inputs")
        z = {m: getattr(self, f"encoder_{m}")(x[m]) for m in "lav"}
        last_hs, _ = self.mfn_encoder(batch, generator, with_features=False)
        z["y"] = self.last_to_zy_fc1(last_hs)

        zs = [z[m] for m in "lavy"]
        mmd = sum(mmd_gaussian(zz, real) for zz, real in zip(zs, self._prior(zs, generator)))

        drop = lambda y: self.dropout(y, generator)  # noqa: E731

        def factor(name, zz):
            h = drop(torch.relu(getattr(self, f"{name}_fc1")(zz)))
            return torch.relu(getattr(self, f"{name}_fc2")(h))

        f_y = factor("zy_to_fy", z["y"])
        f = {m: factor(f"z{m}_to_f{m}", z[m]) for m in "lav"}
        x_hat = {m: getattr(self, f"decoder_{m}")(torch.cat([f_y, f[m]], dim=1), T)
                 for m in "lav"}

        h = drop(torch.relu(self.fy_to_y_fc1(f_y)))
        features = self.fy_to_y_fc2(h)

        emos_out, vals_out = self.heads(features)
        lda_xl, lda_xa, lda_xv, lda_mmd = self.lda
        gen = sum(w * ((x_hat[m] - x[m]) ** 2).mean()
                  for w, m in zip((lda_xl, lda_xa, lda_xv), "lav"))
        return features, emos_out, vals_out, lda_mmd * mmd + gen
