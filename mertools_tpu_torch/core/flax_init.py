"""Flax's default initialisers in torch, for modules that the JAX package
draws fresh (the fusion models' ``init_model``, the audio zoo's
``--random_init``). The draws differ from JAX's (another generator); their
distributions match."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# Flax's lecun_normal: a normal truncated at +-2, scaled so that the
# truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """``w`` from Flax's truncated-normal variance scaling with the given
    std of the truncated draw: a standard normal truncated at +-2 by the
    inverse CDF of a uniform draw (one pass, the same values on every torch
    version; newer ``nn.init.trunc_normal_`` redraws the whole tensor per
    rejection round, ~20 s for TFN's 275M-entry layer), then scaled."""
    lo = math.erf(-2.0 / math.sqrt(2.0))
    w.uniform_(lo, -lo, generator=generator)
    w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    w.mul_(std / _TRUNC_STD)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """``w`` (out, in, ...) from Flax's ``lecun_normal`` with fan_in = in
    times the kernel size (a Conv1d's (out, in, K) has fan_in in·K)."""
    trunc_normal_(w, math.sqrt(1.0 / w[0].numel()), generator)


def xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``xavier_normal`` (truncated, fan_avg) for a raw parameter of
    Flax's shape: the last axis is fan_out, the one before fan_in, the rest
    the receptive field."""
    receptive = int(np.prod(w.shape[:-2])) if w.dim() > 2 else 1
    fan_avg = (w.shape[-2] + w.shape[-1]) * receptive / 2.0
    trunc_normal_(w, math.sqrt(1.0 / fan_avg), generator)


def _init_lstm_weights(pairs, generator: torch.Generator) -> None:
    """A recurrent layer's (weight_ih, weight_hh) pairs: each gate's block
    on its own (Flax keeps one Dense a gate), input kernels lecun_normal,
    recurrent kernels orthogonal."""
    for w_ih, w_hh in pairs:
        for b_ih, b_hh in zip(w_ih.chunk(4), w_hh.chunk(4)):
            lecun_normal_(b_ih, generator)
            nn.init.orthogonal_(b_hh, generator=generator)


@torch.no_grad()
def init_flax_style(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter as Flax's defaults would: Linear and conv
    weights ``lecun_normal``; an LSTM's input kernel ``lecun_normal`` and
    its recurrent kernel orthogonal, each gate's block on its own, every
    layer and direction; LayerNorm and GroupNorm scales 1; all biases zero
    (Flax has no input-side LSTM bias). A module with a
    ``flax_init_(generator)`` method draws its own raw parameters (LMF's
    factors, ImageBind's class token and position table) after that."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LSTM):
            names = [f"_l{k}{s}" for k in range(m.num_layers)
                     for s in (("", "_reverse") if m.bidirectional else ("",))]
            _init_lstm_weights([(getattr(m, "weight_ih" + n), getattr(m, "weight_hh" + n))
                                for n in names], generator)
            for n in names:
                nn.init.zeros_(getattr(m, "bias_ih" + n))
                nn.init.zeros_(getattr(m, "bias_hh" + n))
        elif isinstance(m, nn.LSTMCell):
            _init_lstm_weights([(m.weight_ih, m.weight_hh)], generator)
            nn.init.zeros_(m.bias_ih)
            nn.init.zeros_(m.bias_hh)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if hasattr(m, "flax_init_"):
            m.flax_init_(generator)
    return model
