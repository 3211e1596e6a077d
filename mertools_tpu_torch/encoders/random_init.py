"""Seeded random weights for the transformer encoders, for runs without a
checkpoint (the card phases of ``chip_smoke.py`` draw BERT and CLIP at
their published widths from it)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def normal_state_dict(model: nn.Module, generator: torch.Generator,
                      std: Callable[[str], float]) -> dict:
    """A state dict for ``model`` (built on the meta device), drawn on the
    generator's device as HF's ``_init_weights`` draws a fresh model: unit
    LayerNorm scales, zero biases, and every other parameter (Linear and
    conv weights, embedding tables) from normal(0, ``std(key)``)."""
    sd = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            t = torch.empty(p.shape, device=generator.device)
            if isinstance(mod, nn.LayerNorm):
                t.fill_(1.0 if pname == "weight" else 0.0)
            elif pname == "bias":
                t.zero_()
            else:
                t.normal_(0.0, std(key), generator=generator)
            sd[key] = t
    return sd
