"""Fusion-model contract, factory, Flax-style init and weight transfer
(port of ``mertools_tpu/models/base.py``).

Every fusion model is an ``nn.Module`` with

    forward(batch: dict, generator=None) -> (features, emos_out, vals_out, interloss)

mirroring the reference contract (``MERBench/toolkit/models/attention.py:36-57``).
``batch`` carries ``audios``/``texts``/``videos``; ``generator`` draws the
dropout masks in training mode.

Models register with ``@registry.register_model(name)`` and are built from
an :class:`~mertools_tpu_torch.core.config.Args` namespace and the three
input widths by :func:`get_model`. Only ``attention`` is ported; the rest of
the zoo is ROADMAP A7.

:func:`init_flax_style` draws the JAX package's initial distribution
(Flax's defaults: ``lecun_normal`` kernels, orthogonal recurrent kernels,
zero biases), and :func:`state_dict_from_flax` moves a Flax parameter tree
into a model of the same configuration.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch
from torch import nn

from ..core.config import Args
from ..core.registry import registry

# Flax's lecun_normal: a normal truncated at +-2, scaled so that the
# truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def get_model(args: Args, dims: tuple[int, int, int]) -> nn.Module:
    """Instantiate the fusion model ``args.model`` for input widths
    ``dims`` = (audio, text, video)."""
    if args.model not in registry.names("model"):
        raise SystemExit(f"--model={args.model}: only the attention fusion "
                         f"model is ported to mertools_tpu_torch; the rest of "
                         f"the zoo is ROADMAP A7")
    return registry.get_model(args.model).from_args(args, dims)


class FromArgsMixin:
    """Default from_args: the input widths, then every other constructor
    argument that ``args`` sets."""

    @classmethod
    def from_args(cls, args: Args, dims: tuple[int, int, int]):
        names = list(inspect.signature(cls.__init__).parameters)[4:]
        kw = {n: args[n] for n in names if args.get(n) is not None}
        return cls(*dims, **kw)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """``w`` (out, in) from Flax's ``lecun_normal`` with fan_in = in."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD)


@torch.no_grad()
def init_flax_style(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter as Flax's defaults would: Linear weights
    ``lecun_normal``; an LSTM's input kernel ``lecun_normal`` and its
    recurrent kernel orthogonal, each gate's block on its own (Flax keeps
    one Dense a gate); all biases zero (Flax has no input-side LSTM bias)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LSTM):
            for w_ih, w_hh in zip(m.weight_ih_l0.chunk(4), m.weight_hh_l0.chunk(4)):
                _lecun_normal_(w_ih, generator)
                nn.init.orthogonal_(w_hh, generator=generator)
            nn.init.zeros_(m.bias_ih_l0)
            nn.init.zeros_(m.bias_hh_l0)
    return model


# Flax auto-names -> the port's attribute names
_RENAME = {"SimpleClassifierHeads_0": "heads", "OptimizedLSTMCell_0": "lstm",
           "Dense_0": "fc"}
_GATES = ("i", "f", "g", "o")  # torch's order of the LSTM row blocks


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A Flax fusion model's ``params`` tree as the port's state dict:
    ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in); an
    ``OptimizedLSTMCell``'s per-gate kernels ``i{i,f,g,o}`` (in, H) and
    ``h{i,f,g,o}`` (H, H) -> the row blocks of ``weight_ih_l0`` and
    ``weight_hh_l0``, its ``h*`` biases -> ``bias_hh_l0``, and
    ``bias_ih_l0`` = 0."""
    out: dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk(tree: dict, prefix: str) -> None:
        if "hi" in tree:  # an LSTM cell
            out[prefix + "weight_ih_l0"] = torch.cat(
                [t(tree[f"i{g}"]["kernel"]).T for g in _GATES])
            out[prefix + "weight_hh_l0"] = torch.cat(
                [t(tree[f"h{g}"]["kernel"]).T for g in _GATES])
            out[prefix + "bias_hh_l0"] = torch.cat(
                [t(tree[f"h{g}"]["bias"]) for g in _GATES])
            out[prefix + "bias_ih_l0"] = torch.zeros_like(out[prefix + "bias_hh_l0"])
        elif "kernel" in tree:  # a Dense
            out[prefix + "weight"] = t(tree["kernel"]).T.contiguous()
            out[prefix + "bias"] = t(tree["bias"])
        else:
            for name, sub in tree.items():
                walk(sub, f"{prefix}{_RENAME.get(name, name)}.")

    walk(params, "")
    return {k: v.contiguous() for k, v in out.items()}
