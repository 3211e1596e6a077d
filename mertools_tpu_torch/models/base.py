"""Fusion-model contract, factory, Flax-style init and weight transfer
(port of ``mertools_tpu/models/base.py``).

Every fusion model is an ``nn.Module`` with

    forward(batch: dict, generator=None) -> (features, emos_out, vals_out, interloss)

mirroring the reference contract (``MERBench/toolkit/models/attention.py:36-57``).
``batch`` carries ``audios``/``texts``/``videos`` (top-N fusion:
``feat0..feat{N-1}``); ``generator`` draws the dropout masks in training
mode.

Models register with ``@registry.register_model(name)`` and are built from
an :class:`~mertools_tpu_torch.core.config.Args` namespace and the input
widths by :func:`get_model`; the raw-input ``e2e_model``
(:mod:`.e2e_model`) takes no widths. ``videomae_pretrain`` is ROADMAP A7b.

:func:`~mertools_tpu_torch.core.flax_init.init_flax_style` draws the JAX
package's initial distribution, and :func:`state_dict_from_flax` moves a
Flax parameter tree into a model of the same configuration.
"""

from __future__ import annotations

import inspect
import re

import numpy as np
import torch
from torch import nn

from ..core.config import Args
from ..core.registry import registry


def get_model(args: Args, dims: tuple[int, ...]) -> nn.Module:
    """Instantiate the fusion model ``args.model`` for input widths
    ``dims`` = (audio, text, video), or one width a feature set for
    ``attention_topn`` (``e2e_model`` ignores them)."""
    if args.model not in registry.names("model"):
        raise SystemExit(f"--model={args.model}: not a model of "
                         f"mertools_tpu_torch (videomae_pretrain is ROADMAP "
                         f"A7b); it runs {', '.join(registry.names('model'))}")
    return registry.get_model(args.model).from_args(args, dims)


class FromArgsMixin:
    """Default from_args: the input widths, then every other constructor
    argument that ``args`` sets."""

    @classmethod
    def from_args(cls, args: Args, dims: tuple[int, int, int]):
        names = list(inspect.signature(cls.__init__).parameters)[4:]
        kw = {n: args[n] for n in names if args.get(n) is not None}
        return cls(*dims, **kw)


def freeze_input_biases(module: nn.Module) -> nn.Module:
    """Freeze the input-side bias of every ``nn.LSTM`` and ``nn.LSTMCell``
    in ``module`` (itself included) at its value, 0 after
    :func:`~mertools_tpu_torch.core.flax_init.init_flax_style`: Flax's
    cell has one bias a gate, on the recurrent side, or the gate bias would
    learn twice as fast."""
    for m in module.modules():
        if isinstance(m, (nn.LSTM, nn.LSTMCell)):
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("bias_ih"):
                    p.requires_grad_(False)
    return module


# Flax paths (joined with ".") -> the port's names, applied in order to
# each key after the per-kind conversion below
_RENAMES = [
    # LSTMEncoder and EF_LSTM: Flax names the cells OptimizedLSTMCell_k in
    # the parent's scope, one a layer of the port's cuDNN nn.LSTM
    (r"OptimizedLSTMCell_(\d+)\.(\w+)$", r"lstm.\2_l\1"),
    # MFM's encoders (cuDNN) and decoders (a per-step cell)
    (r"(encoder_[lav])\.step\.cell\.(\w+)$", r"\1.lstm.\2_l0"),
    (r"(decoder_[lav])\.step\.cell\.", r"\1.cell."),
    # MCTN: the bidirectional encoder is one cuDNN nn.LSTM, the decoder's
    # two directions are per-step cells
    (r"encoder\.fwd\.cell\.(\w+)$", r"encoder.lstm.\1_l0"),
    (r"encoder\.bwd\.cell\.(\w+)$", r"encoder.lstm.\1_l0_reverse"),
    (r"decoder\.(fwd|bwd)\.cell\.", r"decoder.\1."),
    # MISA's torch-style transformer layer
    (r"transformer\.MultiHeadDotProductAttention_0\.", "transformer.self_attn."),
    (r"transformer\.LayerNorm_(\d)\.",
     lambda m: f"transformer.norm{int(m.group(1)) + 1}."),
    (r"transformer\.Dense_(\d)\.",
     lambda m: f"transformer.linear{int(m.group(1)) + 1}."),
    (r"SimpleClassifierHeads_0\.", "heads."),
    (r"Dense_0\.", "fc."),
]
_GATES = ("i", "f", "g", "o")  # torch's order of the LSTM row blocks


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A Flax fusion model's ``params`` tree as the port's state dict:

    * ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in);
    * an ``OptimizedLSTMCell``'s per-gate kernels ``i{i,f,g,o}`` (in, H) and
      ``h{i,f,g,o}`` (H, H) -> the row blocks of ``weight_ih`` and
      ``weight_hh``, its ``h*`` biases -> ``bias_hh``, and ``bias_ih`` = 0
      (suffixed ``_l{k}`` / ``_l0_reverse`` where the port runs a cuDNN
      ``nn.LSTM``);
    * ``MultiHeadDotProductAttention``'s ``query``/``key``/``value``
      kernels (D, nh, hd) with (nh, hd) biases and ``out`` (nh, hd, D) ->
      Linear weights over the flattened heads;
    * ``LayerNorm`` ``scale``/``bias`` -> ``weight``/``bias``;
    * ``Conv`` kernels (K, in, out) -> ``Conv1d.weight`` (out, in, K);
    * raw ``self.param`` leaves (LMF's factors) as they are;

    then the Flax names become the port's (:data:`_RENAMES`)."""
    out: dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk(tree: dict, prefix: str, name: str) -> None:
        if "hi" in tree:  # an LSTM cell
            out[prefix + "weight_ih"] = torch.cat(
                [t(tree[f"i{g}"]["kernel"]).T for g in _GATES])
            out[prefix + "weight_hh"] = torch.cat(
                [t(tree[f"h{g}"]["kernel"]).T for g in _GATES])
            out[prefix + "bias_hh"] = torch.cat(
                [t(tree[f"h{g}"]["bias"]) for g in _GATES])
            out[prefix + "bias_ih"] = torch.zeros_like(out[prefix + "bias_hh"])
            return
        if "scale" in tree:  # a LayerNorm
            out[prefix + "weight"] = t(tree["scale"])
            out[prefix + "bias"] = t(tree["bias"])
            return
        if "kernel" in tree and not isinstance(tree["kernel"], dict):
            k = t(tree["kernel"])
            if k.dim() == 2:  # a Dense
                w = k.T
            elif name in ("query", "key", "value"):  # DenseGeneral (D, nh, hd)
                w = k.reshape(k.shape[0], -1).T
            elif name == "out":  # DenseGeneral (nh, hd, D)
                w = k.reshape(-1, k.shape[-1]).T
            else:  # a Conv (K, in, out)
                w = k.permute(2, 1, 0)
            out[prefix + "weight"] = w.contiguous()
            if "bias" in tree:
                out[prefix + "bias"] = t(tree["bias"]).reshape(-1)
            return
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, f"{prefix}{key}.", key)
            else:  # a raw parameter
                out[prefix + key] = t(sub)

    walk(params, "", "")
    renamed = {}
    for key, v in out.items():
        for pat, repl in _RENAMES:
            key = re.sub(pat, repl, key)
        renamed[key] = v.contiguous()
    return renamed
