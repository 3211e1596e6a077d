"""Symmetric int8 quantization — port of ``mertools_tpu/ops/quant.py``.

Two modes, as in the JAX package:

- dynamic w8a8 (:func:`int8_dot_general`): the activation is quantized per
  row and the weight per output column (symmetric absmax), the product is an
  int8 x int8 -> int32 GEMM, and the result is rescaled to the activation's
  dtype. The GEMM is ``torch._int_mm`` on the card and on the CPU alike, with
  the operands zero-padded to the sizes it takes (M > 16; K and N multiples
  of 8), which leaves the int32 sums exact. Nothing falls back to float.
- weight-only int8 (:func:`quantize_weight_w8`, :func:`w8_linear`): int8
  codes with an fp32 per-output-column scale; the codes are cast to the
  activation's dtype and the scale is applied to the output. This is the
  serving mode of ``mllm/generate.py`` (``W8Linear``).

:class:`DotGeneralLinear` is the encoders' hook for the first mode: an
``nn.Linear`` whose product goes through a ``dot_general(lhs, kernel (K,
N))`` when one is set, as Flax's ``nn.Dense(dot_general=...)`` does in the
JAX encoders' transformer layers.

Rounding is half to even on both sides (``jnp.round`` and ``torch.round``),
and every division is the JAX package's, so codes and scales are bit-equal
to the JAX functions'. Weights here are in the PyTorch layout (out, in); the
JAX functions take a (K, N) kernel, its transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.float().abs().amax(dim, keepdim=True).clamp_min(1e-8)


def quantize_int8(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``dim``: ``(q, scale)`` with
    ``x ~= q.float() * (scale / 127)``."""
    scale = _absmax_scale(x, dim)
    q = torch.round(x.float() / scale * 127.0).to(torch.int8)
    return q, scale


def quantize_weight_w8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A weight ``(out, in)`` as weight-only int8: ``(q int8 (out, in),
    scale fp32 (out,))`` with ``w ~= q.float() * scale[:, None]``; per output
    channel symmetric absmax."""
    s = _absmax_scale(w, 1) / 127.0
    q = torch.round(w.float() / s).to(torch.int8)
    return q, s.reshape(-1)


def w8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scale).T`` in x's dtype: the codes are cast to the
    activation dtype for the product and the per-column scale multiplies the
    (small) output, as the JAX ``w8_einsum`` does."""
    y = F.linear(x, q.to(x.dtype))
    return y * scale.to(y.dtype)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N) through ``torch._int_mm``,
    zero-padding M to at least 17 and K, N to multiples of 8 (zeros add
    nothing to an integer sum). ``a`` goes in row-major and ``b``
    column-major, the layouts cuBLASLt's int8 GEMM takes on every CUDA
    version."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(17, M), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:M, :N]


def int8_dot_general(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Dynamic w8a8 product of ``lhs (..., K)`` and a Dense kernel ``rhs
    (K, N)`` with int32 accumulation; the result is in lhs's dtype (the JAX
    function's Dense contraction pattern)."""
    out_dtype = lhs.dtype
    ql, ls = quantize_int8(lhs, -1)          # (..., K), (..., 1)
    qr, rs = quantize_int8(rhs, 0)           # (K, N),  (1, N)
    lead = ql.shape[:-1]
    acc = int_mm(ql.reshape(-1, ql.shape[-1]), qr).reshape(*lead, -1)
    out = acc.float() * (ls / 127.0) * (rs / 127.0)
    return out.to(out_dtype)


class DotGeneralLinear(nn.Linear):
    """``nn.Linear`` (same parameters, same state-dict keys) whose product
    runs through ``self.dot_general(x, weight.T)`` when it is set (e.g.
    :func:`int8_dot_general`), the bias added after in x's dtype as Flax's
    ``Dense`` adds it; with ``dot_general`` None it is ``nn.Linear``."""

    dot_general = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dot_general is None:
            return super().forward(x)
        y = self.dot_general(x, self.weight.t())
        return y if self.bias is None else y + self.bias


def set_dot_general(module: nn.Module, dot_general) -> nn.Module:
    """Set (or, with None, clear) the product of every
    :class:`DotGeneralLinear` in ``module``; returns ``module``."""
    for m in module.modules():
        if isinstance(m, DotGeneralLinear):
            m.dot_general = dot_general
    return module
