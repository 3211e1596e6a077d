"""Causal attention with segment ids, forward and backward (kernel B3).

Counterpart of the Pallas TPU flash attention that
``mertools_tpu/mllm/llm.py:_LLMLayer`` calls with ``causal=True`` and
``sm_scale=1/sqrt(hd)`` on the training path (``:185-197``), including the
library's two backward kernels. Key j reaches query i iff ``j <= i`` and
``seg[b, i] == seg[b, j]``; every row reaches itself, so pad rows stay finite.

Layouts: q (B, S, nh, hd); k, v (B, S, nkv, hd) with ``nh % nkv == 0`` (GQA:
query head h reads kv head ``h // (nh // nkv)``; nothing is repeated); seg
(B, S) int32; the row logsumexp ``lse`` and ``di = rowsum(dO * O)`` are
(B, nh, S) fp32.

:func:`flash_attention_causal` is the differentiable entry point: CPU tensors
take the plain version :func:`causal_attention_ref`, which autograd
differentiates; CUDA tensors run the four hand-written kernels of
``csrc/flash_attention_causal.cu`` through :class:`_FlashAttentionCausal`, or
raise. Each kernel has a wrapper with its own plain version and launch count
(``.launches``): :func:`flash_attention_causal_fwd`,
:func:`flash_attention_causal_bwd_prep`, :func:`flash_attention_causal_bwd_dkv`
and :func:`flash_attention_causal_bwd_dq`.
"""

from __future__ import annotations

import ctypes
import math

import torch

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
# the library's additive mask value (flash_attention.py DEFAULT_MASK_VALUE)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


# ------------------------------------------------------------ plain versions
def _mask(seg: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, S) bool: segment equality AND causal."""
    S = seg.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=seg.device).tril()
    return ((seg[:, :, None] == seg[:, None, :]) & causal)[:, None]


def _repeat_kv(x: torch.Tensor, nh: int) -> torch.Tensor:
    return x.repeat_interleave(nh // x.shape[2], dim=2)


def _probs(q, k, seg, lse):
    """P (B, nh, S, S) fp32 from the saved logsumexp."""
    hd = q.shape[-1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(),
                          _repeat_kv(k.float(), q.shape[2])) / math.sqrt(hd)
    p = torch.exp(logits - lse[..., None])
    return torch.where(_mask(seg), p, 0.0)


def causal_attention_fwd_ref(q, k, v, seg):
    """Plain PyTorch forward: what the library's ``mha_reference`` computes
    (einsum, then ``sm_scale``, then the additive mask value, softmax in
    fp32), plus the row logsumexp. Returns (out in q's dtype, lse fp32)."""
    nh, hd = q.shape[2], q.shape[3]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(),
                          _repeat_kv(k.float(), nh)) * (1.0 / math.sqrt(hd))
    logits = logits + torch.where(_mask(seg), 0.0, MASK_VALUE)
    m = logits.amax(-1, keepdim=True)
    u = torch.exp(logits - m)
    l_sum = u.sum(-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", u / l_sum, _repeat_kv(v.float(), nh))
    return out.to(q.dtype), (m + torch.log(l_sum))[..., 0]


def causal_attention_ref(q, k, v, seg):
    """Plain PyTorch version of the differentiable attention (autograd
    differentiates it): (B, S, nh, hd) in q's dtype."""
    return causal_attention_fwd_ref(q, k, v, seg)[0]


def bwd_prep_ref(o, dout):
    """di = rowsum(dO * O) in fp32, (B, nh, S)."""
    return (o.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def bwd_dkv_ref(q, k, v, seg, dout, lse, di):
    """dK, dV (B, S, nkv, hd) from the saved lse and di: each the sum over its
    group's query heads."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    p = _probs(q, k, seg, lse)
    dp = torch.einsum("bqnd,bknd->bnqk", dout.float(),
                      _repeat_kv(v.float(), nh))
    ds = p * (dp - di[..., None])
    dv = torch.einsum("bnqk,bqnd->bknd", p, dout.float())
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float()) / math.sqrt(hd)
    group = nh // nkv
    dk = dk.reshape(B, S, nkv, group, hd).sum(3)
    dv = dv.reshape(B, S, nkv, group, hd).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_dq_ref(q, k, v, seg, dout, lse, di):
    """dQ (B, S, nh, hd) from the saved lse and di."""
    nh, hd = q.shape[2], q.shape[3]
    p = _probs(q, k, seg, lse)
    dp = torch.einsum("bqnd,bknd->bnqk", dout.float(),
                      _repeat_kv(v.float(), nh))
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bnqk,bknd->bqnd", ds,
                      _repeat_kv(k.float(), nh)) / math.sqrt(hd)
    return dq.to(q.dtype)


# ------------------------------------------------------------------ checks
def _check_rows(name, t):
    if t.stride(3) != 1:
        raise ValueError(f"{name} head dimension must be contiguous, "
                         f"strides {t.stride()}")
    if max(t.stride()) >= 2 ** 31:
        raise ValueError(f"{name} strides {t.stride()} exceed int32")
    # the bf16 kernels and the di pre-pass (bf16 and fp32) load rows as
    # 16-byte vectors
    if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                for st in t.stride()[:3]):
        raise ValueError(f"{t.dtype} {name} rows must start on 16-byte "
                         f"boundaries (strides {t.stride()})")


def check_kernel_args(q, k, v, seg) -> None:
    """Raise ValueError on anything the CUDA kernels do not take.

    Device-agnostic, so it can be exercised on CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, heads, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, nh, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k, v must be (B, S, nkv, hd) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if nh % k.shape[2]:
        raise ValueError(f"{nh} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernels "
                         f"take one of {SUPPORTED_DTYPES} for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)
    if seg.shape != (B, S) or seg.dtype != torch.int32 \
            or not seg.is_contiguous():
        raise ValueError(f"seg must be contiguous int32 of shape ({B}, {S}), "
                         f"got {seg.dtype} {tuple(seg.shape)}")
    devices = {t.device for t in (q, k, v, seg)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, seg on different devices: {devices}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _cuda(q) -> tuple[int, ctypes.c_void_p]:
    if q.device.type != "cuda":
        raise ValueError(f"causal flash attention runs on CPU or CUDA, not "
                         f"{q.device}")
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    return dev, ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_int * len(vals))(*vals)


def _raise(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# -------------------------------------------------------------- the kernels
def flash_attention_causal_fwd(q, k, v, seg):
    """(out (B, S, nh, hd) in q's dtype, lse (B, nh, S) fp32).

    CPU tensors take :func:`causal_attention_fwd_ref`; CUDA tensors launch
    the kernel or raise."""
    if _on_cpu(q, k, v, seg):
        return causal_attention_fwd_ref(q, k, v, seg)
    check_kernel_args(q, k, v, seg)
    dev, stream = _cuda(q)
    from ._kernels import library

    B, S, nh, hd = q.shape
    out = torch.empty((B, S, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, S), dtype=torch.float32, device=q.device)
    _raise(library().mt_flash_attention_causal_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, nh, k.shape[2], hd,
        int(q.dtype == torch.bfloat16), dev, _strides(q, k, v, out), stream),
        "flash_attention_causal_fwd")
    flash_attention_causal_fwd.launches += 1
    return out, lse


def flash_attention_causal_bwd_prep(o, dout):
    """di = rowsum(dO * O), (B, nh, S) fp32. CPU tensors take
    :func:`bwd_prep_ref`."""
    if _on_cpu(o, dout):
        return bwd_prep_ref(o, dout)
    if o.shape != dout.shape or o.dtype != dout.dtype \
            or o.dtype not in SUPPORTED_DTYPES \
            or o.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"o {o.dtype} {tuple(o.shape)} and dout {dout.dtype} "
                         f"{tuple(dout.shape)}: same (B, S, nh, hd) shape and "
                         f"dtype in {SUPPORTED_DTYPES}, hd in "
                         f"{SUPPORTED_HEAD_DIMS}")
    _check_rows("o", o)
    _check_rows("dout", dout)
    dev, stream = _cuda(o)
    from ._kernels import library

    B, S, nh, hd = o.shape
    di = torch.empty((B, nh, S), dtype=torch.float32, device=o.device)
    _raise(library().mt_flash_attention_causal_bwd_prep(
        o.data_ptr(), dout.data_ptr(), di.data_ptr(), B, S, nh, hd,
        int(o.dtype == torch.bfloat16), dev, _strides(o, dout), stream),
        "flash_attention_causal_bwd_prep")
    flash_attention_causal_bwd_prep.launches += 1
    return di


def _check_bwd(q, dout, lse, di):
    B, S, nh, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} must match q "
                         f"{q.dtype} {tuple(q.shape)}")
    _check_rows("dout", dout)
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (B, nh, S) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 ({B}, {nh}, {S}),"
                             f" got {t.dtype} {tuple(t.shape)}")


def dkv_cluster(nh: int, nkv: int) -> int:
    """Blocks per thread-block cluster of the bf16 dK/dV kernel: the largest
    divisor of the GQA group ``nh // nkv`` that is at most 8 (the portable
    cluster size). The cluster's blocks share one kv head, each takes
    ``group // cluster`` of its query heads, and the cluster adds their dK
    and dV in rank order."""
    group = nh // nkv
    return max(c for c in range(1, 9) if group % c == 0)


def flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di):
    """(dK, dV), (B, S, nkv, hd) in k's dtype. CPU tensors take
    :func:`bwd_dkv_ref`."""
    if _on_cpu(q, k, v, seg, dout, lse, di):
        return bwd_dkv_ref(q, k, v, seg, dout, lse, di)
    check_kernel_args(q, k, v, seg)
    _check_bwd(q, dout, lse, di)
    dev, stream = _cuda(q)
    from ._kernels import library

    B, S, nh, hd = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _raise(library().mt_flash_attention_causal_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, nh, k.shape[2], hd, dkv_cluster(nh, k.shape[2]),
        int(q.dtype == torch.bfloat16), dev,
        _strides(q, k, v, dout, dk, dv), stream),
        "flash_attention_causal_bwd_dkv")
    flash_attention_causal_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di):
    """dQ, (B, S, nh, hd) in q's dtype. CPU tensors take :func:`bwd_dq_ref`."""
    if _on_cpu(q, k, v, seg, dout, lse, di):
        return bwd_dq_ref(q, k, v, seg, dout, lse, di)
    check_kernel_args(q, k, v, seg)
    _check_bwd(q, dout, lse, di)
    dev, stream = _cuda(q)
    from ._kernels import library

    B, S, nh, hd = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _raise(library().mt_flash_attention_causal_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        B, S, nh, k.shape[2], hd, int(q.dtype == torch.bfloat16), dev,
        _strides(q, k, v, dout, dq), stream),
        "flash_attention_causal_bwd_dq")
    flash_attention_causal_bwd_dq.launches += 1
    return dq


for _fn in (flash_attention_causal_fwd, flash_attention_causal_bwd_prep,
            flash_attention_causal_bwd_dkv, flash_attention_causal_bwd_dq):
    _fn.launches = 0


class _FlashAttentionCausal(torch.autograd.Function):
    """The kernels as one differentiable op: forward saves O and lse; backward
    runs the di pre-pass, then dkv and dq."""

    @staticmethod
    def forward(ctx, q, k, v, seg):
        out, lse = flash_attention_causal_fwd(q, k, v, seg)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        di = flash_attention_causal_bwd_prep(out, dout)
        dk, dv = flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di)
        dq = flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di)
        return dq, dk, dv, None


def flash_attention_causal(q, k, v, seg):
    """Differentiable causal attention with segment ids, (B, S, nh, hd).

    CPU tensors take :func:`causal_attention_ref` (autograd differentiates
    it). CUDA tensors run the kernels, forward and backward, or raise: there
    is no fallback."""
    if _on_cpu(q, k, v, seg):
        return causal_attention_ref(q, k, v, seg)
    check_kernel_args(q, k, v, seg)
    return _FlashAttentionCausal.apply(q, k, v, seg)
