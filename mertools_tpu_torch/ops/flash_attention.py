"""Bidirectional attention with per-row key lengths (kernel B1).

Counterpart of the Pallas TPU flash attention that
``mertools_tpu/encoders/wav2vec2.py:_Attention`` calls (``:160-181``). The
JAX call pads T to a multiple of 512, transposes to (B, nh, T, hd) and
encodes validity as segment ids; the CUDA kernel
(``csrc/flash_attention_fwd.cu``) reads the projections' (B, T, nh, hd)
layout through strides and takes one key length per row instead, which is
exact because validity on this path is always a prefix of the frames.

:func:`flash_attention` launches the kernel for CUDA tensors (or raises) and
takes the plain version :func:`flash_attention_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: einsum, key mask, softmax and sum in fp32.

    q, k, v: (B, T, nh, hd), q pre-scaled by hd**-0.5; kv_len: (B,) int.
    Key j takes part in row b iff j < kv_len[b]; pad keys and values are
    never used (a NaN there cannot reach a valid row); rows with
    kv_len <= 0 are zeros. Returns (B, T, nh, hd) in q's dtype."""
    T = k.shape[1]
    valid = (torch.arange(T, device=k.device)[None, :]
             < kv_len.to(k.device)[:, None])                    # (B, T)
    vf = v.float().masked_fill(~valid[:, :, None, None], 0.0)
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", w, vf)
    has_keys = (kv_len.to(k.device) > 0)[:, None, None, None]
    return torch.where(has_keys, out, 0.0).to(q.dtype)


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor) -> None:
    """Raise ValueError on anything the CUDA kernel does not take.

    Device-agnostic, so it can be exercised on CPU tensors."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, nh, hd), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, nh, hd = q.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes one of {SUPPORTED_DTYPES} for all three")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} head dimension must be contiguous, "
                             f"strides {t.stride()}")
        if max(t.stride()) >= 2 ** 31:
            raise ValueError(f"{name} strides {t.stride()} exceed int32")
        # the bf16 kernel loads rows as 16-byte vectors
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} rows must start on 16-byte "
                             f"boundaries (strides {t.stride()})")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32 \
            or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be contiguous int32 of shape ({B},), "
                         f"got {kv_len.dtype} {tuple(kv_len.shape)}")
    devices = {t.device for t in (q, k, v, kv_len)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, kv_len on different devices: {devices}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor) -> torch.Tensor:
    """Attention over keys j < kv_len[b]; see :func:`flash_attention_ref`.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: there is no fallback. ``flash_attention.launches`` counts kernel
    launches."""
    if all(t.device.type == "cpu" for t in (q, k, v, kv_len)):
        return flash_attention_ref(q, k, v, kv_len)
    check_kernel_args(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {q.device}")
    from ._kernels import library

    B, T, nh, hd = q.shape
    out = torch.empty((B, T, nh, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = library().mt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_len.data_ptr(), B, T, nh, hd, int(q.dtype == torch.bfloat16),
        q.device.index if q.device.index is not None
        else torch.cuda.current_device(),
        *strides, ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
