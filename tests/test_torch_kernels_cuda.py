"""Kernels B1 (csrc/flash_attention_fwd.cu) and B2 (csrc/mel_power_fwd.cu)
against their plain versions, on the card. Needs an NVIDIA Hopper GPU and
nvcc; elsewhere every test skips.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from mertools_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_ref)
from mertools_tpu_torch.ops.mel import log_mel_from_power
from mertools_tpu_torch.ops.mel_fused import mel_power, mel_power_ref

pytestmark = pytest.mark.cuda

# max |kernel - ref| / max |ref|: fp32 differs from the fp32 reference only
# in summation order; bf16 rounds the output (8 mantissa bits) against a
# reference computed in fp32 from the same bf16 inputs
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, B, T, nh, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, nh, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    return q * hd ** -0.5, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_kernel_matches_plain(cuda, dtype, hd):
    kv_len = torch.tensor([499, 480, 250, 49, 1, 0, 64, 65], dtype=torch.int32,
                          device=cuda)
    q, k, v = _inputs(cuda, len(kv_len), 499, 4, hd, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= TOL[dtype], rel
    assert torch.isfinite(out).all()
    assert torch.equal(out[5], torch.zeros_like(out[5]))


def test_pad_values_never_read(cuda):
    kv_len = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    q, k, v = _inputs(cuda, 2, 130, 2, 64, torch.float32, seed=1)
    base = flash_attention(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[0, 100:] = float("nan")
    v2[1, 7:] = float("nan")
    out = flash_attention(q, k2, v2, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(out, base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_fused_qkv(cuda, dtype):
    """q, k, v as slices of one fused (B, T, 3, nh, hd) tensor."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(3, 77, 3, 2, 64))
                           .astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv.unbind(2)
    kv_len = torch.tensor([77, 30, 0], dtype=torch.int32, device=cuda)
    out = flash_attention(q, k, v, kv_len)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= TOL[dtype], rel


def test_cuda_tensors_never_fall_back(cuda):
    q, k, v = _inputs(cuda, 1, 16, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v, torch.tensor([16], dtype=torch.int32,
                                              device=cuda))


# B2: max |kernel - ref| / max |ref| per clip. Both sides are fp32; the kernel
# sums the dense DFT where the reference runs cuFFT, so they differ by
# rounding only (~1e-6 of the clip's peak power at these inputs)
MEL_TOL = 1e-5
LOG_MEL_TOL = 1e-4  # abs, in the (log10 + 4) / 4 domain


def _mel_inputs(cuda):
    n = 480000
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(3)
    wav = np.zeros((5, n), np.float32)
    wav[0, :64000] = 0.4 * np.sin(2 * np.pi * 440 * t[:64000])   # sine
    wav[1] = rng.normal(size=n) * 0.1                             # noise
    # wav[2] stays zero: a filler row
    wav[3] = np.sign(np.sin(2 * np.pi * 200 * t + 0.1))           # +-1 square
    wav[4] = 0.3 + 0.05 * rng.normal(size=n)                      # DC offset
    return torch.from_numpy(wav).to(cuda)


def test_mel_kernel_matches_plain(cuda):
    wav = _mel_inputs(cuda)
    before = mel_power.launches
    out = mel_power(wav)
    torch.cuda.synchronize()
    assert mel_power.launches == before + 1
    ref = mel_power_ref(wav)
    assert out.shape == ref.shape == (5, 3000, 80)
    assert torch.isfinite(out).all()
    assert torch.equal(out[2], torch.zeros_like(out[2]))  # exact zeros
    for b in (0, 1, 3, 4):
        rel = ((out[b] - ref[b]).abs().max() / ref[b].abs().max()).item()
        assert rel <= MEL_TOL, (b, rel)
    d_log = (log_mel_from_power(out) - log_mel_from_power(ref)).abs().max()
    assert d_log.item() <= LOG_MEL_TOL, d_log.item()


def test_mel_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="480000"):
        mel_power(torch.zeros(1, 16000, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        mel_power(torch.zeros(1, 480000, device=cuda, dtype=torch.float64))
