"""Kernel B1 (csrc/flash_attention_fwd.cu) against its plain version, on the
card. Needs an NVIDIA Hopper GPU and nvcc; elsewhere every test skips.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from mertools_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_ref)

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
