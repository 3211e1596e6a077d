"""The plain version of kernel B1 (``flash_attention_ref``) against the JAX
package's XLA attention — the reference JAX's own flash test holds the
Pallas kernel against (tests/test_encoder_parity.py:162-191) — plus the
semantics the CUDA kernel shares with it and the wrapper's argument check.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py
and chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import wav2vec2 as jw
from mertools_tpu_torch.encoders import wav2vec2 as tw
from mertools_tpu_torch.ops.flash_attention import (
    check_kernel_args, flash_attention, flash_attention_ref)

torch.set_num_threads(1)

KV_LEN = np.array([37, 64, 1, 0, 50], np.int32)  # ragged, incl. 1 and 0


def _qkv(rng, B=5, T=64, nh=2, hd=64):
    q, k, v = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
               for _ in range(3))
    return q * hd ** -0.5, k, v


@pytest.mark.parametrize("hd", [32, 64])
def test_ref_matches_jax_xla_attention(hd):
    """Port ``_Attention`` on the flash path (CPU -> flash_attention_ref)
    against JAX ``_Attention`` with the -1e30 key bias, on valid rows."""
    nh, T = 2, 64
    cfg = jw.Wav2Vec2Config(hidden_size=nh * hd, num_attention_heads=nh)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(len(KV_LEN), T, nh * hd)).astype(np.float32)
    mask = np.arange(T)[None, :] < KV_LEN[:, None]
    bias = np.where(mask[:, None, None, :], 0.0, -1e30).astype(np.float32)
    att = jw._Attention(cfg)
    params = att.init(jax.random.PRNGKey(0), x, bias)["params"]
    ref = np.asarray(att.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(bias)))

    tcfg = tw.Wav2Vec2Config(**{**dataclasses.asdict(cfg),
                                "use_flash_attention": True})
    port = tw._Attention(tcfg)
    port.load_state_dict({
        f"{n}.{w}": torch.from_numpy(np.array(
            params[n]["kernel"].T if w == "weight" else params[n]["bias"]))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj")
        for w in ("weight", "bias")})
    with torch.no_grad():
        got = port(torch.from_numpy(x), None,
                   torch.from_numpy(KV_LEN)).numpy()
    for b, n in enumerate(KV_LEN):
        if n > 0:
            err = np.abs(got[b, :n] - ref[b, :n]).max()
            assert err <= 1e-5, (b, err)


@pytest.mark.parametrize("pad", [np.nan, 1e4])
def test_pad_keys_and_values_do_not_reach_valid_rows(pad):
    q, k, v = _qkv(np.random.default_rng(1))
    kv = torch.from_numpy(KV_LEN)
    base = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), kv)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(KV_LEN):
        k2[b, n:] = pad
        v2[b, n:] = pad
    got = flash_attention_ref(*map(torch.from_numpy, (q, k2, v2)), kv)
    assert torch.isfinite(got).all()
    for b, n in enumerate(KV_LEN):
        assert torch.equal(got[b, :n], base[b, :n]), b
    # query rows past kv_len attend to the valid keys: finite, not zero
    assert got[0, 37:].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_length_rows_are_zeros(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(np.random.default_rng(2)))
    out = flash_attention(q, k, v, torch.from_numpy(KV_LEN))
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    assert torch.isfinite(out).all()


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(3)))
    kv = torch.from_numpy(KV_LEN)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_ref(q, k, v, kv))


def _ok_args(B=2, T=8, nh=2, hd=64, dtype=torch.float32):
    q = torch.zeros(B, T, nh, hd, dtype=dtype)
    return q, q.clone(), q.clone(), torch.full((B,), T, dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("hd", "head dim"),
    ("dtype", "dtypes"),
    ("mixed_dtype", "dtypes"),
    ("head_stride", "contiguous"),
    ("kv_dtype", "kv_len"),
    ("kv_shape", "kv_len"),
    ("rank", r"\(B, T, nh, hd\)"),
    ("shape", "shapes differ"),
    ("bf16_offset", "16-byte"),
    ("bf16_stride", "16-byte"),
])
def test_check_kernel_args_rejects(case, match):
    q, k, v, kv = _ok_args()
    check_kernel_args(q, k, v, kv)  # the good case passes
    if case == "hd":
        q, k, v, kv = _ok_args(hd=48)
    elif case == "dtype":
        q, k, v, kv = _ok_args(dtype=torch.float16)
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "head_stride":
        # (B, T, nh, hd) view whose head dimension is strided
        q = torch.zeros(2, 8, 64, 2).transpose(2, 3)
    elif case == "kv_dtype":
        kv = kv.long()
    elif case == "kv_shape":
        kv = kv[:1]
    elif case == "rank":
        q = q[0]
    elif case == "shape":
        v = v[:, :4]
    elif case == "bf16_offset":  # rows start 2 bytes past a 16-byte boundary
        q, k, v, kv = _ok_args(dtype=torch.bfloat16)
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    elif case == "bf16_stride":  # time stride of 130 elements
        q, k, v, kv = _ok_args(dtype=torch.bfloat16)
        q = torch.zeros(2 * 8 * 130, dtype=torch.bfloat16).as_strided(
            q.shape, (8 * 130, 130, 64, 1))
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, k, v, kv)


def test_strided_head_layout_is_accepted():
    """The kernel reads (B, T, nh, hd) through strides: a slice of a fused
    qkv projection passes the check as long as hd is contiguous."""
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(2, 8, 3, 2, 64, dtype=dtype)
        q, k, v = qkv.unbind(2)
        check_kernel_args(q, k, v, torch.full((2,), 8, dtype=torch.int32))
