"""Kernels B1 (csrc/flash_attention_fwd.cu), B2 (csrc/mel_power_fwd.cu) and
B3 (csrc/flash_attention_causal.cu) against their plain versions, on the
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


# key lengths around the 64-key tiles of the bf16 kernel (only the tile that
# holds kv_len is masked), a filler row, and lengths past T (cut to T)
B1_LENS = (0, 1, 63, 64, 65, 130, 499)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("T", [130, 499])
def test_kernel_key_lengths_around_tile_edges(cuda, dtype, hd, T):
    kv_len = torch.tensor(B1_LENS, dtype=torch.int32, device=cuda)
    q, k, v = _inputs(cuda, len(B1_LENS), T, 3, hd, dtype, seed=4)
    out = flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= TOL[dtype], rel
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_pad_values_never_read(cuda, dtype, hd):
    """NaN in the pad rows of K and V changes nothing: every row stays
    finite and equal to the plain version on the clean inputs."""
    kv_len = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    q, k, v = _inputs(cuda, 2, 130, 2, hd, dtype, seed=1)
    base = flash_attention(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate((100, 7)):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    out = flash_attention(q, k2, v2, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(out, base)
    assert torch.isfinite(out).all()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_strided_fused_qkv(cuda, dtype, hd):
    """q, k, v as slices of one fused (B, T, 3, nh, hd) tensor."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(3, 77, 3, 2, hd))
                           .astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv.unbind(2)
    kv_len = torch.tensor([77, 30, 0], dtype=torch.int32, device=cuda)
    out = flash_attention(q, k, v, kv_len)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= TOL[dtype], rel
    assert torch.equal(out[2], torch.zeros_like(out[2]))


def test_cuda_tensors_never_fall_back(cuda):
    q, k, v = _inputs(cuda, 1, 16, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v, torch.tensor([16], dtype=torch.int32,
                                              device=cuda))


# B2: max |kernel - ref| / max |ref| per clip. Both sides are fp32 FFTs
# (the kernel's own, the reference's cuFFT), so they differ by rounding only
# (~5e-7 of the clip's peak power at these inputs)
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


def _mel_edge_clips(B):
    """B clips cycling through: impulses at the first and last sample and
    around frame (160-sample) and block (32-frame) edges, a full-scale +-1
    square wave, a DC clip, a zero clip and noise."""
    n = 480000
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(5)
    imp = np.zeros(n, np.float32)
    for i in (0, 1, 159, 160, 161, 399, 400, 5119, 5120, 5121, 93 * 5120 - 1,
              93 * 5120, n - 161, n - 160, n - 2, n - 1):
        imp[i] = 1.0
    kinds = [imp, np.sign(np.sin(2 * np.pi * 200 * t + 0.1)).astype(np.float32),
             np.full(n, 0.7, np.float32), np.zeros(n, np.float32),
             (rng.normal(size=n) * 0.1).astype(np.float32)]
    return np.stack([kinds[b % len(kinds)] for b in range(B)])


@pytest.mark.parametrize("B", [1, 3, 13])
def test_mel_kernel_edges_and_partial_grid(cuda, B):
    """Clip counts that leave the grid's tail partial, and inputs that hit
    the reflect padding, the frame and block edges and full scale; the zero
    clip exactly zero."""
    wav = torch.from_numpy(_mel_edge_clips(B)).to(cuda)
    out = mel_power(wav)
    torch.cuda.synchronize()
    ref = mel_power_ref(wav)
    assert torch.isfinite(out).all()
    for b in range(B):
        if b % 5 == 3:
            assert torch.equal(out[b], torch.zeros_like(out[b]))
            continue
        rel = ((out[b] - ref[b]).abs().max() / ref[b].abs().max()).item()
        assert rel <= MEL_TOL, (b, rel)
    d_log = (log_mel_from_power(out) - log_mel_from_power(ref)).abs().max()
    assert d_log.item() <= LOG_MEL_TOL, d_log.item()


def test_mel_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="480000"):
        mel_power(torch.zeros(1, 16000, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        mel_power(torch.zeros(1, 480000, device=cuda, dtype=torch.float64))


# B3 (csrc/flash_attention_causal.cu): forward, lse and dQ/dK/dV against the
# plain version and autograd through it, max |kernel - ref| / max |ref|.
# fp32 differs in summation order only; bf16 rounds P and dS to bf16 inside
# the products and the outputs to 8 mantissa bits
B3_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def _b3_inputs(cuda, dtype, hd, nh=8, nkv=2, lens=(200, 171, 64, 33, 1), S=200,
               seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for n in (nh, nkv, nkv))
    seg = torch.tensor([[1 if t < n else 0 for t in range(S)] for n in lens],
                       dtype=torch.int32, device=cuda)
    dout = torch.from_numpy(rng.normal(size=(B, S, nh, hd))
                            .astype(np.float32)).to(cuda, dtype)
    return q, k, v, seg, dout


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


B3_LENS = (200, 171, 64, 33, 1)   # the last row is all padding after position 0
# (hd, nh, nkv, lens, S): GQA groups 1, 2, 4, 7 and 8 at hd 64 and 128 (the
# bf16 dK/dV kernel then runs clusters of as many blocks,
# ops/flash_attention_causal.dkv_cluster); groups 16 and 11, where a block
# walks several query heads (clusters of 8 blocks with 2 heads each, and of
# 1 block with 11); S 97 and 480, not multiples of 64; one long row
B3_CASES = [
    (64, 8, 2, B3_LENS, 200), (128, 4, 4, B3_LENS, 200),
    *((hd, nh, nkv, B3_LENS, 200) for hd in (64, 128)
      for nh, nkv in ((8, 8), (8, 4), (28, 4), (32, 4))),
    (64, 32, 2, B3_LENS, 200), (128, 11, 1, B3_LENS, 200),
    (64, 28, 4, (97, 60, 1), 97), (128, 32, 4, (480, 333, 129, 64), 480),
    (64, 32, 4, (2048,), 2048),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,nh,nkv,lens,S", B3_CASES)
def test_b3_kernels_match_plain(cuda, dtype, hd, nh, nkv, lens, S):
    from mertools_tpu_torch.ops import flash_attention_causal as fc

    q, k, v, seg, dout = _b3_inputs(cuda, dtype, hd, nh, nkv, lens, S)
    fwd_tol, grad_tol = B3_TOL[dtype]
    n0 = [f.launches for f in (fc.flash_attention_causal_fwd,
                               fc.flash_attention_causal_bwd_prep,
                               fc.flash_attention_causal_bwd_dkv,
                               fc.flash_attention_causal_bwd_dq)]
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fc.flash_attention_causal(*qk, seg)
    out.backward(dout)
    torch.cuda.synchronize()
    n1 = [f.launches for f in (fc.flash_attention_causal_fwd,
                               fc.flash_attention_causal_bwd_prep,
                               fc.flash_attention_causal_bwd_dkv,
                               fc.flash_attention_causal_bwd_dq)]
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1]

    ref_in = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref, ref_lse = fc.causal_attention_fwd_ref(*ref_in, seg)
    ref.backward(dout.float())
    _, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= fwd_tol
    # lse is fp32 on both sides; bf16 moves it only through the bf16 q, k
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for name, got, want in zip("qkv", qk, ref_in):
        assert _rel(got.grad, want.grad) <= grad_tol, name

    # dK/dV and dQ alone against their plain versions on the same lse and
    # di, and bit for bit the same on a second launch (the group's dK/dV sum
    # has a fixed order)
    di = fc.flash_attention_causal_bwd_prep(out.detach(), dout)
    args = (q, k, v, seg, dout, lse, di)
    dk, dv = fc.flash_attention_causal_bwd_dkv(*args)
    dq = fc.flash_attention_causal_bwd_dq(*args)
    dk2, dv2 = fc.flash_attention_causal_bwd_dkv(*args)
    dq2 = fc.flash_attention_causal_bwd_dq(*args)
    torch.cuda.synchronize()
    for got, want in zip((dk, dv, dq), (*fc.bwd_dkv_ref(*args),
                                        fc.bwd_dq_ref(*args))):
        assert _rel(got, want) <= grad_tol
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_b3_packed_and_repeated_segments(cuda, dtype, hd):
    """Segments other than right padding: packed runs (1, 2, 3), an id that
    comes back after another (5, 0, 5, 0: the second run of 5 reaches the
    first), and one segment throughout; the forward starts a uniform query
    tile's walk at its segment's first key, so these hold that start."""
    from mertools_tpu_torch.ops import flash_attention_causal as fc

    S = 256
    runs = [[(1, 70), (2, 130), (3, 56)], [(5, 64), (0, 64), (5, 64), (0, 64)],
            [(7, 256)]]
    seg = torch.tensor([[i for i, n in row for _ in range(n)] for row in runs],
                       dtype=torch.int32, device=cuda)
    q, k, v, _, dout = _b3_inputs(cuda, dtype, hd, 8, 2, lens=(S,) * 3, S=S, seed=5)
    fwd_tol, grad_tol = B3_TOL[dtype]
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fc.flash_attention_causal(*qk, seg)
    out.backward(dout)
    _, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    torch.cuda.synchronize()
    ref_in = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref, ref_lse = fc.causal_attention_fwd_ref(*ref_in, seg)
    ref.backward(dout.float())
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= fwd_tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for name, got, want in zip("qkv", qk, ref_in):
        assert _rel(got.grad, want.grad) <= grad_tol, name


def test_b3_ragged_length_not_a_tile_multiple(cuda):
    """S = 97 (not a multiple of 32 or 64), one row fully padded but row 0."""
    from mertools_tpu_torch.ops import flash_attention_causal as fc

    q, k, v, seg, dout = _b3_inputs(cuda, torch.float32, 64, 4, 1,
                                    lens=(97, 1), S=97, seed=3)
    out, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    ref, ref_lse = fc.causal_attention_fwd_ref(q, k, v, seg)
    assert _rel(out, ref) <= 1e-5
    di = fc.flash_attention_causal_bwd_prep(out, dout)
    assert _rel(di, fc.bwd_prep_ref(out, dout)) <= 1e-5
    dk, dv = fc.flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di)
    rdk, rdv = fc.bwd_dkv_ref(q, k, v, seg, dout, lse, di)
    dq = fc.flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di)
    assert _rel(dk, rdk) <= 1e-4 and _rel(dv, rdv) <= 1e-4
    assert _rel(dq, fc.bwd_dq_ref(q, k, v, seg, dout, lse, di)) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,nh", [(64, 32), (128, 28)])
@pytest.mark.parametrize("S", [97, 512])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_b3_di_matches_plain_and_is_deterministic(cuda, dtype, hd, nh, S, layout):
    """The di pre-pass against its plain version at the training head
    counts, S not a multiple of its 32-token tiles, on contiguous tensors
    and on strided views (O with its heads 2 hd apart, dO in the
    (B, nh, S, hd) layout transposed), and bit for bit across launches."""
    from mertools_tpu_torch.ops import flash_attention_causal as fc

    rng = np.random.default_rng(6)
    B = 3
    if layout == "contiguous":
        o, dout = (torch.from_numpy(rng.normal(size=(B, S, nh, hd)).astype(
            np.float32)).to(cuda, dtype) for _ in range(2))
    else:
        o = torch.from_numpy(rng.normal(size=(B, S, nh, 2 * hd)).astype(
            np.float32)).to(cuda, dtype)[..., :hd]
        dout = torch.from_numpy(rng.normal(size=(B, nh, S, hd)).astype(
            np.float32)).to(cuda, dtype).transpose(1, 2)
    before = fc.flash_attention_causal_bwd_prep.launches
    di = fc.flash_attention_causal_bwd_prep(o, dout)
    di2 = fc.flash_attention_causal_bwd_prep(o, dout)
    torch.cuda.synchronize()
    assert fc.flash_attention_causal_bwd_prep.launches == before + 2
    assert di.shape == (B, nh, S) and di.is_contiguous()
    assert _rel(di, fc.bwd_prep_ref(o, dout)) <= 1e-5
    assert torch.equal(di, di2)


def test_b3_cuda_tensors_never_fall_back(cuda):
    from mertools_tpu_torch.ops.flash_attention_causal import \
        flash_attention_causal

    q, k, v, seg, _ = _b3_inputs(cuda, torch.float32, 64)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_causal(q[..., :32], k[..., :32], v[..., :32], seg)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_causal(q.half(), k.half(), v.half(), seg)
