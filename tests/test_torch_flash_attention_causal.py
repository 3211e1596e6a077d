"""The plain version of kernel B3 (``causal_attention_ref``) against the
library's ``mha_reference`` (the reference the JAX flash kernel is held to),
forward and through ``jax.grad`` (dq, dk, dv), in fp32: GQA, right padding
with the pad rows included, S not a multiple of 128. Also the per-kernel
plain versions of the backward (di, dK/dV, dQ) against autograd, and the
wrapper's argument check. The CUDA kernels run only on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from mertools_tpu_torch.ops import flash_attention_causal as fc

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-5, 1e-4   # of max |ref|: fp32 summation order only
LENS = (200, 137, 64, 1)         # right padding; S = 200 is not a multiple of 128


def _inputs(nh=4, nkv=2, hd=64, S=200, seed=0):
    rng = np.random.default_rng(seed)
    B = len(LENS)
    q = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    seg = np.array([[1 if t < n else 0 for t in range(S)] for n in LENS], np.int32)
    dout = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    return q, k, v, seg, dout


def _jax_ref(q, k, v, seg):
    """The library reference on the JAX call site's layout: (B, nh, S, hd),
    kv heads repeated as llm.py:173-176 repeats them. ``mha_reference``'s
    custom VJP takes only sm_scale 1, so this differentiates its body,
    ``mha_reference_no_custom_vjp``, at HIGHEST precision (on the CPU the
    two forwards agree bit for bit)."""
    rep = q.shape[2] // k.shape[2]
    qh, kh, vh = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    kh, vh = jnp.repeat(kh, rep, axis=1), jnp.repeat(vh, rep, axis=1)
    segs = lib.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    with jax.default_matmul_precision("highest"):
        out = lib.mha_reference_no_custom_vjp(
            qh, kh, vh, None, segs, causal=True,
            sm_scale=1.0 / math.sqrt(q.shape[-1]))
    return out.transpose(0, 2, 1, 3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def case():
    q, k, v, seg, dout = _inputs()
    ref, vjp = jax.vjp(lambda q, k, v: _jax_ref(q, k, v, seg), q, k, v)
    grads = vjp(jnp.asarray(dout))
    return (q, k, v, seg, dout), np.asarray(ref), [np.asarray(g) for g in grads]


def test_forward_matches_mha_reference(case):
    (q, k, v, seg, _), ref, _ = case
    got = fc.causal_attention_ref(*map(torch.from_numpy, (q, k, v, seg)))
    assert _rel(got.numpy(), ref) <= FWD_TOL   # every row, pad rows included
    assert np.isfinite(got.numpy()).all()


def test_gradients_match_jax_grad(case):
    (q, k, v, seg, dout), _, grads = case
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fc.flash_attention_causal(*ts, torch.from_numpy(seg)).backward(
        torch.from_numpy(dout))
    for name, t, g in zip("qkv", ts, grads):
        assert _rel(t.grad.numpy(), g) <= GRAD_TOL, name


def test_kernel_plain_versions_match_autograd(case):
    """di, dK/dV and dQ, as the kernels compute them from the saved lse,
    against autograd through causal_attention_ref."""
    (q, k, v, seg, dout), _, grads = case
    q, k, v, seg, dout = map(torch.from_numpy, (q, k, v, seg, dout))
    out, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    di = fc.flash_attention_causal_bwd_prep(out, dout)
    assert di.shape == (4, 4, 200) and di.dtype == torch.float32
    dk, dv = fc.flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di)
    dq = fc.flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di)
    for name, got, g in zip("qkv", (dq, dk, dv), grads):
        assert _rel(got.numpy(), g) <= GRAD_TOL, name


def test_logsumexp_is_the_row_normaliser():
    q, k, v, seg = map(torch.from_numpy, _inputs(S=40, seed=1)[:4])
    _, lse = fc.causal_attention_fwd_ref(q, k, v, seg)
    logits = torch.einsum("bqnd,bknd->bnqk", q,
                          k.repeat_interleave(2, dim=2)) / math.sqrt(64)
    mask = (seg[:, :, None] == seg[:, None, :]) & torch.ones(40, 40).tril().bool()
    want = torch.logsumexp(logits.masked_fill(~mask[:, None], -math.inf), -1)
    assert torch.allclose(lse, want, atol=1e-5)


def test_pad_rows_attend_to_earlier_pad_keys():
    """A pad row's output is the softmax over pad keys up to itself: the
    first pad row reproduces its own value row exactly."""
    q, k, v, seg = map(torch.from_numpy, _inputs(nh=2, nkv=2, S=50, seed=2)[:4])
    out = fc.causal_attention_ref(q, k, v, seg)
    first_pad = 1 + int(seg[3].nonzero().max()) if seg[3].any() else 0
    assert torch.allclose(out[3, first_pad], v[3, first_pad], atol=1e-6)
    # valid rows never see pads: changing pad keys leaves them unchanged
    k2, v2 = k.clone(), v.clone()
    k2[1, 37:] += 5.0
    v2[1, 37:] -= 3.0
    out2 = fc.causal_attention_ref(q, k2, v2, seg)
    assert torch.equal(out2[1, :37], out[1, :37])


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v, seg, dout = map(torch.from_numpy, _inputs(S=32))
    counts = [f.launches for f in (fc.flash_attention_causal_fwd,
                                   fc.flash_attention_causal_bwd_prep,
                                   fc.flash_attention_causal_bwd_dkv,
                                   fc.flash_attention_causal_bwd_dq)]
    qq = q.clone().requires_grad_()
    out = fc.flash_attention_causal(qq, k, v, seg)
    out.backward(dout)
    assert torch.equal(out, fc.causal_attention_ref(q, k, v, seg))
    assert counts == [f.launches for f in (fc.flash_attention_causal_fwd,
                                           fc.flash_attention_causal_bwd_prep,
                                           fc.flash_attention_causal_bwd_dkv,
                                           fc.flash_attention_causal_bwd_dq)]


def _ok_args(B=2, S=8, nh=4, nkv=2, hd=64, dtype=torch.float32):
    q = torch.zeros(B, S, nh, hd, dtype=dtype)
    k = torch.zeros(B, S, nkv, hd, dtype=dtype)
    return q, k, k.clone(), torch.ones(B, S, dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("hd", "head dim"),
    ("dtype", "dtypes"),
    ("mixed_dtype", "dtypes"),
    ("groups", "multiple"),
    ("kv_shape", "k, v must be"),
    ("rank", r"\(B, S, heads, hd\)"),
    ("head_stride", "contiguous"),
    ("seg_dtype", "seg"),
    ("seg_shape", "seg"),
    ("bf16_offset", "16-byte"),
    ("fp32_offset", "16-byte"),
    ("fp32_stride", "16-byte"),
])
def test_check_kernel_args_rejects(case, match):
    q, k, v, seg = _ok_args()
    fc.check_kernel_args(q, k, v, seg)  # the good case passes
    if case == "hd":
        q, k, v, seg = _ok_args(hd=32)
    elif case == "dtype":
        q, k, v, seg = _ok_args(dtype=torch.float16)
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "groups":
        q, k, v, seg = _ok_args(nh=4, nkv=3)
    elif case == "kv_shape":
        v = v[:, :4]
    elif case == "rank":
        q = q[0]
    elif case == "head_stride":
        q = torch.zeros(2, 8, 64, 4).transpose(2, 3)
    elif case == "seg_dtype":
        seg = seg.long()
    elif case == "seg_shape":
        seg = seg[:, :4]
    elif case == "bf16_offset":
        q, k, v, seg = _ok_args(dtype=torch.bfloat16)
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    elif case == "fp32_offset":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    elif case == "fp32_stride":   # heads 66 floats apart: rows 8-byte aligned
        q = torch.zeros(2, 8, 4, 66)[..., :64]
    with pytest.raises(ValueError, match=match):
        fc.check_kernel_args(q, k, v, seg)


@pytest.mark.parametrize("nh,nkv,want", [
    (8, 8, 1), (8, 4, 2), (8, 2, 4), (28, 4, 7), (32, 4, 8),  # groups 1-8
    (32, 2, 8), (11, 1, 1), (18, 1, 6), (48, 4, 6), (64, 2, 8)])  # 16, 11, 18, 12, 32
def test_dkv_cluster_is_the_largest_group_divisor_up_to_8(nh, nkv, want):
    """The one value the host plans for the bf16 dK/dV kernel: blocks per
    cluster, a divisor of the GQA group of at most 8 (the portable cluster
    size), the largest such; each block then takes group / cluster heads.
    Tile coverage is the card tests' (every row against the plain version)."""
    group, cluster = nh // nkv, fc.dkv_cluster(nh, nkv)
    assert cluster == want
    assert group % cluster == 0 and cluster <= 8
    assert all(group % c for c in range(cluster + 1, 9))
