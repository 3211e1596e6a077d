"""The port's int8 quantization (mertools_tpu_torch/ops/quant.py) against
the JAX module: codes and scales bit-equal (half-to-even rounding on both
sides), the w8a8 product with int32 accumulation through ``torch._int_mm``
(operands padded to the sizes it takes), and the weight-only product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.ops import quant as jq
from mertools_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _x(shape, seed, scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    x.flat[::7] = np.round(x.flat[::7] * 2) / 2   # exact .5 codes after scaling
    return x


@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_int8_bit_equal(axis):
    x = _x((6, 13), 0)
    x[2] = 0.0   # an all-zero row or column takes the 1e-8 floor
    jqv, js = jq.quantize_int8(jnp.asarray(x), axis)
    tqv, ts = tq.quantize_int8(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_weight_w8_bit_equal():
    w = _x((24, 10), 1, 0.2)            # JAX kernel (K, N); the port takes (N, K)
    pk = jq.quantize_weight_w8(jnp.asarray(w))
    q, s = tq.quantize_weight_w8(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pk["q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(pk["scale"]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32


@pytest.mark.parametrize("lead,K,N", [((3, 7), 16, 9), ((20,), 24, 32), ((2,), 5, 3)])
def test_int8_dot_general_matches_jax(lead, K, N):
    """Shapes below and at _int_mm's limits (M <= 16, K and N not multiples
    of 8) give JAX's result: the padded int32 sums are exact."""
    lhs, rhs = _x((*lead, K), 2), _x((K, N), 3, 1.0)
    want = np.asarray(jq.int8_dot_general(jnp.asarray(lhs), jnp.asarray(rhs),
                                          (((len(lead),), (0,)), ((), ()))))
    got = tq.int8_dot_general(torch.from_numpy(lhs), torch.from_numpy(rhs))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_int_mm_is_exact_in_int32():
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(5, 11)).astype(np.int8)
    b = rng.integers(-127, 128, size=(11, 6)).astype(np.int8)
    got = tq.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


def test_w8_linear_matches_w8_einsum():
    w, x = _x((16, 12), 5, 0.2), _x((4, 16), 6, 1.0)
    pk = jq.quantize_weight_w8(jnp.asarray(w))
    want = np.asarray(jq.w8_einsum("bd,df->bf", jnp.asarray(x), pk))
    q, s = tq.quantize_weight_w8(torch.from_numpy(w.T.copy()))
    got = tq.w8_linear(torch.from_numpy(x), q, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # bf16 activations: the codes are cast to bf16, the output stays bf16
    assert tq.w8_linear(torch.from_numpy(x).bfloat16(), q, s).dtype == torch.bfloat16
