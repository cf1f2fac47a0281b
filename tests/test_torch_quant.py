"""Port of ops/quant.py: int8 quantization and the plain version of K1,
against the JAX package (its reference path and its Pallas kernel in
interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tacotron2_subword_tpu.ops import quant as Q
from tacotron2_subword_tpu_torch.ops import quant as TQ


def _weights(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((64, 96), 0), ((2, 40, 24), 1)])
def test_quantize_int8_bit_equal_to_jax(shape, axis, dtype):
    """Same f32 amax/floor/division and round-half-to-even: bit-equal."""
    w = _weights(shape, 0)
    w[0, 0] = 0.0  # a zero, and a half-way value after scaling
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = Q.quantize_int8(jw, axis=axis)
    tq, ts = TQ.quantize_int8(tw, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_matmul_matches_jax_ref(x_dtype):
    """Both sum the same f32 products (bf16 x int8 is exact in f32); only
    the summation order differs: 1e-5 relative to the output's scale."""
    rng = np.random.RandomState(1)
    S, B, K, N = 2, 5, 46, 80
    x = rng.randn(S, B, K).astype(np.float32)
    jq, js = Q.quantize_int8(jnp.asarray(_weights((S, K, N), 2)), axis=1)
    jx = jnp.asarray(x).astype(x_dtype)
    ref = np.asarray(Q._ref_matmul(jx, jq, js))
    out = TQ.matmul_dequant_int8_plain(
        torch.from_numpy(x).to(getattr(torch, x_dtype)),
        torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_plain_matmul_matches_pallas_interpret():
    """The TPU kernel run in interpret mode (a shape that tiles: N % 512,
    K % 8) against the port's plain version: f32 sums, 1e-5 relative."""
    rng = np.random.RandomState(3)
    S, B, K, N = 2, 3, 64, 512
    x = rng.randn(S, B, K).astype(np.float32)
    jq, js = Q.quantize_int8(jnp.asarray(_weights((S, K, N), 4)), axis=1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(Q.matmul_dequant_int8(jx, jq, js, interpret=True))
    out = TQ.matmul_dequant_int8_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 4, 37).astype(np.float32))
    w_q, scale = TQ.quantize_int8(torch.from_numpy(_weights((1, 37, 83), 6)),
                                  axis=1)
    before = TQ.launches
    y = TQ.matmul_dequant_int8(x, w_q, scale)
    assert TQ.launches == before  # the kernel is not launched on the CPU
    torch.testing.assert_close(y, TQ.matmul_dequant_int8_plain(x, w_q, scale),
                               rtol=0, atol=0)
