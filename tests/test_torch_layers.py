"""Port of nn/layers.py against the JAX layers, on the same weights (f32).
Tolerance 1e-5: the same f32 arithmetic, summed in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu.nn import layers as JL
from tacotron2_subword_tpu_torch.nn import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _check(t_out, j_out, **tol):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               **(tol or TOL))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    p = JL.linear_init(jax.random.PRNGKey(0), 12, 7, bias=bias)
    x = _x((3, 5, 12))
    _check(TL.linear_apply(_t(p), torch.from_numpy(x)),
           JL.linear_apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("dilation,padding", [(1, None), (3, None), (1, 0)])
def test_conv1d(dilation, padding):
    p = JL.conv1d_init(jax.random.PRNGKey(1), 6, 9, 5)
    x = _x((2, 6, 17))
    _check(TL.conv1d_apply(_t(p), torch.from_numpy(x), padding=padding,
                           dilation=dilation),
           JL.conv1d_apply(p, jnp.asarray(x), padding=padding,
                           dilation=dilation))


@pytest.mark.parametrize("stride,k", [(8, 16), (2, 4), (3, 3)])
def test_conv_transpose1d(stride, k):
    p = JL.conv_transpose1d_init(jax.random.PRNGKey(2), 6, 4, k, stride)
    x = _x((2, 6, 9))
    pad = (k - stride) // 2
    _check(TL.conv_transpose1d_apply(_t(p), torch.from_numpy(x), stride, pad),
           JL.conv_transpose1d_apply(p, jnp.asarray(x), stride, pad))


def test_batchnorm_eval():
    rng = np.random.RandomState(3)
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5,
              "bias": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32),
             "var": rng.rand(6).astype(np.float32) + 0.1}
    x = _x((2, 6, 11))
    j, _ = JL.batchnorm_apply(params, state, jnp.asarray(x), training=False)
    _check(TL.batchnorm_apply(_t(params), _t(state), torch.from_numpy(x)), j)


def test_weight_norm_fuse():
    p = JL.weight_norm_init(jax.random.PRNGKey(4), (5, 3, 7), init_std=0.3)
    p["g"] = p["g"] * 1.7
    _check(TL.fuse_weight_norm(_t(p))["w"], JL.fuse_weight_norm(p)["w"])


def test_lstm_cell_prepared_single_and_stacked():
    ps = [JL.lstm_cell_init(jax.random.PRNGKey(5 + i), 9, 6) for i in range(2)]
    x, h, c = _x((2, 3, 9), 1), _x((2, 3, 6), 2), _x((2, 3, 6), 3)
    jp = [JL.lstm_prepare(p) for p in ps]
    js = [JL.lstm_cell_prepared(jp[i], jnp.asarray(x[i]), jnp.asarray(h[i]),
                                jnp.asarray(c[i])) for i in range(2)]
    tp = [TL.lstm_prepare(_t(p)) for p in ps]
    # one cell
    th, tc = TL.lstm_cell_prepared(tp[0], torch.from_numpy(x[0]),
                                   torch.from_numpy(h[0]),
                                   torch.from_numpy(c[0]))
    _check(th, js[0][0])
    _check(tc, js[0][1])
    # a stack of two
    stacked = {k: torch.stack([tp[0][k], tp[1][k]]) for k in tp[0]}
    th, tc = TL.lstm_cell_prepared(stacked, torch.from_numpy(x),
                                   torch.from_numpy(h), torch.from_numpy(c))
    _check(th, np.stack([np.asarray(j[0]) for j in js]))
    _check(tc, np.stack([np.asarray(j[1]) for j in js]))


def test_bf16_lstm_gates_are_f32_like_jax(monkeypatch):
    """bf16 weights and inputs: the gate matmul gives f32 gates, as JAX's
    preferred_element_type=float32 does, equal to JAX's to f32 rounding
    (bf16 gates would be off by ~1e-2 relative); h and c then agree to one
    bf16 rounding."""
    bf = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    p = bf(JL.lstm_cell_init(jax.random.PRNGKey(11), 64, 32))
    x, h, c = (bf(jnp.asarray(_x(s, i))) for i, s in
               enumerate(((4, 64), (4, 32), (4, 32)), start=12))
    jp = JL.lstm_prepare(p)
    j_gates = jnp.dot(jnp.concatenate([x, h], axis=-1), jp["w"],
                      preferred_element_type=jnp.float32) + jp["b"]
    jh, jc = JL.lstm_cell_prepared(jp, x, h, c)
    seen = []
    nonlin = TL._lstm_nonlin
    monkeypatch.setattr(TL, "_lstm_nonlin",
                        lambda g, *a: (seen.append(g), nonlin(g, *a))[1])
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    tp = TL.lstm_prepare(jax.tree_util.tree_map(to_t, p))
    th, tc = TL.lstm_cell_prepared(tp, to_t(x), to_t(h), to_t(c))
    assert seen[0].dtype == torch.float32 and th.dtype == torch.bfloat16
    _check(seen[0], j_gates)
    for t_out, j_out in ((th, jh), (tc, jc)):
        np.testing.assert_allclose(t_out.float().numpy(),
                                   np.asarray(j_out, np.float32), rtol=8e-3,
                                   atol=1e-3)


def test_lstm_cell_quant_stacked():
    ps = [JL.lstm_prepare(JL.lstm_cell_init(jax.random.PRNGKey(7 + i), 9, 6))
          for i in range(2)]
    jstack = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), *ps)
    jq = JL.lstm_quantize_stacked(jstack)
    tq = TL.lstm_quantize_stacked(_t(jstack))
    for k in ("w_q", "scale", "b"):
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    x, h, c = _x((2, 4, 9), 4), _x((2, 4, 6), 5), _x((2, 4, 6), 6)
    jh, jc = JL.lstm_cell_quant_stacked(jq, jnp.asarray(x), jnp.asarray(h),
                                        jnp.asarray(c))
    th, tc = TL.lstm_cell_quant_stacked(tq, torch.from_numpy(x),
                                        torch.from_numpy(h),
                                        torch.from_numpy(c))
    _check(th, jh)
    _check(tc, jc)


@pytest.mark.parametrize("lengths", [None, [7, 4, 2]])
def test_bilstm_length_exact(lengths):
    p = JL.bilstm_init(jax.random.PRNGKey(9), 5, 4)
    x = _x((3, 7, 5), 7)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    _check(TL.bilstm_apply(_t(p), torch.from_numpy(x), tl),
           JL.bilstm_apply(p, jnp.asarray(x), jl))


def test_reverse_padded():
    x = _x((3, 6, 2), 8)
    lengths = [6, 3, 1]
    _check(TL._reverse_padded(torch.from_numpy(x), torch.tensor(lengths)),
           JL._reverse_padded(jnp.asarray(x), jnp.asarray(lengths)),
           rtol=0, atol=0)


def test_embedding():
    table = _x((11, 4), 9)
    ids = np.random.RandomState(10).randint(0, 11, (2, 5))
    _check(TL.embedding_apply(torch.from_numpy(table), torch.from_numpy(ids)),
           jnp.asarray(table)[jnp.asarray(ids)], rtol=0, atol=0)
