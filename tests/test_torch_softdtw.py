"""The port's soft-DTW (ops/softdtw.py: the plain versions of K2 and K3 and
the two differentiable ops) against the JAX package's scan ``softdtw``,
``jax.grad`` of it, and its Pallas kernels run in interpret mode, at the
shapes of tests/test_softdtw.py.

Tolerances: rtol 1e-5 on the value and atol 1e-5 on E at gamma = 1 (the
same f32 recursion; the exp/log of two libraries differ in the last bits);
E's exponents are (R[s] - R - D[s]) / gamma, so at gamma < 1 the rounding
of R is scaled up and E's tolerance is 1e-5 / gamma.  Cells outside the
band have E exactly 0, with no NaN anywhere."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu.ops import softdtw as SD
from tacotron2_subword_tpu_torch.ops import softdtw as TS

# (B, N, M), bandwidth, gamma
CASES = [((3, 8, 11), 0.0, 1.0), ((2, 9, 9), 2.0, 1.0),
         ((2, 14, 14), 4.0, 1.0), ((3, 17, 15), 0.0, 1.0),
         ((2, 24, 24), 5.0, 1.0), ((2, 20, 30), 12.0, 1.0),
         ((3, 9, 7), 0.0, 0.1), ((2, 1, 6), 0.0, 1.0)]


def _dist(shape, seed=0, dim=2):
    rng = np.random.default_rng(seed)
    B, N, M = shape
    x = rng.standard_normal((B, N, dim), dtype=np.float32)
    y = rng.standard_normal((B, M, dim), dtype=np.float32)
    return x, y, np.array(SD.euclidean_dist_matrix(jnp.asarray(x),
                                                   jnp.asarray(y)))


def _jax_value_and_grad(D, gamma, bw):
    v = np.asarray(SD.softdtw(jnp.asarray(D), gamma, bw))
    g = np.asarray(jax.grad(lambda d: jnp.sum(SD.softdtw(d, gamma, bw)))(
        jnp.asarray(D)))
    return v, g


def _check(v, E, v_ref, E_ref, bw, N, M, gamma=1.0):
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    np.testing.assert_allclose(E, E_ref, rtol=0, atol=1e-5 / gamma)
    assert not np.isnan(E).any()
    band = TS.band_mask(N, M, bw).numpy()
    assert (E[:, ~band] == 0).all()


@pytest.mark.parametrize("shape,bw,gamma", CASES)
def test_plain_kernels_match_jax_scan(shape, bw, gamma):
    """softdtw_grad / softdtw_value on CPU tensors (K2's and K3's plain
    versions) against the scan and jax.grad of it."""
    _, _, D = _dist(shape)
    v_ref, g_ref = _jax_value_and_grad(D, gamma, bw)
    v, E = TS.softdtw_grad(torch.from_numpy(D), gamma, bw)
    _check(v.numpy(), E.numpy(), v_ref, g_ref, bw, *shape[1:], gamma)
    np.testing.assert_allclose(
        TS.softdtw_value(torch.from_numpy(D), gamma, bw).numpy(), v_ref,
        rtol=1e-5)


@pytest.mark.parametrize("shape,bw", [((3, 17, 15), 0.0), ((2, 24, 24), 5.0),
                                      ((2, 20, 30), 12.0)])
def test_plain_kernels_match_pallas_interpret(shape, bw):
    """K2's and K3's plain versions against the TPU kernels themselves
    (softdtw_pallas_grad, softdtw_pallas), run in interpret mode."""
    _, _, D = _dist(shape, seed=1)
    v_pal, E_pal = SD.softdtw_pallas_grad(jnp.asarray(D), 1.0, bw,
                                          interpret=True)
    v3_pal = SD.softdtw_pallas(jnp.asarray(D), 1.0, bw, interpret=True)
    v, E = TS.softdtw_grad_plain(torch.from_numpy(D), 1.0, bw)
    _check(v.numpy(), E.numpy(), np.asarray(v_pal), np.asarray(E_pal), bw,
           *shape[1:])
    np.testing.assert_allclose(
        TS.softdtw_value_plain(torch.from_numpy(D), 1.0, bw).numpy(),
        np.asarray(v3_pal), rtol=1e-5)


@pytest.mark.parametrize("op", ["softdtw_diff", "softdtw"])
@pytest.mark.parametrize("shape,bw,gamma", CASES[1:4])
def test_differentiable_ops_match_jax_grad(op, shape, bw, gamma):
    """Autograd through softdtw_diff (K2's E) and softdtw (the plain
    reverse wavefront), with an upstream gradient that is not all ones."""
    _, _, D = _dist(shape, seed=2)
    w = np.linspace(0.5, 2.0, shape[0]).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda d: jnp.sum(
        SD.softdtw(d, gamma, bw) * w))(jnp.asarray(D)))
    Dt = torch.from_numpy(D).requires_grad_(True)
    val = getattr(TS, op)(Dt, gamma, bw)
    (val * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(val.detach().numpy(),
                               np.asarray(SD.softdtw(jnp.asarray(D), gamma,
                                                     bw)), rtol=1e-5)
    np.testing.assert_allclose(Dt.grad.numpy(), g_ref, rtol=0, atol=1e-5)
    assert not torch.isnan(Dt.grad).any()


def test_diff_takes_k2_with_grad_and_k3_without(monkeypatch):
    """softdtw_diff runs K2 (value and E) where D needs a gradient, K3
    under no_grad or on a tensor that needs none."""
    calls = []
    grad, value = TS.softdtw_grad, TS.softdtw_value
    monkeypatch.setattr(TS, "softdtw_grad",
                        lambda *a: (calls.append("k2"), grad(*a))[1])
    monkeypatch.setattr(TS, "softdtw_value",
                        lambda *a: (calls.append("k3"), value(*a))[1])
    D = torch.from_numpy(_dist((2, 5, 6))[2]).requires_grad_(True)
    TS.softdtw_diff(D)
    with torch.no_grad():
        TS.softdtw_diff(D)
    TS.softdtw_diff(D.detach())
    assert calls == ["k2", "k3", "k3"]


def test_euclidean_dist_matrix_matches_jax():
    x, y, D = _dist((3, 7, 9), seed=3, dim=5)
    np.testing.assert_allclose(
        TS.euclidean_dist_matrix(torch.from_numpy(x),
                                 torch.from_numpy(y)).numpy(), D,
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_softdtw_distance_matches_jax(normalize):
    x, y, _ = _dist((2, 7, 10), seed=4, dim=3)
    ref = SD.softdtw_distance(jnp.asarray(x), jnp.asarray(y), gamma=0.5,
                              bandwidth=0.0, normalize=normalize)
    out = TS.softdtw_distance(torch.from_numpy(x), torch.from_numpy(y),
                              gamma=0.5, normalize=normalize)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if normalize:  # a sequence against itself
        same = TS.softdtw_distance(torch.from_numpy(x), torch.from_numpy(x),
                                   normalize=True)
        np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-3)


@pytest.mark.parametrize("bad", ["dtype", "rank"])
def test_wrappers_reject_bad_arguments(bad):
    D = torch.rand(2, 4, 5)
    D = D.double() if bad == "dtype" else D[0]
    for fn in (TS.softdtw_grad, TS.softdtw_value):
        with pytest.raises((TypeError, ValueError)):
            fn(D)
