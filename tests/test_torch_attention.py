"""Port of models/attention.py: the Stepwise Monotonic Attention inference
step against the JAX step on the same weights, both streams stacked as the
decoder runs them.  f32; tolerance 1e-5 (same arithmetic, other order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu.models import attention as JA
from tacotron2_subword_tpu_torch.models import attention as TA

SMA = "StepwiseMonotonicAttention"
B, T, D, Q, A_DIM = 3, 9, 16, 20, 8


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _streams():
    ps = [JA.attention_init(jax.random.PRNGKey(i), SMA, Q, D, A_DIM, 4, 7)
          for i in range(2)]
    rng = np.random.RandomState(0)
    memory = rng.randn(2, B, T, D).astype(np.float32)
    query = rng.randn(2, B, Q).astype(np.float32)
    prev = rng.rand(2, B, T).astype(np.float32)
    prev /= prev.sum(-1, keepdims=True)
    return ps, memory, query, prev


@pytest.mark.parametrize("masked", [False, True])
def test_sma_step_matches_jax(masked):
    ps, memory, query, prev = _streams()
    lengths = np.array([[9, 5, 2], [7, 9, 3]])
    mask = (np.arange(T)[None, None, :] < lengths[:, :, None]
            if masked else None)
    j_out = []
    for s in range(2):
        pm = JA.process_memory(ps[s], jnp.asarray(memory[s]))
        j_out.append(JA.attention_step(
            SMA, ps[s], jnp.asarray(query[s]), jnp.asarray(memory[s]), pm,
            None, None if mask is None else jnp.asarray(mask[s]),
            {"alignment": jnp.asarray(prev[s])}, training=False))

    tp = [_t(p) for p in ps]
    t_pm = torch.stack([TA.process_memory(tp[s], torch.from_numpy(memory[s]))
                        for s in range(2)])
    stacked = jax.tree_util.tree_map(lambda a, b: torch.stack([a, b]), *tp)
    ctx, w, state = TA.attention_step(
        SMA, stacked, torch.from_numpy(query), torch.from_numpy(memory), t_pm,
        None if mask is None else torch.from_numpy(mask),
        {"alignment": torch.from_numpy(prev)})
    for s in range(2):
        np.testing.assert_allclose(ctx[s].numpy(), np.asarray(j_out[s][0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(w[s].numpy(), np.asarray(j_out[s][1]),
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(state["alignment"], w)


def test_init_state_matches_jax():
    j = JA.init_state(SMA, 2, 5)
    t = TA.init_state(SMA, 2, 5)
    np.testing.assert_array_equal(t["alignment"].numpy(),
                                  np.asarray(j["alignment"]))


@pytest.mark.parametrize("variant", [v for v in JA.VARIANTS if v != SMA])
def test_other_variants_not_ported_yet(variant):
    with pytest.raises(NotImplementedError):
        TA.init_state(variant, 2, 5)
