"""Port of models/attention.py: each variant's step against the JAX step on
the same weights, both streams stacked as the decoder runs them; the
initial states, the parameter trees and DCA's prior (f32; tolerance 1e-5:
same arithmetic, other order).  Then each non-default variant's
free-running decode through the whole model at the SMALL size, against
the JAX package's ``infer`` with its prenet masks injected: f32 and int8
to 2e-4 (the inference tests' bound), bf16 at
``test_infer_bf16_close_to_jax``'s bound."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu.models import attention as JA
from tacotron2_subword_tpu.models import tacotron2 as M
from tacotron2_subword_tpu_torch.models import attention as TA
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tests.test_model import make_batch
from tests.test_torch_train import (LOSS_CFG, OUT_KEYS, TOL, _batch, _np,
                                    _params, _port_cfg)

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


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown attention variant"):
        TA.init_state("MonotonicAttention", 2, 5)
    with pytest.raises(ValueError, match="unknown attention variant"):
        TA.attention_init(torch.Generator(), "MonotonicAttention", Q, D,
                          A_DIM, 4, 7)


# ---------------------------------------------------------------------------
# Every variant
# ---------------------------------------------------------------------------

N_FILTERS, KERNEL = 4, 7


def _variant_streams(variant, seed=0):
    """Two streams' JAX params, memory and three steps' queries."""
    ps = [JA.attention_init(jax.random.PRNGKey(seed + i), variant, Q, D,
                            A_DIM, N_FILTERS, KERNEL) for i in range(2)]
    rng = np.random.RandomState(seed)
    memory = rng.randn(2, B, T, D).astype(np.float32)
    queries = rng.randn(3, 2, B, Q).astype(np.float32)
    return ps, memory, queries


def _stack_states(states):
    return {k: torch.stack([torch.from_numpy(np.array(s[k]))
                            for s in states]) for k in states[0]}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variant", JA.VARIANTS)
def test_step_matches_jax_every_variant(variant, masked):
    """Three chained steps from each variant's initial state, the previous
    and cumulative weights carried as the decoder carries them (w_cum +=
    w), so log_alpha, alignment_pre, mu_prev and w_cum all carry.  f32;
    1e-5 (the same arithmetic, other order)."""
    ps, memory, queries = _variant_streams(variant)
    lengths = np.array([[9, 5, 2], [7, 9, 3]])
    mask = (np.arange(T)[None, None, :] < lengths[:, :, None]
            if masked else None)
    j_state = [JA.init_state(variant, B, T) for _ in range(2)]
    j_w = [jnp.zeros((B, T)) for _ in range(2)]
    j_cum = [jnp.zeros((B, T)) for _ in range(2)]
    tp = [_t(p) for p in ps]
    stacked = jax.tree_util.tree_map(lambda a, b: torch.stack([a, b]), *tp)
    t_pm = torch.stack([TA.process_memory(tp[s], torch.from_numpy(memory[s]))
                        for s in range(2)])
    t_state = _stack_states([TA.init_state(variant, B, T)] * 2)
    t_w = torch.zeros(2, B, T)
    t_cum = torch.zeros(2, B, T)
    t_mask = None if mask is None else torch.from_numpy(mask)
    j_ctx = [None, None]
    for step in range(3):
        for s in range(2):
            pm = JA.process_memory(ps[s], jnp.asarray(memory[s]))
            ctx, w, j_state[s] = JA.attention_step(
                variant, ps[s], jnp.asarray(queries[step, s]),
                jnp.asarray(memory[s]), pm,
                jnp.stack([j_w[s], j_cum[s]], axis=1),
                None if mask is None else jnp.asarray(mask[s]), j_state[s])
            j_w[s], j_cum[s] = w, j_cum[s] + w
            j_ctx[s] = ctx
        ctx, w, t_state = TA.attention_step(
            variant, stacked, torch.from_numpy(queries[step]),
            torch.from_numpy(memory), t_pm, t_mask, t_state,
            weights_cat=torch.stack([t_w, t_cum], dim=2))
        t_w, t_cum = w, t_cum + w
        for s in range(2):
            np.testing.assert_allclose(ctx[s].numpy(), np.asarray(j_ctx[s]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(w[s].numpy(), np.asarray(j_w[s]),
                                       rtol=1e-5, atol=1e-5)
            for k, v in j_state[s].items():
                np.testing.assert_allclose(t_state[k][s].numpy(),
                                           np.asarray(v), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    if variant in TA.READS_WEIGHTS:
        assert t_cum.abs().sum() > 0


@pytest.mark.parametrize("variant", JA.VARIANTS)
def test_init_state_matches_jax_every_variant(variant):
    j = JA.init_state(variant, 3, 6)
    t = TA.init_state(variant, 3, 6)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("variant", JA.VARIANTS)
def test_attention_init_matches_jax_structure(variant):
    """The same keys and shapes as the JAX init (the values differ)."""
    j = JA.attention_init(jax.random.PRNGKey(0), variant, Q, D, A_DIM,
                          N_FILTERS, KERNEL)
    t = TA.attention_init(torch.Generator().manual_seed(0), variant, Q, D,
                          A_DIM, N_FILTERS, KERNEL)
    jl, jdef = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, j))
    tl, tdef = jax.tree_util.tree_flatten(t)
    assert jdef == tdef
    assert [a.shape for a in jl] == [tuple(a.shape) for a in tl]
    assert all(a.dtype == torch.float32 for a in tl)


def test_dca_prior_matches_jax():
    """The flipped beta-binomial prior, from lgamma, to 1e-7 of scipy's."""
    j = JA.attention_init(jax.random.PRNGKey(0), "DynamicConvolutionAttention",
                          Q, D, A_DIM, N_FILTERS, KERNEL)["prior"]
    t = TA.dca_prior()
    assert t.dtype == torch.float32 and t.shape == (JA.DCA_PRIOR_LENGTH,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# Free-running inference
# ---------------------------------------------------------------------------

STEPS = 8


def _jax_prenet_masks(rng, B, steps, cfg):
    """The scaled prenet keep-masks [4, B, P] of each step that the JAX
    package's ``infer(rng=rng)`` draws (M.infer's split, then one split
    per decoder step)."""
    key = jax.random.split(rng, 5)[3]
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(M._prenet_masks(
            k, 4, (B, cfg.prenet_dim), np.float32))))
    return out


def _jax_infer(cfg):
    params, bn = M.init_tacotron2(jax.random.PRNGKey(0), cfg)
    b = make_batch(cfg)
    return _np(M.infer(params, bn, cfg, b["text"], b["sub"], b["cls_phone"],
                       b["cls_sub"], rng=jax.random.PRNGKey(1),
                       max_steps=STEPS, gate_threshold=1.1,
                       text_lengths=b["text_lengths"],
                       sub_lengths=b["sub_lengths"]))


def _port_infer(cfg, monkeypatch):
    """The port's decode on the bridge's weights, with the prenet masks
    that ``_jax_infer`` draws."""
    _, _, tp, tbn = _params(cfg)
    _, tb = _batch(cfg)
    masks = iter(_jax_prenet_masks(jax.random.PRNGKey(1), 3, STEPS, cfg))
    monkeypatch.setattr(TM, "_prenet_masks", lambda gen, n, shape, dtype,
                        dev: next(masks).to(dtype))
    t = TM.infer(tp, tbn, _port_cfg(cfg), tb["text"], tb["sub"],
                 tb["cls_phone"], tb["cls_sub"],
                 generator=torch.Generator(), max_steps=STEPS,
                 gate_threshold=1.1, text_lengths=tb["text_lengths"],
                 sub_lengths=tb["sub_lengths"])
    assert t["steps_run"] == STEPS
    return t


@pytest.mark.parametrize("variant", [v for v in JA.VARIANTS if v != SMA])
def test_infer_matches_jax(variant, monkeypatch):
    """f32 decode, prenet dropout on with the JAX package's masks."""
    cfg = LOSS_CFG.replace(attention=variant)
    j, t = _jax_infer(cfg), _port_infer(cfg, monkeypatch)
    for k in OUT_KEYS:
        np.testing.assert_allclose(t[k].numpy(), j[k], **TOL, err_msg=k)
    np.testing.assert_array_equal(t["mel_lengths"].numpy(), j["mel_lengths"])


def test_infer_int8_matches_jax(monkeypatch):
    """The int8 decode (K1's plain version here) of one location-based
    variant."""
    cfg = LOSS_CFG.replace(attention="LocationSensitiveAttention",
                           decode_quant="int8")
    j, t = _jax_infer(cfg), _port_infer(cfg, monkeypatch)
    for k in OUT_KEYS:
        np.testing.assert_allclose(t[k].numpy(), j[k], **TOL, err_msg=k)


@pytest.mark.parametrize("variant", ["ForwardAttentionV2",
                                     "DynamicConvolutionAttention",
                                     "GMMAttention"])
def test_infer_bf16_close_to_jax(variant, monkeypatch):
    """The serving dtype, bf16, with the prenet masks injected, at
    ``test_infer_bf16_close_to_jax``'s bound: max |d| <= 0.05 and mean |d|
    <= 1 % of mean |ref|, or within JAX's own bf16 rounding where that is
    larger (its bf16 decode's mean distance from its f32 decode: FAv2's
    alignments, whose log_alpha recursion runs in bf16, sit 1.21 % from
    f32 in JAX and 1.08 % from JAX's bf16 in the port).  GMM is held to
    JAX's f32 decode: the JAX package's bf16 GMM decode raises (its f32
    ``arange`` promotes the weights to f32, and the while loop's carry then
    changes dtype)."""
    cfg = LOSS_CFG.replace(attention=variant, parity_mode=False,
                           compute_dtype="bfloat16")
    gmm = variant == "GMMAttention"
    j32 = _jax_infer(cfg.replace(compute_dtype="float32"))
    j = j32 if gmm else _jax_infer(cfg)
    t = _port_infer(cfg, monkeypatch)
    for k in OUT_KEYS:
        a = np.asarray(j[k], np.float32)
        d = np.abs(t[k].numpy() - a)
        own = np.abs(a - j32[k]).mean() / np.abs(a).mean()
        assert d.mean() <= max(0.01, own) * np.abs(a).mean(), k
        assert d.max() <= 0.05, k
    if gmm:
        with pytest.raises(TypeError, match="carry"):
            _jax_infer(cfg)
