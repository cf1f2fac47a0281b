"""The five non-default attention variants (LocationSensitive,
ForwardAttentionV2, Content, DCA, GMM) through the port's teacher-forced
model against the JAX package's, at the SMALL test size in f32
(parity_mode) on the bridge's weights: ``forward`` in eval and in training
(the randomness replayed by ``jax_randomness``) and the gradient of the
total loss through the hand-routed decoder backward.  The free-running
decode of every variant is in ``test_torch_attention.py``.

Tolerances: 2e-4 on model outputs (the inference tests' bound: the same
f32 arithmetic summed in another order, through a recurrence); gradients
leaf by leaf to 1e-4 * max|g| (``test_gradients_match_jax``'s bound).
Each JAX function is compiled once per variant; T_out is 8."""

import functools

import numpy as np
import pytest
import torch

import jax

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.models import attention as JA
from tacotron2_subword_tpu.models import tacotron2 as M
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                                     tree_unflatten)
from tests.test_model import make_batch
from tests.test_torch_train import (LOSS_CFG, OUT_KEYS, TOL, _batch,
                                    _check_grads, _forward_both, _leaves,
                                    _params, _port_cfg, jax_randomness)

SMA = "StepwiseMonotonicAttention"
OTHERS = [v for v in JA.VARIANTS if v != SMA]
T_OUT = 8


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(cfg):
    """jit(value_and_grad) of the total loss, with the training outputs
    and the new BN state as its aux: one compile serves both tests."""
    def loss_fn(p, bn, b, key):
        out, new_bn = M.forward(p, bn, cfg, b, training=True, rng=key)
        return JT.tacotron2_loss(out, b, cfg, 0)["total"], (out, new_bn)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_grads(tp, tbn, tcfg, tb, rnd):
    """(outputs, new BN state, gradients as a tree like ``tp``) of the
    port's total loss; a leaf the loss does not reach gets zeros."""
    p = tree_map(lambda a: a.detach().clone().requires_grad_(True), tp)
    out, new_bn = TM.forward(p, tbn, tcfg, tb, training=True,
                             randomness=rnd)
    total = TT.tacotron2_loss(out, tb, tcfg, 0)["total"]
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    detach = lambda tree: tree_map(lambda a: a.detach(), tree)
    return detach(out), detach(new_bn), tree_unflatten(tp, [
        torch.zeros_like(a) if g is None else g
        for g, a in zip(grads, leaves)])


@functools.lru_cache(maxsize=None)
def _train_both(variant):
    """JAX's training outputs, BN state and gradients (its custom decoder
    VJP), and the port's with the hand-routed backward and with plain
    autograd, on the same weights, batch and randomness."""
    cfg = LOSS_CFG.replace(attention=variant, custom_decoder_vjp=True)
    params, bn, tp, tbn = _params(cfg)
    b, tb = _batch(cfg, T_out=T_OUT)
    key = jax.random.PRNGKey(11)
    (_, (jout, jbn)), jg = _jax_loss_grad(cfg)(params, bn, b, key)
    rnd = jax_randomness(cfg, key, b, training=True)
    port = {}
    for custom in (True, False):
        out, new_bn, g = _port_grads(
            tp, tbn, _port_cfg(cfg.replace(custom_decoder_vjp=custom)), tb,
            rnd)
        port[custom] = (out, new_bn, _leaves(tree_map(torch.Tensor.numpy,
                                                      g)))
    return (jout, jbn, _leaves(jg)), port


def _check_outputs(t, j, tbn, jbn):
    for k in OUT_KEYS:
        assert t[k].shape == np.asarray(j[k]).shape, k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL,
                                   err_msg=k)
    for a, ref in zip(_leaves(tbn), _leaves(jbn)):
        np.testing.assert_allclose(a, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("variant", OTHERS)
def test_forward_matches_jax(variant, training):
    """Teacher-forced ``forward``: eval, and training with the JAX
    package's masks replayed (no SMA noise: no other variant draws it)."""
    if training:
        (j, jbn, _), port = _train_both(variant)
        t, tbn, _ = port[True]
        assert "noise" not in jax_randomness(
            LOSS_CFG.replace(attention=variant), jax.random.PRNGKey(0),
            make_batch(LOSS_CFG, T_out=T_OUT), training=True)
    else:
        j, jbn, t, tbn = _forward_both(
            LOSS_CFG.replace(attention=variant), False, T_out=T_OUT)
    _check_outputs(t, j, tbn, jbn)


@pytest.mark.parametrize("variant", OTHERS)
def test_gradients_match_jax(variant):
    """The total loss's gradient (mel, gate, soft-DTW) through
    ``_TFScanCustom``, leaf by leaf; every attention leaf included."""
    (_, _, jg), port = _train_both(variant)
    _check_grads(port[True][2], jg)


@pytest.mark.parametrize("variant", JA.VARIANTS)
def test_custom_decoder_backward_equals_autograd(variant):
    """The hand-routed decoder backward gives autograd's gradients, every
    leaf of every variant's attention tree included (port only: seeded
    port weights and randomness)."""
    tcfg = _port_cfg(LOSS_CFG.replace(attention=variant))
    tp, tbn = TM.init_tacotron2(torch.Generator().manual_seed(0), tcfg,
                                device="cpu")
    _, tb = _batch(LOSS_CFG, T_out=T_OUT)
    B, T_text = tb["text"].shape
    rnd = TM.make_randomness(tcfg, B, T_text, tb["sub"].shape[1], T_OUT,
                             training=True,
                             generator=torch.Generator().manual_seed(1))
    assert ("noise" in rnd) == (variant == SMA)
    grads = {}
    for custom in (True, False):
        grads[custom] = _port_grads(
            tp, tbn, tcfg.replace(custom_decoder_vjp=custom), tb, rnd)[2]
    _check_grads(*[[a.numpy() for a in tree_leaves(grads[c])]
                   for c in (True, False)])
    # every attention leaf gets a gradient through the hand-routed backward
    # (DCA and GMM read no processed memory: none for their memory layer)
    for stream in ("attention", "attention_bert"):
        for k, g in grads[True]["decoder"][stream].items():
            none = k == "memory" and variant in ("DynamicConvolutionAttention",
                                                 "GMMAttention")
            assert all((a.abs().max() == 0) == none for a in tree_leaves(g)), k
