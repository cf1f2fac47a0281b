"""The port's training path against the JAX package's, on the same weights
and the same randomness, at the SMALL test size in f32 (parity_mode).

The port cannot draw JAX's threefry bits, so ``jax_randomness`` replays the
JAX package's key splits (``forward``, ``decoder_teacher_forced``, the
encoder/prenet/postnet dropouts) and hands the masks and the SMA noise to
the port's ``forward`` as its ``randomness`` dict.

Tolerances: 2e-4 on model outputs (the inference tests' bound: the same f32
arithmetic summed in another order, through a recurrence); 1e-5 relative on
losses; gradients leaf by leaf to 1e-4 * max|g|; the optimizer's update to
1e-6 given identical gradients."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.apps import train as JAPP
from tacotron2_subword_tpu.data import dataset as JD
from tacotron2_subword_tpu.models import attention as JA
from tacotron2_subword_tpu.models import tacotron2 as M
from tacotron2_subword_tpu.nn import layers as JL
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import train as TAPP
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.data import dataset as TD
from tacotron2_subword_tpu_torch.models import attention as TA
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.nn import layers as TL
from tacotron2_subword_tpu_torch.utils.import_jax import (
    adam_state_from_numpy, tacotron2_params_from_numpy)
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_model import SMALL, make_batch
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
OUT_KEYS = ("mel", "mel_postnet", "gate", "alignments", "alignments_bert")
LOSS_CFG = SMALL.replace(softdtw_loss_weight=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _port_cfg(cfg):
    return TConfig(**dataclasses.asdict(cfg))


def _batch(cfg, **kw):
    b = make_batch(cfg, **kw)
    b["gate_target"] = JT.make_gate_target(b["output_lengths"],
                                           b["mels"].shape[2])
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    for k in ("text", "sub", "text_lengths", "sub_lengths", "output_lengths"):
        tb[k] = tb[k].long()
    return b, tb


def _params(cfg, seed=0):
    params, bn = M.init_tacotron2(jax.random.PRNGKey(seed), cfg)
    tp, tbn = tacotron2_params_from_numpy(_np(params), _np(bn),
                                          _port_cfg(cfg), device="cpu")
    return params, bn, tp, tbn


def _layer_masks(key, shapes, rate):
    """One key split per layer, as the JAX package's L.dropout calls."""
    out = []
    for shape in shapes:
        key, k = jax.random.split(key)
        out.append(jax.random.bernoulli(k, 1.0 - rate, shape))
    return out


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def _decoder_randomness(cfg, k_dec, B, T_mem, T_out, training):
    """What the JAX package's decoder_teacher_forced(rng=k_dec) draws."""
    T_steps = T_out // cfg.n_frames_per_step
    _, k_pre, k_pre_b, k_scan = jax.random.split(k_dec, 4)
    out = {}
    if training or cfg.prenet_dropout_always_on:
        shapes = [(B, T_steps, cfg.prenet_dim)] * 2
        out["prenet"] = _layer_masks(k_pre, shapes, 0.5)
        out["prenet_bert"] = _layer_masks(k_pre_b, shapes, 0.5)
    if training:
        ka, kb, kc, kd, kn = jax.random.split(k_scan, 5)
        A_dim, D_dim = cfg.attention_rnn_dim, cfg.decoder_rnn_dim
        bern = lambda k, shape, rate: jax.random.bernoulli(k, 1.0 - rate,
                                                           shape)
        out["att_h"] = bern(ka, (T_steps, 2, B, A_dim),
                            cfg.p_attention_dropout)
        out["att_c"] = bern(kb, (T_steps, 2, B, A_dim),
                            cfg.p_attention_dropout)
        out["dec_h"] = bern(kc, (T_steps, B, D_dim), cfg.p_decoder_dropout)
        out["dec_c"] = bern(kd, (T_steps, B, D_dim), cfg.p_decoder_dropout)
        # only SMA reads the noise (the JAX package gives the other
        # variants zeros)
        if cfg.attention == "StepwiseMonotonicAttention":
            out["noise"] = (jax.random.normal(kn, (T_steps, 2, B, T_mem))
                            * JA.SMA_SIGMOID_NOISE)
    return out


def _shape_cfg(cfg):
    """The config with every field that no random draw reads at its
    default, so that configs differing only there share one compile."""
    keep = ("n_frames_per_step", "prenet_dim", "encoder_embedding_dim",
            "encoder_n_convolutions", "postnet_n_convolutions",
            "n_mel_channels", "postnet_embedding_dim", "attention_rnn_dim",
            "decoder_rnn_dim", "p_attention_dropout", "p_decoder_dropout",
            "prenet_dropout_always_on", "attention")
    return SMALL.__class__(**{k: getattr(cfg, k) for k in keep})


def jax_randomness(cfg, rng, batch, training):
    """The masks and noise that the JAX package's ``forward(rng=rng)``
    draws, as the port's ``randomness`` dict (``TM.make_randomness``)."""
    B, T_text = batch["text"].shape
    return _t(_forward_randomness(_shape_cfg(cfg), rng, B, T_text,
                                  batch["sub"].shape[1],
                                  batch["mels"].shape[2], training))


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5, 6))
def _forward_randomness(cfg, rng, B, T_text, T_sub, T_out, training):
    E = cfg.encoder_embedding_dim
    _, k_enc, k_enc_b, k_dec, k_post = jax.random.split(rng, 5)
    out = _decoder_randomness(cfg, k_dec, B, max(T_text, T_sub), T_out,
                              training)
    if training:
        n_enc = cfg.encoder_n_convolutions
        out["encoder"] = _layer_masks(k_enc, [(B, E, T_text)] * n_enc, 0.5)
        out["encoder_sub"] = _layer_masks(k_enc_b, [(B, E, T_sub)] * n_enc,
                                          0.5)
        n = cfg.postnet_n_convolutions
        out["postnet"] = _layer_masks(
            k_post, [(B, cfg.n_mel_channels if i == n - 1
                      else cfg.postnet_embedding_dim, T_out)
                     for i in range(n)], 0.5)
    return out


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg, training):
    return jax.jit(lambda p, bn, b, key: M.forward(p, bn, cfg, b,
                                                   training=training, rng=key))


@functools.lru_cache(maxsize=None)
def _jax_grad(cfg):
    def loss_fn(p, bn, b, key):
        out, _ = M.forward(p, bn, cfg, b, training=True, rng=key)
        return JT.tacotron2_loss(out, b, cfg, 0)["total"]
    return jax.jit(jax.grad(loss_fn))


_jax_train_step = jax.jit(JT.train_step, static_argnums=(3, 4))
_jax_eval_step = jax.jit(JT.eval_step, static_argnums=(3,))


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted), for a JAX or a port tree."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _forward_both(cfg, training, seed=1, **batch_kw):
    params, bn, tp, tbn = _params(cfg)
    b, tb = _batch(cfg, **batch_kw)
    key = jax.random.PRNGKey(seed)
    j, jbn = _jax_forward(cfg, training)(params, bn, b, key)
    t, tbn_new = TM.forward(tp, tbn, _port_cfg(cfg), tb, training=training,
                            randomness=jax_randomness(cfg, key, b, training))
    return j, jbn, t, tbn_new


# ---------------------------------------------------------------------------
# Layers and the model
# ---------------------------------------------------------------------------

def test_batchnorm_training_matches_jax():
    """y from the batch statistics; running mean/var with momentum 0.1 and
    Bessel's correction over B*T."""
    rng = np.random.RandomState(3)
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5,
              "bias": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32),
             "var": rng.rand(6).astype(np.float32) + 0.1}
    x = rng.randn(3, 6, 11).astype(np.float32) * 2 + 1
    jy, js = JL.batchnorm_apply(params, state, jnp.asarray(x), training=True)
    ty, ts = TL.batchnorm_apply(_t(params), _t(state), torch.from_numpy(x),
                                training=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-6)


def test_dropout_with_mask_matches_jax():
    x = np.random.RandomState(4).randn(4, 9).astype(np.float32)
    key = jax.random.PRNGKey(5)
    j = JL.dropout(key, jnp.asarray(x), 0.5)
    mask = np.array(jax.random.bernoulli(key, 0.5, x.shape))
    t = TL.dropout(torch.from_numpy(x), 0.5, torch.from_numpy(mask))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g = torch.Generator().manual_seed(0)
    m = TL.keep_mask((1000,), 0.1, g)
    assert m.dtype == torch.bool and 0.85 < m.float().mean() < 0.95
    # without a mask, one is drawn from the generator
    ones = torch.ones(1000)
    d = TL.dropout(ones, 0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(d, TL.dropout(
        ones, 0.5, generator=torch.Generator().manual_seed(1)))
    assert set(d.unique().tolist()) == {0.0, 2.0}


def test_sma_training_step_matches_jax():
    """SMA with the training noise added to the masked energies."""
    S, B, T, D, Q = 2, 3, 9, 16, 20
    ps = [JA.attention_init(jax.random.PRNGKey(i), "StepwiseMonotonicAttention",
                            Q, D, 8, 4, 7) for i in range(2)]
    rng = np.random.RandomState(6)
    mem = rng.randn(S, B, T, D).astype(np.float32)
    query = rng.randn(S, B, Q).astype(np.float32)
    prev = rng.rand(S, B, T).astype(np.float32)
    noise = rng.randn(S, B, T).astype(np.float32) * JA.SMA_SIGMOID_NOISE
    mask = np.arange(T)[None, None, :] < np.array([[9, 5, 7], [4, 9, 2]])[
        :, :, None]
    js = []
    for s in range(S):
        pm = JA.process_memory(ps[s], jnp.asarray(mem[s]))
        js.append(JA.attention_step(
            "StepwiseMonotonicAttention", ps[s], jnp.asarray(query[s]),
            jnp.asarray(mem[s]), pm, jnp.zeros((B, 2, T)),
            jnp.asarray(mask[s]), {"alignment": jnp.asarray(prev[s])},
            training=True, noise=jnp.asarray(noise[s])))
    tps = [_t(p) for p in ps]
    stacked = tree_map(lambda a, b: torch.stack([a, b]), *tps)
    tmem = torch.from_numpy(mem)
    pm = torch.stack([TA.process_memory(tps[s], tmem[s]) for s in range(S)])
    ctx, w, st = TA.attention_step(
        "StepwiseMonotonicAttention", stacked, torch.from_numpy(query), tmem,
        pm, torch.from_numpy(mask), {"alignment": torch.from_numpy(prev)},
        noise=torch.from_numpy(noise))
    for s in range(S):
        np.testing.assert_allclose(ctx[s].numpy(), np.asarray(js[s][0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(w[s].numpy(), np.asarray(js[s][1]),
                                   rtol=1e-5, atol=1e-6)


def test_decoder_teacher_forced_training_matches_jax():
    """The decoder alone in training mode (masks and noise replayed), with
    r = 2 frames per step and the gate repeated r times (``forward``'s
    tests cover r = 1)."""
    cfg = SMALL.replace(n_frames_per_step=2)
    params, bn, tp, tbn = _params(cfg)
    b, tb = _batch(cfg, T_out=14)
    rng = np.random.RandomState(7)
    mem = rng.randn(3, 11, cfg.encoder_embedding_dim).astype(np.float32)
    mem_b = rng.randn(3, 7, cfg.encoder_embedding_dim).astype(np.float32)
    key = jax.random.PRNGKey(8)
    j = jax.jit(lambda dp, *a: M.decoder_teacher_forced(
        dp, cfg, *a, training=True, rng=key))(
        params["decoder"], jnp.asarray(mem), jnp.asarray(mem_b), b["mels"],
        b["text_lengths"], b["sub_lengths"])
    rnd = _t(_decoder_randomness(_shape_cfg(cfg), key, 3, 11, 14, True))
    t = TM.decoder_teacher_forced(
        tp["decoder"], _port_cfg(cfg), torch.from_numpy(mem),
        torch.from_numpy(mem_b), tb["mels"], tb["text_lengths"],
        tb["sub_lengths"], training=True, randomness=rnd)
    assert t[1].shape == (3, 14)
    for a, ref in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(training):
    j, jbn, t, tbn = _forward_both(SMALL, training)
    for k in OUT_KEYS:
        assert t[k].shape == np.asarray(j[k]).shape, k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL,
                                   err_msg=k)
    # new BN running statistics (training) or the state as given (eval)
    for a, ref in zip(_leaves(tbn), _leaves(jbn)):
        np.testing.assert_allclose(a, ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Losses, gradients, optimizer, steps
# ---------------------------------------------------------------------------

def _loss_inputs(cfg, weight):
    params, bn, tp, tbn = _params(cfg)
    b, tb = _batch(cfg)
    if weight:
        b["weight"] = jnp.asarray([1.0, 1.0, 0.0])
        tb["weight"] = torch.tensor([1.0, 1.0, 0.0])
    if cfg.align_loss:
        rng = np.random.RandomState(9)
        at = (rng.rand(3, 13, 11) > 0.7).astype(np.float32)
        b["align_target"] = jnp.asarray(at)
        tb["align_target"] = torch.from_numpy(at)
    return params, bn, tp, tbn, b, tb


@pytest.mark.parametrize("ssim", [0.0, 0.5])
@pytest.mark.parametrize("align", ["", "L2", "KL"])
@pytest.mark.parametrize("weight", [False, True])
def test_losses_match_jax(align, weight, ssim):
    """Every loss term on the same outputs, with and without ``weight``,
    with and without the SSIM term."""
    cfg = LOSS_CFG.replace(align_loss=align, ssim_loss_weight=ssim)
    rng = np.random.RandomState(10)
    outs = {"mel": rng.randn(3, 5, 13), "mel_postnet": rng.randn(3, 5, 13),
            "gate": rng.randn(3, 13) * 3, "alignments": rng.rand(3, 13, 11),
            "alignments_bert": rng.rand(3, 13, 7)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    _, _, _, _, b, tb = _loss_inputs(cfg, weight)
    for it in (0, cfg.align_loss_max_iters):
        j = JT.tacotron2_loss({k: jnp.asarray(v) for k, v in outs.items()},
                              b, cfg, jnp.asarray(it))
        t = TT.tacotron2_loss({k: torch.from_numpy(v) for k, v in
                               outs.items()}, tb, _port_cfg(cfg), it)
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k].item(), float(j[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@functools.lru_cache(maxsize=None)
def _grads_both(cfg):
    """(JAX's gradients, the port's) of the total loss; the JAX side always
    with its own custom decoder VJP."""
    params, bn, tp, tbn, b, tb = _loss_inputs(cfg, weight=True)
    key = jax.random.PRNGKey(11)
    jg = _jax_grad(cfg.replace(custom_decoder_vjp=True))(params, bn, b, key)
    tcfg = _port_cfg(cfg)
    rnd = jax_randomness(cfg, key, b, training=True)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    out, _ = TM.forward(tp, tbn, tcfg, tb, training=True, randomness=rnd)
    total = TT.tacotron2_loss(out, tb, tcfg, 0)["total"]
    # DCA and GMM read no processed memory: their memory layer gets none
    tg = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(total, leaves, allow_unused=True), leaves)]
    it = iter(tg)
    return _leaves(jg), _leaves(tree_map(lambda _: next(it).numpy(), tp))


def _check_grads(tg, jg):
    """max|d| <= 1e-4 * max|g| of each leaf, that max floored at 1e-3 of
    the whole tree's: a conv bias feeding a training-mode BatchNorm has a
    true gradient of 0, and both sides give rounding noise there."""
    assert len(tg) == len(jg)
    floor = 1e-3 * max(np.abs(g).max() for g in jg)
    for i, (a, ref) in enumerate(zip(tg, jg)):
        scale = max(np.abs(ref).max(), floor)
        assert np.abs(a - ref).max() <= 1e-4 * scale, i


@pytest.mark.parametrize("custom", [True, False])
def test_gradients_match_jax(custom):
    """Gradient of the total loss (mel, gate, soft-DTW) leaf by leaf, with
    the port's hand-routed decoder backward and with plain autograd."""
    jg, tg = _grads_both(LOSS_CFG.replace(custom_decoder_vjp=custom))
    _check_grads(tg, jg)


def test_gradients_with_ssim_match_jax():
    """Gradient of the total loss with the SSIM term on as well."""
    jg, tg = _grads_both(LOSS_CFG.replace(ssim_loss_weight=0.5))
    _check_grads(tg, jg)


def test_custom_decoder_backward_equals_autograd():
    """The hand-routed decoder backward gives autograd's gradients."""
    _, tg_custom = _grads_both(LOSS_CFG.replace(custom_decoder_vjp=True))
    _, tg_plain = _grads_both(LOSS_CFG.replace(custom_decoder_vjp=False))
    _check_grads(tg_custom, tg_plain)


def _tree_pair(seed, scale):
    rng = np.random.RandomState(seed)
    shapes = {"a": (3, 4), "b": [(5,), (2, 2, 2)]}
    mk = lambda s: (rng.randn(*s) * scale).astype(np.float32)
    return {"a": mk(shapes["a"]), "b": [mk(s) for s in shapes["b"]]}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_optimizer_matches_optax(grad_scale):
    """Three updates from identical gradients, with the global-norm clip
    inactive (0.01) and active (10)."""
    cfg = LOSS_CFG
    params = _tree_pair(0, 1.0)
    jtx = JT.make_optimizer(cfg)
    tx = TT.make_optimizer(_port_cfg(cfg))
    jp, jst = jax.tree_util.tree_map(jnp.asarray, params), None
    jst = jtx.init(jp)
    tp = _t(params)
    tst = tx.init(tp)
    for step in range(3):
        g = _tree_pair(1 + step, grad_scale)
        ju, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, tst = tx.update(_t(g), tst, tp)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        for a, ref in zip(_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(a, ref, rtol=0, atol=1e-6)
    adam = jst[2]
    assert int(tst.count) == int(adam.count) == 3
    for a, ref in zip(_leaves((tst.mu, tst.nu)), _leaves((adam.mu, adam.nu))):
        np.testing.assert_allclose(a, ref, rtol=1e-6, atol=1e-9)


def _states(cfg):
    jstate, jtx = JT.create_train_state(jax.random.PRNGKey(0), cfg)
    tcfg = _port_cfg(cfg)
    tp, tbn = tacotron2_params_from_numpy(_np(jstate.params),
                                          _np(jstate.bn_state), tcfg,
                                          device="cpu")
    adam = jstate.opt_state[2]
    opt = adam_state_from_numpy(np.asarray(adam.count), _np(adam.mu),
                                _np(adam.nu), tp, device="cpu")
    return jstate, jtx, TT.TrainState(0, tp, tbn, opt), \
        TT.make_optimizer(tcfg), tcfg


def test_nan_gradient_skips_the_update():
    """A non-finite gradient norm keeps params and optimizer state; the
    step still moves and grad_norm is the raw gradients' norm."""
    cfg = LOSS_CFG
    _, _, state, tx, tcfg = _states(cfg)
    _, tb = _batch(cfg)
    tb["mels"][0, 0, 0] = float("nan")
    new, metrics = TT.train_step(state, tb, tcfg, tx,
                                 generator=torch.Generator().manual_seed(0))
    assert not torch.isfinite(metrics["grad_norm"])
    assert metrics["skipped"].item() == 1.0 and new.step == 1
    for a, b in zip(tree_leaves((new.params, new.opt_state)),
                    tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ssim", [0.0, 0.5])
def test_train_step_and_eval_step_match_jax(ssim):
    """One full train step (forward, loss with soft-DTW and, where ``ssim``
    is not 0, SSIM, backward through the custom decoder VJP, Adam) and one
    eval step, end to end.

    Updated params: Adam's first step is -lr * g / (|g| + eps), which
    turns the rounding noise of a near-zero gradient element into up to lr
    of difference.  So every element is held to 2 * lr, and 99.9 % of each
    leaf's elements to 2e-5, but the conv biases: each feeds a
    training-mode BatchNorm, so its true gradient is 0 and all of it is
    weight decay plus noise."""
    cfg = LOSS_CFG.replace(ssim_loss_weight=ssim)
    jstate, jtx, tstate, tx, tcfg = _states(cfg)
    b, tb = _batch(cfg)
    key = jax.random.PRNGKey(12)
    jnew, jm = _jax_train_step(jstate, b, key, cfg, jtx)
    tnew, tm = TT.train_step(tstate, tb, tcfg, tx,
                             randomness=jax_randomness(cfg, key, b, True))
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tnew.step == int(jnew.step) == 1
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jnew.params)[0]]
    for path, a, ref in zip(paths, _leaves(tnew.params),
                            _leaves(jnew.params)):
        d = np.abs(a - ref)
        assert d.max() <= 2 * cfg.learning_rate, path
        if not path.endswith("['conv']['b']"):
            assert (d > 2e-5).mean() <= 1e-3, path
    for a, ref in zip(_leaves(tnew.bn_state), _leaves(jnew.bn_state)):
        np.testing.assert_allclose(a, ref, rtol=1e-4, atol=1e-5)
    # the eval step on the JAX side's updated state (the Adam noise above
    # would otherwise reach the outputs through the conv biases)
    tp, tbn = tacotron2_params_from_numpy(_np(jnew.params),
                                          _np(jnew.bn_state), tcfg,
                                          device="cpu")
    key = jax.random.PRNGKey(13)
    jl, jo = _jax_eval_step(jnew, b, key, cfg)
    tl, to = TT.eval_step(tnew._replace(params=tp, bn_state=tbn), tb, tcfg,
                          randomness=jax_randomness(cfg, key, b, False))
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in OUT_KEYS:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), **TOL)


def test_make_gate_target_matches_jax():
    lengths = np.array([5, 1, 7])
    np.testing.assert_array_equal(
        TT.make_gate_target(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(JT.make_gate_target(jnp.asarray(lengths), 7)))


# ---------------------------------------------------------------------------
# Batches and the CLI
# ---------------------------------------------------------------------------

def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("r", [1, 3])
def test_batches_match_jax(r):
    """SyntheticDataset samples, pad_batch and the BucketedLoader's batches
    (edges, padding, gate target, repeat-to-fill weight) equal the JAX
    package's."""
    cfg = SMALL.replace(n_frames_per_step=r)
    jds = JAPP.SyntheticDataset(cfg, 13, seed=1)
    tds = TAPP.SyntheticDataset(_port_cfg(cfg), 13, seed=1)
    for i in range(13):
        _equal_batches(jds[i], tds[i])
    _equal_batches(JD.pad_batch([jds[0], jds[5]]),
                   TD.pad_batch([tds[0], tds[5]]))
    jl = JD.BucketedLoader(jds, batch_size=4, seed=3, frames_per_step=r)
    tl = TD.BucketedLoader(tds, batch_size=4, frames_per_step=r)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            _equal_batches(a, b)


def test_train_cli_runs_synthetic_iterations_with_validation(tmp_path,
                                                              capsys):
    """Two synthetic iterations at the SMALL size on the CPU, validation
    after the second (iters_per_checkpoint 2), soft-DTW loss on."""
    default = dataclasses.asdict(TConfig())
    hp = "-".join(f"{k}:{v}" for k, v in dataclasses.asdict(SMALL).items()
                  if v != default[k]) \
        + "-softdtw_loss_weight:1.0-iters_per_checkpoint:2"
    out = TAPP.main(["-o", str(tmp_path / "run"), "--synthetic", "4",
                     "--max-iters", "2", "--batch-size", "2", "--hparams",
                     f"[{hp}]", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "iter 2: loss" in log and "validation loss" in log
    assert "reached max iters" in log
    assert out["iterations"] == 2
    assert np.isfinite(out["loss"]) and np.isfinite(out["val_loss"])
    args = TAPP.build_argparser().parse_args(["-o", "x", "--train-list",
                                              "f"])
    assert args.train_list == "f" and args.prefetch == 2
