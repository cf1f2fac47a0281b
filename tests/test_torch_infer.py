"""The port's inference slice against the JAX package's ``M.infer`` on the
same weights, at the SMALL test size in f32 (parity_mode).

Tolerances: 2e-4 on mels and alignments (the JAX package's parity bound
against the torch reference; the same f32 arithmetic summed in another
order, through a recurrence); lengths and stop flags exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tacotron2_subword_tpu.models import tacotron2 as M
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.utils.import_jax import \
    tacotron2_params_from_numpy
from tests.test_model import SMALL, make_batch

TOL = dict(rtol=2e-4, atol=2e-4)
OUT_KEYS = ("mel", "mel_postnet", "gate", "alignments", "alignments_bert")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cfg):
    return TConfig(**dataclasses.asdict(cfg))


def _both(cfg, max_steps, gate_threshold):
    params, bn = M.init_tacotron2(jax.random.PRNGKey(0), cfg)
    b = make_batch(cfg)
    j = M.infer(params, bn, cfg, b["text"], b["sub"], b["cls_phone"],
                b["cls_sub"], rng=jax.random.PRNGKey(1), max_steps=max_steps,
                gate_threshold=gate_threshold, text_lengths=b["text_lengths"],
                sub_lengths=b["sub_lengths"])
    tcfg = _port_cfg(cfg)
    tp, tbn = tacotron2_params_from_numpy(_np(params), _np(bn), tcfg,
                                          device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    t = TM.infer(tp, tbn, tcfg, tb["text"], tb["sub"], tb["cls_phone"],
                 tb["cls_sub"], max_steps=max_steps,
                 gate_threshold=gate_threshold,
                 text_lengths=tb["text_lengths"],
                 sub_lengths=tb["sub_lengths"])
    return j, t


def _check(j, t):
    for k in OUT_KEYS:
        assert t[k].shape == np.asarray(j[k]).shape, k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(t["mel_lengths"].numpy(),
                                  np.asarray(j["mel_lengths"]))
    np.testing.assert_array_equal(t["infer_ok"].numpy(),
                                  np.asarray(j["infer_ok"]))


@pytest.mark.parametrize("quant", ["", "int8"])
def test_infer_matches_jax(quant):
    """Gate never fires (threshold 1.1): every sample decodes max steps."""
    cfg = SMALL.replace(prenet_dropout_always_on=False, decode_quant=quant)
    j, t = _both(cfg, max_steps=20, gate_threshold=1.1)
    _check(j, t)
    assert t["steps_run"] == 20
    assert not t["infer_ok"].any()


@pytest.mark.parametrize("quant", ["", "int8"])
def test_infer_bf16_close_to_jax(quant):
    """The serving dtype, bf16 (int8 weights quantized after the cast).
    The LSTM gates are f32 in both (from bf16 operands), but the
    frameworks still round to bf16 at other points (XLA fuses chains of
    bf16 elementwise ops and rounds once; PyTorch rounds after each op),
    and the 12-step recurrence carries that: mean |d| <= 1 % of mean |ref|,
    max |d| <= 0.05 (measured 0.25-0.41 % and 0.0195 with the f32 gates;
    0.35 % and 0.022 when the port's gates were bf16)."""
    cfg = SMALL.replace(parity_mode=False, compute_dtype="bfloat16",
                        decode_quant=quant, prenet_dropout_always_on=False)
    j, t = _both(cfg, max_steps=12, gate_threshold=1.1)
    for k in OUT_KEYS:
        a = np.asarray(j[k], np.float32)
        d = np.abs(t[k].numpy() - a)
        assert d.mean() <= 0.01 * np.abs(a).mean() and d.max() <= 0.05, k
    np.testing.assert_array_equal(t["mel_lengths"].numpy(),
                                  np.asarray(j["mel_lengths"]))


@pytest.mark.parametrize("r", [1, 2])
def test_gate_fires_at_first_step(r, monkeypatch):
    """Threshold 0: every gate fires at step 1; the stop frame is kept, the
    rest is masked and the gate padded with GATE_PAD_VALUE."""
    monkeypatch.setattr(TM, "SYNC_EVERY", 4)
    cfg = SMALL.replace(prenet_dropout_always_on=False, n_frames_per_step=r)
    j, t = _both(cfg, max_steps=9, gate_threshold=0.0)
    _check(j, t)
    np.testing.assert_array_equal(t["mel_lengths"].numpy(), [r, r, r])
    assert t["infer_ok"].all()
    assert (t["gate"][:, 1:] == TM.GATE_PAD_VALUE).all()
    assert t["steps_run"] == 4  # stopped at the first host check


def test_samples_stop_on_their_own_gates(monkeypatch):
    """A threshold between the samples' gate values: the samples stop at
    different steps, and one never does."""
    monkeypatch.setattr(TM, "SYNC_EVERY", 4)
    thresh = 0.405
    cfg = SMALL.replace(prenet_dropout_always_on=False)
    j, t = _both(cfg, max_steps=14, gate_threshold=thresh)
    _check(j, t)
    lengths = t["mel_lengths"].tolist()
    assert len(set(lengths)) == 3 and 14 in lengths
    assert t["infer_ok"].tolist() == [n < 14 for n in lengths]
    # no sampled gate is near the threshold, so the stop steps are robust
    sig = torch.sigmoid(t["gate"][t["gate"] != TM.GATE_PAD_VALUE])
    assert (sig - thresh).abs().min() > 1e-4


def test_prenet_masks_match_jax():
    """The dropout path with the masks given (the RNGs differ)."""
    cfg = SMALL
    params, bn = M.init_tacotron2(jax.random.PRNGKey(0), cfg)
    tp, _ = tacotron2_params_from_numpy(_np(params), _np(bn), _port_cfg(cfg),
                                        device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(3, cfg.n_mel_channels).astype(np.float32)
    masks = (rng.rand(2, 3, cfg.prenet_dim) < 0.5).astype(np.float32) / 0.5
    j = M.prenet_apply(params["decoder"]["prenet"], jnp.asarray(x), None,
                       True, masks=jnp.asarray(masks))
    t = TM.prenet_apply(tp["decoder"]["prenet"], torch.from_numpy(x),
                        masks=torch.from_numpy(masks))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_dropout_decode_is_seeded():
    """Prenet dropout on: the masks come from the caller's generator."""
    tcfg = _port_cfg(SMALL)
    params, bn = TM.init_tacotron2(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")
    b = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(SMALL).items()}
    run = lambda seed: TM.infer(
        params, bn, tcfg, b["text"], b["sub"], b["cls_phone"], b["cls_sub"],
        generator=torch.Generator().manual_seed(seed), max_steps=6,
        gate_threshold=1.1, text_lengths=b["text_lengths"],
        sub_lengths=b["sub_lengths"])["mel_postnet"]
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError):
        TM.infer(params, bn, tcfg, b["text"], b["sub"], b["cls_phone"],
                 b["cls_sub"], max_steps=2)


def test_init_matches_jax_structure():
    """Same keys and shapes as the JAX init (the values differ)."""
    jp, jbn = M.init_tacotron2(jax.random.PRNGKey(0), SMALL)
    tp, tbn = TM.init_tacotron2(torch.Generator().manual_seed(0),
                                _port_cfg(SMALL), device="cpu")
    for j, t in ((jp, tp), (jbn, tbn)):
        jl, jdef = jax.tree_util.tree_flatten(_np(j))
        tl, tdef = jax.tree_util.tree_flatten(t)
        assert jdef == tdef
        assert [a.shape for a in jl] == [tuple(a.shape) for a in tl]


def test_synthesize_serves_requests():
    """Text -> wav through the serving core on the CPU: one waveform per
    request, max(frames, 8) * hop samples, within the int16 range."""
    tcfg = _port_cfg(SMALL).replace(hop_length=16)
    h = THG.HifiganConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                          upsample_initial_channel=8, num_mels=5,
                          resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),))
    gen = torch.Generator().manual_seed(0)
    params, bn = TM.init_tacotron2(gen, tcfg, device="cpu")
    g = THG.fuse_generator(THG.init_generator(gen, h, device="cpu"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, tcfg.n_symbols, n), rng.randint(0, 31, m),
             rng.randn(12), rng.randn(12)) for n, m in ((9, 5), (4, 3))]
    out = TI.synthesize(params, bn, g, tcfg, h, reqs,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu", max_steps=6, gate_threshold=1.1)
    assert len(out["wavs"]) == 2
    for w in out["wavs"]:
        assert w.shape == (8 * tcfg.hop_length,)  # 6 frames -> the 8 minimum
        assert torch.isfinite(w).all() and w.abs().max() <= 32768
    # gates never fire: every sample ran all 6 steps
    assert out["mel_lengths"].tolist() == [6, 6]
