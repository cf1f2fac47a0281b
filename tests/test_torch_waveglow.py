"""The port's WaveGlow against the JAX package's, on the CPU at the JAX
package's own test size (tests/test_vocoders.py ``_wg_cfg``: 8 mels, 4
flows, n_group 4, early outputs of 2 every 2 flows, WN 2 layers of 16
channels, the upsampler at k 1024, s 256), on the same weights with each
coupling's zero end conv replaced by small random values (at init every
coupling is the identity, which would test nothing).

Tolerances, f32 (TF32 is off; the CPU has none): weight norm 1e-6 and
its gradients 1e-5 relative; z and log s 1e-5 of
their scale, the loss 1e-5 relative (the same convolutions summed in
another order), each B*Tg*log|det W| within B*Tg*1e-7 (|det W| = 1 at
init, so log|det W| ~ 1e-8 and only absolute error is meaningful); the
synthesis with JAX's latents injected 1e-4 of the wav's max; the inverse
of the forward 1e-4 of the audio's max; bf16 synthesis within twice JAX's
own bf16-to-f32 distance of JAX's bf16 synthesis; one train step: the
loss 1e-5 relative, each gradient leaf 1e-4 of its largest element, each
updated leaf 1e-5 of its largest element where the gradient is 10x over
Adam's eps (under it Adam's step is ill-conditioned: those elements within
1 % of the leaf's largest update, as tests/test_torch_hifigan_train.py
holds updates); the reference layouts import exactly."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tacotron2_subword_tpu.models import waveglow as JW
from tacotron2_subword_tpu.nn.layers import cast_floating
from tacotron2_subword_tpu.ops import stft as JS
from tacotron2_subword_tpu_torch.apps import train_waveglow as TTW
from tacotron2_subword_tpu_torch.models import waveglow as TW
from tacotron2_subword_tpu_torch.utils.import_jax import \
    waveglow_params_from_numpy
from tacotron2_subword_tpu_torch.utils.import_torch import \
    waveglow_params_from_torch_state_dict
from tacotron2_subword_tpu_torch.utils.tree import cast_floats

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(n_mel_channels=8, n_flows=4, n_group=4, n_early_every=2,
             n_early_size=2, wn_layers=2, wn_channels=16, wn_kernel_size=3,
             upsample_kernel=1024, upsample_stride=256)
JC, TC = JW.WaveGlowConfig(**SMALL), TW.WaveGlowConfig(**SMALL)
FRAMES = 6


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor)
                             else a), tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


# jitted: eager JAX compiles every op (and every random draw) on its own
_j_forward = jax.jit(lambda p, m, a: JW.forward(p, JC, m, a))
_j_infer = jax.jit(lambda p, m, k: JW.infer(p, JC, m, sigma=0.6, key=k))


def _jax_params(cfg=JC, seed=0):
    p = jax.jit(lambda k: JW.init_waveglow(k, cfg))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for wn in p["wn"]:
        for k in ("w", "b"):
            wn["end"][k] = jnp.asarray(
                0.05 * rng.randn(*wn["end"][k].shape).astype(np.float32))
    return p


@pytest.fixture(scope="module")
def weights():
    jp = _jax_params()
    return jp, waveglow_params_from_numpy(_np(jp), TC, device="cpu")


def _inputs(seed=1, B=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 8, FRAMES).astype(np.float32),
            (0.5 * rng.randn(B, FRAMES * 256)).astype(np.float32))


def _jax_latents(key, B, Tg, cfg=JC):
    """The latents ``JW.infer(key=key)`` draws, in its order."""
    early = [k for k in range(1, cfg.n_flows) if k % cfg.n_early_every == 0]
    n_rem = cfg.n_group - cfg.n_early_size * len(early)
    key, k0 = jax.random.split(key)
    out = [np.array(jax.random.normal(k0, (B, n_rem, Tg), jnp.float32))]
    for k in reversed(range(cfg.n_flows)):
        if k in early:
            key, kz = jax.random.split(key)
            out.append(np.array(jax.random.normal(
                kz, (B, cfg.n_early_size, Tg), jnp.float32)))
    return [torch.from_numpy(a) for a in out]


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_weight_matches_jax(dim):
    """w = g v / ||v|| and its gradients in v and g (WaveGlow trains the
    un-fused form)."""
    from tacotron2_subword_tpu.nn import layers as JL
    from tacotron2_subword_tpu_torch.nn import layers as TL
    rng = np.random.RandomState(dim)
    v = rng.randn(6, 4, 3).astype(np.float32)
    g = rng.rand(*[n if i == dim else 1 for i, n in enumerate(v.shape)]
                 ).astype(np.float32) + 0.5
    cot = rng.randn(6, 4, 3).astype(np.float32)
    jw, jvjp = jax.vjp(lambda v, g: JL.weight_norm_weight(
        {"v": v, "g": g}, dim), jnp.asarray(v), jnp.asarray(g))
    tv, tg = (torch.from_numpy(a).requires_grad_(True) for a in (v, g))
    tw = TL.weight_norm_weight({"v": tv, "g": tg}, dim)
    tw.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=1e-6, atol=1e-7)
    for t, j in zip((tv.grad, tg.grad), jvjp(jnp.asarray(cot))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_config_defaults_are_the_published_widths():
    c = TW.WaveGlowConfig()
    assert (c.n_flows, c.n_group, c.n_early_every, c.n_early_size,
            c.wn_layers, c.wn_channels, c.wn_kernel_size, c.upsample_kernel,
            c.upsample_stride) == (12, 8, 4, 2, 8, 256, 3, 1024, 256)
    assert c == TW.WaveGlowConfig(**vars(JW.WaveGlowConfig()))
    assert c.n_remaining() == 4
    assert TW.latent_shapes(c, 1, 10) == [(1, 4, 10), (1, 2, 10), (1, 2, 10)]


def test_init_structure_and_invariants():
    """The port's init has the JAX tree's paths and shapes; every convinv
    is orthonormal with det +1 and every end conv is zero."""
    tp = TW.init_waveglow(torch.Generator().manual_seed(0), TC, device="cpu")
    shapes = jax.eval_shape(lambda k: JW.init_waveglow(k, JC),
                            jax.random.PRNGKey(0))
    jflat = _flat(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    tflat = _flat(tp)
    assert {k: v.shape for k, v in jflat.items()} == \
        {k: v.shape for k, v in tflat.items()}
    for inv in tp["convinv"]:
        w = inv["w"].double()
        assert torch.allclose(w @ w.T, torch.eye(len(w), dtype=w.dtype),
                              atol=1e-6)
        assert abs(torch.linalg.det(w).item() - 1.0) < 1e-6
    assert all(float(wn["end"]["w"].abs().max()) == 0 for wn in tp["wn"])


@pytest.mark.parametrize("n", [4, 8])
def test_grouping_matches_jax(n):
    """The channel order of the grouped mel is mel * n_group + offset (a
    wrong permute is silent at n_group 1)."""
    x = np.random.RandomState(n).randn(2, 3, 5 * n + 3).astype(np.float32)
    np.testing.assert_array_equal(
        TW._group_spect(torch.from_numpy(x), n).numpy(),
        np.asarray(JW._group_spect(jnp.asarray(x), n)))
    a = x[:, 0]
    g = TW._group_audio(torch.from_numpy(a), n)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(JW._group_audio(jnp.asarray(a), n)))
    np.testing.assert_array_equal(
        TW._ungroup_audio(g).numpy(),
        np.asarray(JW._ungroup_audio(JW._group_audio(jnp.asarray(a), n))))


def test_forward_and_loss_match_jax(weights):
    jp, tp = weights
    mel, audio = _inputs()
    jz, jls, jld = _j_forward(jp, jnp.asarray(mel), jnp.asarray(audio))
    tz, tls, tld = TW.forward(tp, TC, torch.from_numpy(mel),
                              torch.from_numpy(audio))
    jz = np.asarray(jz)
    assert tz.shape == jz.shape == (2, 4, FRAMES * 256 // 4)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=0,
                               atol=1e-5 * np.abs(jz).max())
    assert len(tls) == len(jls) == len(tld) == len(jld) == JC.n_flows
    for a, b in zip(tls, jls):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    BTg = 2 * FRAMES * 256 // 4
    for a, b in zip(tld, jld):
        assert abs(float(a) - float(b)) <= BTg * 1e-7
    jl, tl = float(JW.loss((jz, jls, jld))), float(TW.loss((tz, tls, tld)))
    assert abs(tl - jl) <= 1e-5 * abs(jl)


def test_infer_with_injected_latents_matches_jax(weights):
    jp, tp = weights
    mel, _ = _inputs(2)
    key = jax.random.PRNGKey(3)
    jy = np.asarray(_j_infer(jp, jnp.asarray(mel), key))
    noise = _jax_latents(key, 2, FRAMES * 256 // 4)
    assert [tuple(n.shape) for n in noise] == TW.latent_shapes(
        TC, 2, FRAMES * 256 // 4)
    ty = TW.infer(tp, TC, torch.from_numpy(mel), sigma=0.6, noise=noise)
    assert ty.shape == jy.shape == (2, FRAMES * 256)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-4 * np.abs(jy).max())
    # drawn from a generator: seeded draws repeat, other seeds differ
    g = lambda s: TW.infer(tp, TC, torch.from_numpy(mel), sigma=0.6,
                           generator=torch.Generator().manual_seed(s))
    assert torch.equal(g(0), g(0)) and not torch.equal(g(0), g(1))


def test_inverse_inverts_forward(weights):
    """infer with the forward's z as its latents gives the audio back (the
    upsampled mel trimmed by k - s matches the forward's trim to T)."""
    _, tp = weights
    mel, audio = _inputs(4)
    z, _, _ = TW.forward(tp, TC, torch.from_numpy(mel),
                         torch.from_numpy(audio))
    # z = [early output of flow 2, last flow]; infer draws the last flow's
    # latent first, then the early ones from the last flow to the first
    noise = [z[:, 2:], z[:, :2]]
    y = TW.infer(tp, TC, torch.from_numpy(mel), sigma=1.0, noise=noise)
    np.testing.assert_allclose(y.numpy(), audio, rtol=0,
                               atol=1e-4 * np.abs(audio).max())


def test_bf16_synthesis_matches_jax_bf16(weights):
    jp, tp = weights
    mel, _ = _inputs(5, B=1)
    key = jax.random.PRNGKey(7)
    j32 = np.asarray(_j_infer(jp, jnp.asarray(mel), key), np.float32)
    j16 = np.asarray(_j_infer(cast_floating(jp, jnp.bfloat16),
                              jnp.asarray(mel, jnp.bfloat16), key), np.float32)
    t16 = TW.infer(cast_floats(tp, torch.bfloat16), TC,
                   torch.from_numpy(mel).to(torch.bfloat16), sigma=0.6,
                   noise=_jax_latents(key, 1, FRAMES * 256 // 4))
    assert t16.dtype == torch.bfloat16
    t16 = t16.float().numpy()
    own = np.abs(j16 - j32).max()
    assert 0 < own < 0.1 * np.abs(j32).max()
    assert np.abs(t16 - j16).max() <= 2 * own


# ---------------------------------------------------------------------------
# Training: one step, the segment samplers, the CLI
# ---------------------------------------------------------------------------

TRAIN = dict(SMALL, n_mel_channels=80, n_flows=2, n_early_every=4)


def test_train_step_matches_jax():
    """One step of the JAX CLI's ``step_impl`` (mel of the audio, flow NLL,
    ``jax.value_and_grad``, ``optax.adam(1e-4)``) against the port's
    ``train_step`` on the same params and audio."""
    jc, tc = JW.WaveGlowConfig(**TRAIN), TW.WaveGlowConfig(**TRAIN)
    jp = _jax_params(jc, seed=2)
    audio = (0.3 * np.random.RandomState(6).randn(2, 2048)).astype(
        np.float32)
    tx = optax.adam(1e-4)

    def loss_fn(p, a):
        return JW.loss(JW.forward(p, jc, JS.mel_spectrogram(a), a))

    @jax.jit
    def step(p, o, a):
        l, g = jax.value_and_grad(loss_fn)(p, a)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), l, g

    jnew, jl, jg = step(jp, tx.init(jp), jnp.asarray(audio))
    tp = waveglow_params_from_numpy(_np(jp), tc, device="cpu")
    ta = torch.from_numpy(audio)
    tl, tg = TTW.loss_and_grads(tp, ta, tc)
    tx_t = TTW.make_optimizer(1e-4)
    tnew, opt, tl2 = TTW.train_step(tp, tx_t.init(tp), ta, tc, tx_t)
    assert int(opt.count) == 1
    assert abs(float(tl2) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tl2) == tl.item()
    jg, tg = _flat(_np(jg)), _flat(tg)
    jn, tn, j0 = _flat(_np(jnew)), _flat(tnew), _flat(_np(jp))
    assert jg.keys() == tg.keys() == jn.keys() == tn.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, err_msg=k,
                                   atol=1e-4 * max(np.abs(jg[k]).max(), 1e-12))
        # Adam's first step is lr * g / (|g| + eps): where |g| is near eps
        # (1e-8) it turns gradient noise into step noise, so there each
        # element is held to 1 % of the leaf's largest update instead
        err = np.abs(tn[k] - jn[k])
        conditioned = np.abs(jg[k]) >= 10 * 1e-8
        assert (err[conditioned] <= 1e-5 * np.abs(jn[k]).max()).all(), k
        assert (err <= 1e-2 * np.abs(jn[k] - j0[k]).max()
                + 1e-5 * np.abs(jn[k]).max()).all(), k


def test_segment_samplers_match_jax(tmp_path):
    from scipy.io.wavfile import write
    from tacotron2_subword_tpu.apps import train_waveglow as JTW
    j, t = JTW.SyntheticWavs(3), TTW.SyntheticWavs(3)
    for _ in range(2):
        np.testing.assert_array_equal(t.sample_batch(4), j.sample_batch(4))
    rng = np.random.RandomState(0)
    for i, n in enumerate((20000, 15000, 40000)):   # one shorter than 16000
        write(str(tmp_path / f"{i}.wav"), 22050,
              (rng.randn(n) * 3000).astype(np.int16))
    paths = sorted(str(p) for p in tmp_path.glob("*.wav"))
    j, t = JTW.Mel2SampDataset(paths), TTW.Mel2SampDataset(paths)
    assert len(j) == len(t) == 2
    for _ in range(2):
        np.testing.assert_array_equal(t.sample_batch(3), j.sample_batch(3))


def test_train_cli_checkpoint_and_resume_state(tmp_path):
    """The CLI in process for 2 iterations with a tiny --config: a finite
    loss per iteration and ``waveglow_2``, which restores the params, the
    Adam state, the iteration and the sampler's position bit for bit."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "train_config": {"learning_rate": 1e-4, "sigma": 1.0},
        "waveglow_config": {"n_mel_channels": 80, "n_flows": 2,
                            "n_group": 4, "n_early_every": 4,
                            "n_early_size": 2,
                            "WN_config": {"n_layers": 2, "n_channels": 8,
                                          "kernel_size": 3}}}))
    out = tmp_path / "out"
    seen = {}
    real = TTW.save_waveglow

    def spy(path, params, opt, it, rng):
        seen.update(params=params, opt=opt, rng=rng.get_state())
        real(path, params, opt, it, rng)
    TTW.save_waveglow = spy
    try:
        r = TTW.main(["-o", str(out), "--config", str(cfg), "--synthetic",
                      "2", "--batch-size", "1", "--iters", "2",
                      "--iters-per-checkpoint", "2", "--device", "cpu"])
    finally:
        TTW.save_waveglow = real
    assert r["iterations"] == 2 and len(r["losses"]) == 2
    assert np.isfinite(r["losses"]).all()
    assert r["checkpoints"] == [str(out / "waveglow_2")]
    cfg_t, lr, sigma = TTW.load_config(str(cfg))
    assert (cfg_t.n_flows, cfg_t.wn_channels, lr, sigma) == (2, 8, 1e-4, 1.0)
    template = TW.init_waveglow(torch.Generator().manual_seed(0), cfg_t,
                                device="cpu")
    params, opt, it, rng_state = TTW.load_waveglow(
        str(out / "waveglow_2"), "cpu", template=template)
    assert it == 2 and int(opt.count) == 2
    for a, b in zip(_flat(params).values(), _flat(seen["params"]).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_flat(opt._asdict()).values(),
                    _flat(seen["opt"]._asdict()).values()):
        np.testing.assert_array_equal(a, b)
    ds = TTW.SyntheticWavs(2)
    TTW._set_rng_state(ds.rng, rng_state)
    ref = np.random.RandomState()
    ref.set_state(seen["rng"])
    assert ds.rng.randint(1 << 30) == ref.randint(1 << 30)
    small = TW.init_waveglow(torch.Generator().manual_seed(0),
                             TW.WaveGlowConfig(**TRAIN), device="cpu")
    with pytest.raises(ValueError, match="config"):
        TTW.load_waveglow(str(out / "waveglow_2"), "cpu", template=small)


# ---------------------------------------------------------------------------
# Reference state dicts: three layouts
# ---------------------------------------------------------------------------

def _reference_state_dict(jp, cfg, layout):
    """A reference WaveGlow state dict of the JAX params ``jp`` in one of
    the layouts: "fused" (cond_layer, res_skip_layers), "vendored"
    (cond_layers.{i}), "old" (cond_layers.{i}, res_layers / skip_layers)
    and "old_plain" (the old one with plain-weight res / skip convs), built
    by splitting rows."""
    C, L = cfg.wn_channels, cfg.wn_layers
    p = _np(jp)
    sd = {"upsample.weight": p["upsample"]["w"],
          "upsample.bias": p["upsample"]["b"]}

    def put(prefix, conv, rows=slice(None), plain=False):
        if plain:
            v, g = conv["v"][rows], conv["g"][rows]
            norm = np.sqrt((v * v).sum(axis=(1, 2), keepdims=True))
            sd[f"{prefix}.weight"] = g * v / norm
        elif "v" in conv:
            sd[f"{prefix}.weight_v"] = conv["v"][rows]
            sd[f"{prefix}.weight_g"] = conv["g"][rows]
        else:
            sd[f"{prefix}.weight"] = conv["w"][rows]
        sd[f"{prefix}.bias"] = conv["b"][rows]

    for k in range(cfg.n_flows):
        sd[f"convinv.{k}.conv.weight"] = p["convinv"][k]["w"][:, :, None]
        wn, pre = p["wn"][k], f"WN.{k}"
        put(f"{pre}.start", wn["start"])
        put(f"{pre}.end", wn["end"])
        for i in range(L):
            put(f"{pre}.in_layers.{i}", wn["in_layers"][i])
        if layout == "fused":
            put(f"{pre}.cond_layer", wn["cond"])
        else:
            for i in range(L):
                put(f"{pre}.cond_layers.{i}", wn["cond"],
                    slice(i * 2 * C, (i + 1) * 2 * C))
        for i in range(L):
            rs = wn["res_skip"][i]
            if layout in ("fused", "vendored"):
                put(f"{pre}.res_skip_layers.{i}", rs)
            elif i < L - 1:
                put(f"{pre}.res_layers.{i}", rs, slice(0, C),
                    plain=layout == "old_plain")
                put(f"{pre}.skip_layers.{i}", rs, slice(C, 2 * C),
                    plain=layout == "old_plain")
            else:
                put(f"{pre}.skip_layers.{i}", rs,
                    plain=layout == "old_plain")
    return sd


@pytest.mark.parametrize("layout", ["fused", "vendored", "old", "old_plain"])
def test_reference_layouts_import_as_jax(weights, layout):
    jp, _ = weights
    sd = _reference_state_dict(jp, JC, layout)
    j = _flat(_np(JW.import_torch_waveglow(sd, JC)))
    t = _flat(waveglow_params_from_torch_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        TC, device="cpu"))
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    if layout != "old_plain":   # the weight-normed layouts keep v / g / b
        base = _flat(_np(jp))
        assert t.keys() == base.keys()
        for k in base:
            np.testing.assert_array_equal(t[k], base[k], err_msg=k)
