"""The port's HiFi-GAN training half against the JAX package's, on the CPU
at the small size of tests/test_vocoders.py (a 32-channel generator
upsampling 16x; the discriminators have no size knob, so they run at full
width on 256-sample waveforms).

Tolerances: discriminator logits and feature maps 1e-5 of each map's
scale, losses 1e-5 relative (the same f32 convolutions summed in another
order); one D+G step from the same weights, Adam state and batch (the generator
on all its terms, on the adversarial term alone and on the feature term
alone): losses 1e-5 relative and each leaf's update (params after -
before) within 1 % of the largest element of the JAX update of that leaf,
plus one f32 spacing of the leaf's params; optimizer updates from
identical gradients 1e-6; samplers, schedule counts and checkpoint round
trips exactly."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io.wavfile import write

from tacotron2_subword_tpu.apps import inference as JI
from tacotron2_subword_tpu.apps import train_hifigan as JTH
from tacotron2_subword_tpu.models import hifigan as HG
from tacotron2_subword_tpu.nn import layers as JL
from tacotron2_subword_tpu.ops import stft as JS
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.nn import layers as TL
from tacotron2_subword_tpu_torch.utils.import_jax import (
    hifigan_discriminators_from_numpy, hifigan_params_from_numpy,
    optax_adam_state_from_numpy)
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL_H = dict(resblock="1", upsample_rates=(4, 4),
               upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
               resblock_kernel_sizes=(3, 5),
               resblock_dilation_sizes=((1, 2, 3), (1, 2, 3)), num_mels=80)
JH, TH = HG.HifiganConfig(**SMALL_H), THG.HifiganConfig(**SMALL_H)
FRAMES = 16                  # mel frames of a training segment here
SEG = FRAMES * JH.total_upsample
LR = 2e-4
# the CLI's generator: 256x upsampling (one mel frame per hop), 16 channels
CLI_H = {"resblock": "1", "upsample_rates": [8, 8, 4],
         "upsample_kernel_sizes": [16, 16, 8], "upsample_initial_channel": 16,
         "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
         "num_mels": 80}


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.detach() if isinstance(a, torch.Tensor)
                             else a), tree)


def _leaves(tree):
    return [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def weights():
    """(JAX generator, JAX discriminators, the port's copies): drawn by the
    port's init (the JAX init's trees, checked below; its eager draws
    compile once per shape), handed to JAX as numpy and carried back by the
    weight bridge."""
    gen = _np(THG.init_generator(torch.Generator().manual_seed(0), TH,
                                 device="cpu"))
    disc = _np(THG.init_discriminators(torch.Generator().manual_seed(1),
                                       device="cpu"))
    return (gen, disc, hifigan_params_from_numpy(gen, TH, device="cpu"),
            hifigan_discriminators_from_numpy(disc, device="cpu"))


def test_discriminator_init_matches_jax_tree():
    """The port's discriminator tree is the JAX init's: the same keys,
    nesting and shapes (JAX's traced with eval_shape, nothing drawn)."""
    j = jax.eval_shape(HG.init_discriminators, jax.random.PRNGKey(0))
    t = THG.init_discriminators(torch.Generator().manual_seed(0), "cpu")
    jl, jdef = jax.tree_util.tree_flatten(j)
    tl, tdef = jax.tree_util.tree_flatten(t)
    assert jdef == tdef
    assert [a.shape for a in jl] == [tuple(a.shape) for a in tl]


def _batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    mel = (rng.randn(B, 80, FRAMES) - 4.0).astype(np.float32)
    t = np.arange(SEG) / 22050.0
    audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * t)
             + 0.05 * rng.randn(B, SEG)).astype(np.float32)
    return mel, audio


def test_conv_helpers_match_jax():
    """conv1d with stride and groups (the MSD's) and the NCHW conv2d
    (the MPD's), f32, 1e-5 of scale."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 50).astype(np.float32)
    w = rng.randn(16, 2, 7).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    j = np.asarray(JL.conv1d_apply({"w": w, "b": b}, x, stride=2, padding=3,
                                   groups=4))
    t = TL.conv1d_apply({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), padding=3, stride=2, groups=4)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())
    x2 = rng.randn(2, 3, 20, 5).astype(np.float32)
    w2 = rng.randn(4, 3, 5, 1).astype(np.float32)
    j2 = np.asarray(HG._conv2d({"w": w2, "b": b[:4]}, x2, stride=(3, 1),
                               padding=((2, 2), (0, 0))))
    t2 = TL.conv2d_apply({"w": torch.from_numpy(w2),
                          "b": torch.from_numpy(b[:4])},
                         torch.from_numpy(x2), stride=(3, 1), padding=(2, 0))
    np.testing.assert_allclose(t2.numpy(), j2, rtol=0,
                               atol=1e-5 * np.abs(j2).max())


@pytest.fixture(scope="module")
def disc_outputs(weights):
    _, disc, _, tdisc = weights
    rng = np.random.RandomState(3)
    # 300 samples: a multiple of no period, so each one reflect-pads
    y = (0.3 * rng.randn(2, 1, 300)).astype(np.float32)
    y_hat = (0.3 * rng.randn(2, 1, 300)).astype(np.float32)
    j = jax.jit(HG.discriminators_apply)(disc, y, y_hat)
    t = THG.discriminators_apply(tdisc, torch.from_numpy(y),
                                 torch.from_numpy(y_hat))
    return j, t


def test_discriminators_match_jax(disc_outputs):
    j, t = disc_outputs
    assert len(j[0]) == len(t[0]) == 8           # 5 periods + 3 scales
    jl, tl = _leaves(j), _leaves(t)
    assert len(jl) == len(tl) == 2 * 8 + 2 * (5 * 6 + 3 * 8)
    for a, ref in zip(tl, jl):
        assert a.shape == ref.shape
        np.testing.assert_allclose(a, ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("loss", ["discriminator_loss", "generator_adv_loss",
                                  "feature_loss"])
def test_gan_losses_match_jax(disc_outputs, loss):
    j, t = disc_outputs
    args = {"discriminator_loss": lambda o: (o[0], o[1]),
            "generator_adv_loss": lambda o: (o[1],),
            "feature_loss": lambda o: (o[2], o[3])}[loss]
    ref = float(jax.jit(getattr(HG, loss))(*args(j)))
    out = getattr(THG, loss)(*args(t)).item()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def _warm_adam(tx, params, seed):
    """``tx.init(params)`` with count 5, first moments 0 and seeded second
    moments (nu > 0): the update follows this step's gradient and is
    smooth in it, so rounding noise stays noise."""
    adam, sched = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    rng = np.random.RandomState(seed)
    mu = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                params)
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-6 + 1e-4 * rng.rand(*p.shape), jnp.float32),
        params)
    count = jnp.asarray(5, jnp.int32)
    return (adam._replace(count=count, mu=mu, nu=nu),
            sched._replace(count=count))


@pytest.fixture(scope="module")
def warm_states(weights):
    """(the JAX optimizer of the step tests: a staircase of x0.5 every 2
    steps, its warm state for the generator, for the discriminators)."""
    gen, disc = weights[:2]
    tx = JTH.make_optimizer(LR, 0.5, 2)
    return tx, _warm_adam(tx, gen, 1), _warm_adam(tx, disc, 2)


@functools.lru_cache(maxsize=None)
def _jax_step(mel_only, tx):
    """The JAX CLI's ``step_impl`` (a closure inside its ``train``), rebuilt
    from the same functions, with optimizer ``tx`` and a weight w [3] on
    the generator's adversarial, feature and mel terms (1 each in the
    CLI); jitted once per mode."""
    h = JH
    stft_w = 1.0

    def mel_loss(y_hat, audio):
        mel_hat = JS.mel_spectrogram(y_hat[:, 0, :])
        mel_y = JS.mel_spectrogram(audio)
        n = min(mel_hat.shape[-1], mel_y.shape[-1])
        return jnp.mean(jnp.abs(mel_hat[..., :n] - mel_y[..., :n]))

    def d_loss_fn(disc_p, gen_p, mel, audio):
        y_hat = HG.generator_apply(gen_p, h, mel)
        rs, gs, _, _ = HG.discriminators_apply(
            disc_p, audio[:, None, :], jax.lax.stop_gradient(y_hat))
        return HG.discriminator_loss(rs, gs)

    def g_loss_fn(gen_p, disc_p, mel, audio, w):
        y_hat = HG.generator_apply(gen_p, h, mel)
        rs, gs, fr, fg = HG.discriminators_apply(disc_p, audio[:, None, :],
                                                 y_hat)
        lm = mel_loss(y_hat, audio)
        return (w[0] * HG.generator_adv_loss(gs)
                + w[1] * HG.feature_loss(fr, fg) + 45.0 * w[2] * lm), lm

    def mel_only_loss_fn(gen_p, mel, audio):
        y_hat = HG.generator_apply(gen_p, h, mel)
        lm = mel_loss(y_hat, audio)
        sm_hat = JS.stft_magnitude(y_hat[:, 0, :], 1024, 256, 1024)
        sm_y = JS.stft_magnitude(audio, 1024, 256, 1024)
        k = min(sm_hat.shape[-1], sm_y.shape[-1])
        ls = jnp.mean(jnp.abs(jnp.log(jnp.maximum(sm_hat[..., :k], 1e-5))
                              - jnp.log(jnp.maximum(sm_y[..., :k], 1e-5))))
        return 45.0 * lm + stft_w * ls, lm

    def step(gen_p, disc_p, og, od, mel, audio, w):
        if mel_only:
            (gl, lm), gg = jax.value_and_grad(mel_only_loss_fn, has_aux=True)(
                gen_p, mel, audio)
            gu, og = tx.update(gg, og, gen_p)
            return (optax.apply_updates(gen_p, gu), disc_p, og, od,
                    jnp.float32(0.0), gl, lm)
        dl, dg = jax.value_and_grad(d_loss_fn)(disc_p, gen_p, mel, audio)
        du, od = tx.update(dg, od, disc_p)
        disc_p = optax.apply_updates(disc_p, du)
        (gl, lm), gg = jax.value_and_grad(g_loss_fn, has_aux=True)(
            gen_p, disc_p, mel, audio, w)
        gu, og = tx.update(gg, og, gen_p)
        return optax.apply_updates(gen_p, gu), disc_p, og, od, dl, gl, lm
    return jax.jit(step)


# the generator's terms each mode keeps: the mel term's gradient is ~1e6 x
# the other two's at this size, so the adversarial and the feature terms
# are each also checked alone, where they carry the update
STEP_TERMS = {"gan": (1.0, 1.0, 1.0), "adv": (1.0, 0.0, 0.0),
              "feat": (0.0, 1.0, 0.0), "mel_only": None}


@pytest.mark.parametrize("mode", list(STEP_TERMS))
def test_gan_step_matches_jax(weights, warm_states, mode):
    """One step of the JAX CLI's and one of the port's ``gan_step`` from the
    same generator, discriminators, Adam states (count 5 into a staircase
    of 0.5 every 2 steps: lr * 0.25) and batch; in ``adv`` and ``feat`` the
    generator's other terms are weighted 0 on both sides (``terms``)."""
    gen, disc, tgen, tdisc = weights
    mel_only = mode == "mel_only"
    w = STEP_TERMS[mode] or (1.0, 1.0, 1.0)
    jtx, og, od = warm_states
    step = _jax_step(mel_only, jtx)
    mel, audio = _batch()
    j = step(gen, disc, og, od, mel, audio, jnp.asarray(w, jnp.float32))
    ttx = TTH.make_optimizer(LR, 0.5, 2)
    state = TTH.GanState(tgen, tdisc,
                         optax_adam_state_from_numpy(_np(og), tgen, "cpu"),
                         optax_adam_state_from_numpy(_np(od), tdisc, "cpu"))
    new, m = TTH.gan_step(state, torch.from_numpy(mel),
                          torch.from_numpy(audio), TH, ttx, ttx,
                          mel_only=mel_only, stft_loss_weight=1.0, terms=w)
    for k, ref in zip(("d_loss", "g_loss", "mel_l1"), j[4:]):
        np.testing.assert_allclose(m[k].item(), float(ref), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # each leaf's update (params after - before) within 1 % of the JAX
    # update's largest element, plus one f32 spacing of the leaf's largest
    # param (where both new params round)
    for ours, ref, old in ((new.gen, j[0], gen), (new.disc, j[1], disc)):
        for a, r, o in zip(_leaves(ours), _leaves(ref), _leaves(old)):
            u_jax = r.astype(np.float64) - o
            err = np.abs(a.astype(np.float64) - o - u_jax).max()
            assert err <= (1e-2 * np.abs(u_jax).max()
                           + np.spacing(np.abs(o).max()))
        if mode in ("adv", "feat"):   # the term alone moved the generator
            assert max(np.abs(r - o).max() for r, o in zip(
                _leaves(j[0]), _leaves(gen))) > 0
    if mel_only:   # the discriminators stay as they were, to the bit
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(new.disc), tree_leaves(tdisc)))
    assert int(new.opt_g.count) == int(j[2][0].count) == 6
    assert int(new.opt_d.count) == int(j[3][0].count) == (5 if mel_only
                                                          else 6)


@pytest.mark.parametrize("lr_decay", [0.5, 1.0])
def test_optimizer_matches_optax(lr_decay):
    """Six updates from identical gradients: the staircase (x0.5 every 2
    steps, test_hifigan_lr_decay_schedule's setting) or a constant lr."""
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": [rng.randn(5).astype(np.float32)]}
    jtx = JTH.make_optimizer(1e-2, lr_decay, 2)
    ttx = TTH.make_optimizer(1e-2, lr_decay, 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    jst, tst = jtx.init(jp), ttx.init(tp)
    for step in range(6):
        g = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), params)
        ju, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        tu, tst = ttx.update(jax.tree_util.tree_map(torch.from_numpy, g),
                             tst, tp)
        for a, ref in zip(_leaves(tu), _leaves(ju)):
            np.testing.assert_allclose(a, ref, rtol=1e-6, atol=1e-9)
    assert int(tst.count) == int(jst[0].count) == 6


def test_optax_state_import_checks_the_schedule_count(weights):
    gen, _, tgen, _ = weights
    adam, sched = JTH.make_optimizer(LR, 0.5, 2).init(gen)
    bad = (adam, sched._replace(count=jnp.asarray(3, jnp.int32)))
    with pytest.raises(ValueError, match="schedule count"):
        optax_adam_state_from_numpy(_np(bad), tgen, "cpu")
    # a constant-lr state (EmptyState) carries no second count
    st = optax_adam_state_from_numpy(
        _np(JTH.make_optimizer(LR, 1.0).init(gen)), tgen, "cpu")
    assert int(st.count) == 0


def test_discriminator_import_checks_shapes(weights):
    _, disc, _, _ = weights
    bad = _np(disc)
    bad["msd"][1]["convs"][2]["v"] = bad["msd"][1]["convs"][2]["v"][:, :4]
    with pytest.raises(ValueError, match="msd.1.convs.2.v"):
        hifigan_discriminators_from_numpy(bad, device="cpu")


def _wavs(root, n, seconds, seed=0):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        t = np.arange(int(seconds[i] * 22050)) / 22050.0
        w = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.02 * rng.randn(len(t))
        paths.append(str(root / f"c{i}.wav"))
        write(paths[-1], 22050, (w * 32767).astype(np.int16))
    return paths


@pytest.mark.parametrize("gta", [False, True])
def test_segment_sampler_matches_jax(tmp_path, gta):
    """The same RandomState draws give the JAX package's batches: from
    GTA mels (one clip's mel too short, so skipped) or mels of the audio
    (1e-5 of scale: two STFTs).  B=8: what the JAX CLI samples at
    --batch-size 1 on the 8 virtual devices of tests/conftest.py, and the
    port at --batch-size 8."""
    paths = _wavs(tmp_path / "wav", 4, [0.06, 0.07, 0.08, 0.03])
    mel_dir = None
    if gta:
        mel_dir = tmp_path / "gta"
        mel_dir.mkdir()
        rng = np.random.RandomState(1)
        for i, n in enumerate([6, 5, 3, 4]):   # frames; c2's is too short
            np.save(mel_dir / f"c{i}.npy",
                    rng.randn(80, n).astype(np.float32))
        mel_dir = str(mel_dir)
    j = JTH.SegmentSampler(paths, mel_dir, segment=1024, seed=0)
    t = TTH.SegmentSampler(paths, mel_dir, segment=1024, seed=0)
    assert len(j) == len(t) == (2 if gta else 3)
    for _ in range(3):
        jm, ja = j.sample_batch(8)
        tm, ta = t.sample_batch(8)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_allclose(tm, jm, rtol=0,
                                   atol=1e-5 * np.abs(jm).max())
    js, ts = JTH.SyntheticSegments(3, 512), TTH.SyntheticSegments(3, 512)
    np.testing.assert_array_equal(ts.sample_batch(8)[1],
                                  js.sample_batch(8)[1])


def _state(weights, seed):
    _, _, tgen, tdisc = weights
    tx = TTH.make_optimizer(LR, 0.999, 4)
    og, od = tx.init(tgen), tx.init(tdisc)
    rng = np.random.RandomState(seed)
    bump = lambda t: t + torch.from_numpy(
        rng.rand(*t.shape).astype(np.float32))
    og = og._replace(count=og.count + 7, mu=jax.tree_util.tree_map(bump,
                                                                   og.mu))
    return TTH.GanState(tgen, tdisc, og, od)


def test_gan_state_roundtrip_and_mismatch(tmp_path, weights):
    """A ``state_`` file restores bit for bit against a fresh template (the
    two optimizer states told apart), and a template of another structure
    raises."""
    state = _state(weights, 0)
    path = str(tmp_path / "state_00001234")
    TTH.save_gan_state(path, state, 1234)
    g, d = (THG.init_generator(torch.Generator().manual_seed(5), TH, "cpu"),
            THG.init_discriminators(torch.Generator().manual_seed(6), "cpu"))
    tx = TTH.make_optimizer(LR)
    fresh = TTH.GanState(g, d, tx.init(g), tx.init(d))
    got, it = TTH.restore_gan_state(path, fresh, "cpu")
    assert it == 1234
    for a, b in ((got.gen, state.gen), (got.disc, state.disc),
                 (got.opt_g, state.opt_g), (got.opt_d, state.opt_d)):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(la, lb))
    other = THG.HifiganConfig(**{**SMALL_H, "resblock_kernel_sizes": (3,),
                                 "resblock_dilation_sizes": ((1, 2, 3),)})
    g2 = THG.init_generator(torch.Generator().manual_seed(5), other, "cpu")
    with pytest.raises(ValueError, match="structure"):
        TTH.restore_gan_state(path, fresh._replace(gen=g2, opt_g=tx.init(g2)),
                              "cpu")
    with pytest.raises(ValueError, match="structure"):   # the slots swapped
        TTH.restore_gan_state(path, fresh._replace(opt_g=fresh.opt_d,
                                                   opt_d=fresh.opt_g), "cpu")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The CLI on 4 synthetic clips at B=2 with 512-sample segments and a
    small generator: 2 iterations with a checkpoint, --resume for 2 more,
    then --mel-only --stft-loss-weight 1 for 1."""
    d = tmp_path_factory.mktemp("hifigan_cli")
    cfg = d / "config.json"
    cfg.write_text(json.dumps(CLI_H))
    out = d / "out"
    base = ["-o", str(out), "--synthetic", "4", "--batch-size", "2",
            "--config", str(cfg), "--iters-per-checkpoint", "2",
            "--device", "cpu"]
    restored = []
    real_restore = TTH.restore_gan_state
    with pytest.MonkeyPatch.context() as mp:
        seg = TTH.SyntheticSegments
        mp.setattr(TTH, "SyntheticSegments", lambda n: seg(n, segment=512))
        mp.setattr(TTH, "restore_gan_state", lambda *a: (
            restored.append(real_restore(*a)) or restored[-1]))
        first = TTH.main(base + ["--iters", "2"])
        saved = torch.load(out / "state_00000002", weights_only=True)
        second = TTH.main(base + ["--iters", "2", "--resume",
                                  str(out / "state_00000002")])
        third = TTH.main(base + ["--iters", "1", "--resume",
                                 str(out / "state_00000004"), "--mel-only",
                                 "--stft-loss-weight", "1.0",
                                 "--iters-per-checkpoint", "1"])
    return d, out, cfg, first, second, third, saved, restored


def test_cli_checkpoints_resume_and_loss_curve(cli_run):
    d, out, _, first, second, third, saved, restored = cli_run
    assert first["iterations"] == 2 and first["start_iteration"] == 0
    assert first["decay_every"] == 2                   # 4 clips / B=2
    assert second["start_iteration"] == 2 and second["iterations"] == 4
    assert third["start_iteration"] == 4 and third["iterations"] == 5
    for r in (first, second, third):
        assert np.isfinite(r["losses"]).all()
    assert [l[0] for l in third["losses"]] == [0.0]    # --mel-only: no D
    for it in (2, 4, 5):
        assert (out / f"g_{it:08d}").is_file()
        assert (out / f"state_{it:08d}").is_file()
    # resume: the state handed to the loop is the file's, bit for bit
    got, it = restored[0]
    assert it == 2
    want = [saved["gen"], saved["disc"], saved["opt_g"], saved["opt_d"]]
    have = [got.gen, got.disc, got.opt_g._asdict(), got.opt_d._asdict()]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(have),
                                                 tree_leaves(want)))
    assert int(got.opt_g.count) == 2
    # --mel-only froze the discriminators
    s4 = torch.load(out / "state_00000004", weights_only=True)
    s5 = torch.load(out / "state_00000005", weights_only=True)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s4["disc"]),
                                                 tree_leaves(s5["disc"])))
    rows = (out / "loss_curve.csv").read_text().splitlines()
    assert rows[0] == "iter,d_loss,g_loss,mel_l1,s_per_it"
    assert [int(r.split(",")[0]) for r in rows[1:]] == [1, 2, 3, 4, 5]


def test_g_file_serves_in_both_packages(cli_run):
    """The CLI's g_ file through the port's and the JAX package's
    load_vocoder: the same waveform (1e-5 of scale), and the generator
    the run trained."""
    d, out, cfg, *_ = cli_run
    mel = (np.random.RandomState(4).randn(1, 80, 12) - 4).astype(np.float32)
    t_voc, t_name = TI.load_vocoder(str(out / "g_00000004"), str(cfg), "cpu")
    j_voc, j_name = JI.load_vocoder(str(out / "g_00000004"), str(cfg))
    assert t_name == j_name == "hifigan"
    t = t_voc(torch.from_numpy(mel)).numpy()
    j = np.asarray(j_voc(jnp.asarray(mel)))
    assert t.shape == j.shape == (1, 12 * 256)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())
    st = torch.load(out / "state_00000004", weights_only=True)
    h = THG.HifiganConfig.from_json(str(cfg))
    ref = THG.generator_apply(st["gen"], h, torch.from_numpy(mel))[:, 0]
    np.testing.assert_allclose(t, ref.numpy(), rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_export_generator_is_import_inverse(weights):
    _, _, tgen, _ = weights
    sd = THG.export_torch_generator(tgen)
    assert "conv_pre.weight_v" in sd and "resblocks.3.convs2.2.bias" in sd
    back = THG.export_torch_generator(
        THG.import_torch_generator(sd, TH, device="cpu"))
    assert len(sd) == len(tree_leaves(tgen)) and back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
