"""Multi-rank training of the port (``parallel/mesh.py``) against the JAX
package's mesh, on the CPU over gloo.

In process: the port's sharding plans and rank grid against JAX's (its 8
virtual CPU devices), the sharded loader against JAX's, and the errors for
what a mesh cannot split.  A module fixture spawns one 4-rank gloo group
(``tests/torch_parallel_ranks.py``) that runs the Tacotron 2 train and eval
steps at meshes (4, 1) and (2, 2) on a partial batch (``weight`` zeros
falling unevenly across the ranks) with the soft-DTW and KL alignment
terms, one GAN step and one WaveGlow step at (4, 1), and the HiFi-GAN
generator from model-axis slices; the test holds them to JAX's
single-device step (masks and noise injected) and to the port's
single-process step.

Tolerances: losses 1e-5 relative, the params JAX's mesh test compares
(``tests/test_parallel.py``) rtol 1e-4 / atol 1e-6, gradients 1e-4 of each
leaf's largest element (``tests/test_torch_train._check_grads``), BN
statistics as ``test_torch_train``'s forward test, outputs 2e-4.

A ``slow`` test runs the three training CLIs across two ranks under
``torch.distributed.run``."""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.data.dataset import BucketedLoader as JLoader
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.parallel import mesh as JPM
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.data.dataset import BucketedLoader as TLoader
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.models import waveglow as TWG
from tacotron2_subword_tpu_torch.parallel import mesh as TPM
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tacotron2_subword_tpu_torch.utils.import_jax import (
    adam_state_from_numpy, tacotron2_params_from_numpy)
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
from tests import torch_parallel_ranks as RANKS
from tests.test_model import SMALL
from tests.test_torch_train import (OUT_KEYS, TOL, _batch, _check_grads,
                                    _jax_eval_step, _jax_train_step, _np,
                                    jax_randomness)
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SMALL.replace(n_symbols=24, sub_n_symbols=32, softdtw_loss_weight=1.0,
                    align_loss="KL")
B, T_OUT = 8, 8
# rows 5-7 are repeats: ranks (4,1) 2 and 3, and (2,2)'s data rank 1,
# get 1, 2 and 3 of them
WEIGHT = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
H = dict(resblock="1", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
         upsample_initial_channel=32, resblock_kernel_sizes=(3,),
         resblock_dilation_sizes=((1, 2, 3),), num_mels=80)
WG = dict(n_mel_channels=8, n_flows=2, n_group=4, n_early_every=4,
          n_early_size=2, wn_layers=2, wn_channels=16, wn_kernel_size=3,
          upsample_kernel=1024, upsample_stride=256)
JOIN_S = 300


def _paths(tree, prefix=()):
    """{path tuple: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _jax_dims(shardings):
    """{path: the dim split over 'model' or None} of a JAX sharding tree."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        spec = tuple(s.spec)
        dims = [i for i, a in enumerate(spec) if a == "model"]
        out[JPM._path_keys(path)] = dims[0] if dims else None
    return out


@pytest.fixture(scope="module")
def jmesh():
    return JPM.make_mesh(n_model=2, devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def states():
    """JAX's train state of CFG (its init jitted: one compile, not one
    per op) and the port's copy, as ``test_torch_train._states``."""
    jtx = JT.make_optimizer(CFG)
    jstate = jax.jit(lambda k: JT.create_train_state(k, CFG, jtx)[0])(
        jax.random.PRNGKey(0))
    tcfg = TConfig(**dataclasses.asdict(CFG))
    tp, tbn = tacotron2_params_from_numpy(_np(jstate.params),
                                          _np(jstate.bn_state), tcfg,
                                          device="cpu")
    adam = jstate.opt_state[2]
    opt = adam_state_from_numpy(np.asarray(adam.count), _np(adam.mu),
                                _np(adam.nu), tp, device="cpu")
    return jstate, jtx, TT.TrainState(0, tp, tbn, opt), tcfg


# ---------------------------------------------------------------------------
# Four ranks of one gloo group
# ---------------------------------------------------------------------------

def _narrow_discriminators(g):
    """The 5 MPD + 3 MSD tree at narrow channels (the layers read their
    widths from the weights; MSD's groups stay the spec's)."""
    wn = THG._wn_init
    mpd_ch = ((1, 4), (4, 8), (8, 16), (16, 16), (16, 16))
    mpd = [{"convs": [wn(g, (co, ci, 5, 1)) for ci, co in mpd_ch],
            "conv_post": wn(g, (1, 16, 3, 1))} for _ in THG.PERIODS]
    msd_ch = ((1, 16), (16, 16), (16, 32), (32, 32), (32, 32), (32, 32),
              (32, 32))
    msd = [{"convs": [wn(g, (co, ci // spec[4], spec[2]))
                      for (ci, co), spec in zip(msd_ch, THG.SCALE_DISC_SPEC)],
            "conv_post": wn(g, (1, 32, 3))} for _ in range(3)]
    return {"mpd": mpd, "msd": msd}


def _gan_inputs():
    h = THG.HifiganConfig(**H)
    g = torch.Generator().manual_seed(2)
    gen = THG.init_generator(g, h, device="cpu")
    disc = _narrow_discriminators(g)
    tx = TTH.make_optimizer(2e-4)
    rng = np.random.RandomState(4)
    frames = 16
    seg = frames * h.total_upsample
    mel = torch.from_numpy((rng.randn(B, 80, frames) - 4.0).astype(
        np.float32))
    t = np.arange(seg) / 22050.0
    audio = torch.from_numpy(
        (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (B, 1)) * t)
         + 0.05 * rng.randn(B, seg)).astype(np.float32))
    state = TTH.GanState(gen, disc, tx.init(gen), tx.init(disc))
    return {"state": state, "mel": mel, "audio": audio}


def _waveglow_inputs():
    cfg = TWG.WaveGlowConfig(**WG)
    params = TWG.init_waveglow(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
    audio = torch.from_numpy((0.3 * np.random.RandomState(6).randn(
        B, 2048)).astype(np.float32))
    return {"cfg": WG, "params": params, "audio": audio}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, request):
    """Spawns the 4 ranks (they wait for their inputs), makes the inputs
    and the references while they run, and joins them with a deadline (a
    hang fails the test; the ranks are killed)."""
    d = tmp_path_factory.mktemp("ranks")
    inputs = str(d / "inputs.pt")
    with pytest.MonkeyPatch.context() as env:
        # one BLAS thread per rank: four ranks' multi-threaded numpy (the
        # STFT bases' pinv) would otherwise thrash each other
        for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                  "MKL_NUM_THREADS"):
            env.setenv(k, "1")
        ctx = mp.start_processes(
            RANKS.run, args=(4, str(d / "store"), inputs, str(d)), nprocs=4,
            join=False, start_method="spawn")
    try:
        return _run_ranks(ctx, d, inputs, request.getfixturevalue("states"))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _run_ranks(ctx, d, inputs, states):
    jstate, jtx, tstate, _ = states
    b, tb = _batch(CFG, B=B, T_out=T_OUT)
    b["weight"], tb["weight"] = jnp.asarray(WEIGHT), torch.from_numpy(WEIGHT)
    at = (np.random.RandomState(9).rand(B, T_OUT, b["text"].shape[1])
          > 0.7).astype(np.float32)
    b["align_target"], tb["align_target"] = jnp.asarray(at), \
        torch.from_numpy(at)
    k_train, k_eval = jax.random.PRNGKey(5), jax.random.PRNGKey(6)

    # JAX's steps compile in threads, beside the randomness's compiles
    pool = ThreadPoolExecutor(2)
    train = pool.submit(lambda: jax.block_until_ready(
        _jax_train_step(jstate, b, k_train, CFG, jtx)))
    evals = pool.submit(lambda: jax.block_until_ready(
        _jax_eval_step(jstate, b, k_eval, CFG)))
    rnd_train = jax_randomness(CFG, k_train, b, True)
    rnd_eval = jax_randomness(CFG, k_eval, b, False)
    single = CK.save_checkpoint(tstate, str(d), name="single")
    gan, wg = _gan_inputs(), _waveglow_inputs()
    torch.save({"cfg": dataclasses.asdict(CFG), "state": tstate,
                "batch": tb, "rnd_train": rnd_train, "rnd_eval": rnd_eval,
                "single_checkpoint": single, "hifigan_h": H, "gan": gan,
                "waveglow": wg}, inputs + ".tmp")
    os.replace(inputs + ".tmp", inputs)
    (jnew, jm), (jl, jo) = train.result(), evals.result()
    pool.shutdown()
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the ranks ran past {JOIN_S} s")
    out = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    losses, grads, bn = out[2]["reference"]
    return SimpleNamespace(
        out=out, jnew=jnew, jm=jm, jl=jl, jo=jo, losses=losses, grads=grads,
        bn=bn, gan=gan, gan_ref=out[0]["reference"],
        wg_ref=out[1]["reference"], wav_ref=out[3]["reference"], dir=d)


MESHES = [(4, 1), (2, 2)]


def _leaf_list(tree):
    return [t.numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("shape", MESHES)
def test_train_step_matches_jax_single_device(ranks, shape):
    """Every rank returns JAX's global losses and, gathered, JAX's updated
    params and BN statistics; its gradients are the single-process
    step's."""
    jnew, jm = ranks.jnew, ranks.jm
    for r in ranks.out:
        res = r[shape]
        for k in jm:
            np.testing.assert_allclose(res["metrics"][k].item(), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        full = res["full"]
        for path in (("decoder", "gate_layer", "w"), ("embedding",),
                     ("embedding_sub",)):
            a, ref = full.params, jnew.params
            for k in path:
                a, ref = a[k], ref[k]
            np.testing.assert_allclose(a.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-6, err_msg=path)
        jbn, tbn = _paths(_np(jnew.bn_state)), _paths(full.bn_state)
        assert jbn.keys() == tbn.keys()
        for k in jbn:
            np.testing.assert_allclose(tbn[k].numpy(), jbn[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        _check_grads(_leaf_list(res["grads"]), _leaf_list(ranks.grads))
        assert full.step == 1 and int(full.opt_state.count) == 1


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_agree(ranks, shape):
    """The gradients and the new params (gathered) are bit-identical on
    every rank; the BN statistics equal the single-process step's."""
    first = ranks.out[0][shape]
    for r in ranks.out[1:]:
        for key in ("grads", "full"):
            for a, b in zip(tree_leaves(r[shape][key]),
                            tree_leaves(first[key])):
                assert torch.equal(torch.as_tensor(a),
                                   torch.as_tensor(b)), key
        for k in first["losses"]:
            assert torch.equal(r[shape]["losses"][k], first["losses"][k])
    for a, b in zip(tree_leaves(first["bn"]), tree_leaves(ranks.bn)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_eval_step_matches_jax_single_device(ranks, shape):
    """The global eval losses on every rank; the data ranks' outputs,
    concatenated, are JAX's."""
    for r in ranks.out:
        for k in ranks.jl:
            np.testing.assert_allclose(r[shape]["eval_losses"][k].item(),
                                       float(ranks.jl[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    rows = sorted((r[shape]["coords"][0], r[shape]["outputs"])
                  for r in ranks.out if r[shape]["coords"][1] == 0)
    for k in OUT_KEYS:
        got = torch.cat([o[k] for _, o in rows]).numpy()
        np.testing.assert_allclose(got, np.asarray(ranks.jo[k]), **TOL,
                                   err_msg=k)


def test_model_axis_stores_slices(ranks):
    """At (2, 2) the embeddings and the LSTM moments are stored as halves;
    at (4, 1) whole."""
    for r in ranks.out:
        assert r[(2, 2)]["stored_shapes"] == {"embedding": (12, 16),
                                              "embedding_sub": (16, 16)}
        assert r[(2, 2)]["mu_shape"] == (48, 72)
        assert r[(4, 1)]["stored_shapes"] == {"embedding": (24, 16),
                                              "embedding_sub": (32, 16)}


@pytest.mark.parametrize("shape", MESHES)
def test_checkpoints_cross_meshes(ranks, shape):
    """Rank (0, 0) writes the full state in the one-file format: one
    process loads it as the gathered state; every rank loads it, and a
    single-process checkpoint, back into its slices."""
    name = f"ck_{shape[0]}x{shape[1]}"
    loaded, _ = CK.load_checkpoint(str(ranks.dir / name), "cpu")
    for a, b in zip(tree_leaves(loaded), tree_leaves(ranks.out[0][shape]
                                                     ["full"])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    for r in ranks.out:
        assert r[shape]["reload_equal"] and r[shape]["single_shard_equal"]


def test_hifigan_generator_from_model_slices(ranks):
    """The generator's forward on ups weights gathered from model=2 slices
    equals the replicated forward (JAX's test_hifigan_model_sharding)."""
    for r in ranks.out:
        g = r[(2, 2)]["generator"]
        assert g["ups0_v_shape"] == (32, 8, 8)
        np.testing.assert_allclose(g["wav"].numpy(), ranks.wav_ref.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_gan_step_data_parallel(ranks):
    """One GAN step at (4, 1) equals the single-process step on the global
    batch: the losses 1e-5 relative, each leaf's update within 1 % of the
    leaf's largest update plus one f32 spacing (Adam's first step turns
    near-eps gradient noise into step noise)."""
    ref_state, ref_m = ranks.gan_ref
    before = ranks.gan["state"]
    for r in ranks.out:
        state, m = r[(4, 1)]["gan"]["state"], r[(4, 1)]["gan"]["metrics"]
        for k in ref_m:
            np.testing.assert_allclose(m[k].item(), ref_m[k].item(),
                                       rtol=1e-5, err_msg=k)
        for name in ("gen", "disc"):
            for a, ref, p0 in zip(tree_leaves(getattr(state, name)),
                                  tree_leaves(getattr(ref_state, name)),
                                  tree_leaves(getattr(before, name))):
                upd = (ref - p0).abs().max().item()
                tol = 1e-2 * upd + np.spacing(np.float32(
                    p0.abs().max().item()))
                assert (a - ref).abs().max().item() <= tol, name


def test_waveglow_step_data_parallel(ranks):
    """The WaveGlow NLL and its gradients at (4, 1) equal the
    single-process ones on the global batch."""
    nll, grads = ranks.wg_ref
    for r in ranks.out:
        w = r[(4, 1)]["waveglow"]
        np.testing.assert_allclose(w["nll"].item(), nll.item(), rtol=1e-5)
        assert w["nll_step"].item() == w["nll"].item()
        _check_grads(_leaf_list(w["grads"]), _leaf_list(grads))


# ---------------------------------------------------------------------------
# In process: plans, rank grid, loader, errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [1, 2])
def test_tacotron_plans_match_jax(states, n_model):
    """tacotron_param_sharding and train_state_shardings split the leaves
    JAX's plans split, on the same dims; Adam's moments follow their
    param."""
    jstate, _, tstate, _ = states
    jm = JPM.make_mesh(n_model=n_model, devices=jax.devices()[:8])
    mesh = TPM.Mesh(n_data=8 // n_model, n_model=n_model)
    want = _jax_dims(JPM.tacotron_param_sharding(jstate.params, jm))
    got = _paths(TPM.tacotron_param_sharding(tstate.params, mesh))
    assert got == want
    assert sum(d is not None for d in got.values()) == (
        14 if n_model > 1 else 0)
    jss = JPM.train_state_shardings(jstate, jm)
    tss = TPM.train_state_shardings(tstate, mesh)
    for name in ("mu", "nu"):
        jopt = {k[k.index(name) + 1:]: d
                for k, d in _jax_dims(jss.opt_state).items() if name in k}
        assert _paths(getattr(tss.opt_state, name)) == jopt == want
    assert tss.opt_state.count is None and tss.step is None
    assert all(d is None for d in _paths(tss.bn_state).values())


def test_hifigan_plan_matches_jax(jmesh):
    jp = jax.eval_shape(lambda k: JHG.init_generator(
        k, JHG.HifiganConfig(**H)), jax.random.PRNGKey(0))
    tp = THG.init_generator(torch.Generator().manual_seed(0),
                            THG.HifiganConfig(**H), device="cpu")
    got = _paths(TPM.hifigan_param_sharding(tp, TPM.Mesh(4, 2)))
    assert got == _jax_dims(JPM.hifigan_param_sharding(jp, jmesh))
    assert got[("ups", 0, "v")] == 1 and got[("ups", 1, "b")] == 0
    assert got[("ups", 0, "g")] is None


@pytest.mark.parametrize("across", [False, True])
def test_rank_grid_matches_jax_device_grid(across):
    jm = JPM.make_mesh(n_data=4, n_model=2, devices=jax.devices()[:8],
                       model_across_processes=across)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(TPM.rank_grid(4, 2, across), ids)


class _DS:
    """tests/test_multihost.py's dataset: 12 utterances, three buckets."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return {"text": np.full(5 + i % 3, i, np.int32),
                "sub": np.full(3, i, np.int32),
                "cls": rng.randn(4).astype(np.float32),
                "mel": rng.randn(2, 10 + i).astype(np.float32)}


EDGES = dict(text_edges=(8,), sub_edges=(4,), mel_edges=(16, 24))


def test_sharded_loader_concatenates_to_jax_batches():
    """Lockstep shards: each holds its contiguous rows of the JAX loader's
    global batch, ``weight`` included (the partial batches too)."""
    full = list(JLoader(_DS(), batch_size=4, seed=3, **EDGES))
    shards = [list(TLoader(_DS(), batch_size=4, seed=3, shard_index=i,
                           num_shards=2, shard_within_batch=True, **EDGES))
              for i in range(2)]
    assert len(shards[0]) == len(shards[1]) == len(full) > 2
    assert any(b["weight"].min() == 0 for b in full)
    for b0, b1, bf in zip(*shards, full):
        assert set(b0) == set(bf)
        for k in bf:
            assert len(b0[k]) == 2
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]),
                                          bf[k], err_msg=k)


def test_strided_shards_match_jax():
    for i in range(2):
        kw = dict(batch_size=2, seed=3, shard_index=i, num_shards=2, **EDGES)
        jb, tb = list(JLoader(_DS(), **kw)), list(TLoader(_DS(), **kw))
        assert len(jb) == len(tb) > 1
        for a, b in zip(jb, tb):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n_symbols,sub_n_symbols,n_model,leaf", [
    (25, 32, 2, "(25, 16)"), (24, 33, 3, "(80, 26)")])
def test_a_leaf_the_model_axis_does_not_divide_raises(
        n_symbols, sub_n_symbols, n_model, leaf):
    """A vocabulary, or an LSTM's 4H, that n_model does not divide."""
    cfg = TConfig(**dataclasses.asdict(CFG.replace(
        n_symbols=n_symbols, sub_n_symbols=sub_n_symbols)))
    state, _ = TT.create_train_state(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    mesh = TPM.Mesh(n_data=1, n_model=n_model)
    with pytest.raises(ValueError, match=re.escape(leaf)):
        TPM.shard_train_state(state, mesh)


def test_a_batch_the_data_axis_does_not_divide_raises():
    with pytest.raises(ValueError, match="not divisible"):
        TLoader(_DS(), batch_size=5, num_shards=2, shard_within_batch=True)
    with pytest.raises(ValueError, match="not divisible"):
        TPM.shard_batch({"x": torch.zeros(5, 2)}, TPM.Mesh(n_data=2))
    with pytest.raises(ValueError, match="torch.distributed"):
        TPM.make_mesh(2, 1)


def test_multihost_without_the_torchrun_environment_raises(monkeypatch,
                                                         tmp_path):
    """--multihost never falls back to one process."""
    from tacotron2_subword_tpu_torch.apps import train as TAPP
    for k in TPM.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun environment"):
        TAPP.main(["-o", str(tmp_path), "--synthetic", "4", "--multihost",
                   "--device", "cpu"])
    assert not TPM.torchrun_env()


# ---------------------------------------------------------------------------
# The CLIs across two ranks (slow: several training processes)
# ---------------------------------------------------------------------------

SMALL_HPARAMS = ("[symbols_embedding_dim:16-encoder_embedding_dim:16-"
                 "attention_rnn_dim:20-decoder_rnn_dim:24-prenet_dim:10-"
                 "attention_dim:8-postnet_embedding_dim:16-n_symbols:24-"
                 "sub_n_symbols:32-bert_embedding_dim:12-"
                 "attention_location_n_filters:4-"
                 "attention_location_kernel_size:7-parity_mode:true-"
                 "softdtw_loss_weight:1.0-iters_per_checkpoint:2]")
LOSS_RE = re.compile(r"iter (\d+): loss ([\d.eE+-]+)")


def _torchrun(n, module, args, timeout=600):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", module, *args]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


@pytest.mark.slow
def test_training_clis_across_two_ranks(tmp_path):
    """apps.train with --multihost on 2 gloo ranks at batch 2 per rank:
    the losses of one process at batch 4, a checkpoint by rank 0, a resume
    from it; train_hifigan and train_waveglow on 2 ranks."""
    base = ["--synthetic", "8", "--hparams", SMALL_HPARAMS, "--device",
            "cpu", "--prefetch", "0"]
    mod = "tacotron2_subword_tpu_torch.apps.train"
    out = _torchrun(2, mod, ["-o", str(tmp_path / "mr"), "--multihost",
                             "--batch-size", "2", "--max-iters", "2",
                             *base])
    multi = [float(m.group(2)) for m in LOSS_RE.finditer(out)]
    assert len(multi) == 2 and "validation loss" in out
    assert (tmp_path / "mr" / "checkpoint_2" / "state.pt").is_file()
    single = subprocess.run(
        [sys.executable, "-m", mod, "-o", str(tmp_path / "sp"),
         "--batch-size", "4", "--max-iters", "2", *base], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr[-3000:]
    ref = [float(m.group(2)) for m in LOSS_RE.finditer(single.stdout)]
    np.testing.assert_allclose(multi, ref, rtol=1e-5)
    # the 2-rank checkpoint resumes on one process, and on two ranks with
    # a model axis
    resumed = subprocess.run(
        [sys.executable, "-m", mod, "-o", str(tmp_path / "mr"),
         "--batch-size", "4", "--max-iters", "3", *base], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "at iteration 2" in resumed.stdout
    out = _torchrun(2, mod, ["-o", str(tmp_path / "sp"), "--multihost",
                             "--model-parallel", "2", "--batch-size", "4",
                             "--max-iters", "3", *base])
    assert "at iteration 2" in out and "iter 3: loss" in out

    gcfg = tmp_path / "g.json"
    gcfg.write_text(json.dumps({
        "resblock": "1", "upsample_rates": [8, 8, 4],
        "upsample_kernel_sizes": [16, 16, 8], "upsample_initial_channel": 16,
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
        "num_mels": 80}))
    out = _torchrun(2, "tacotron2_subword_tpu_torch.apps.train_hifigan", [
        "-o", str(tmp_path / "g"), "--synthetic", "4", "--batch-size", "1",
        "--iters", "2", "--iters-per-checkpoint", "2", "--config",
        str(gcfg), "--device", "cpu"])
    assert "2 data ranks" in out and "iter 2:" in out
    assert (tmp_path / "g" / "g_00000002").is_file()
    wcfg = tmp_path / "w.json"
    wcfg.write_text(json.dumps({"waveglow_config": {
        "n_mel_channels": 80, "n_flows": 2, "n_group": 4, "n_early_every": 4,
        "n_early_size": 2, "WN_config": {"n_layers": 2, "n_channels": 16,
                                         "kernel_size": 3}}}))
    out = _torchrun(2, "tacotron2_subword_tpu_torch.apps.train_waveglow", [
        "-o", str(tmp_path / "w"), "--synthetic", "2", "--batch-size", "1",
        "--iters", "2", "--iters-per-checkpoint", "2", "--config",
        str(wcfg), "--device", "cpu"])
    assert "2 data ranks" in out and "iter 2:" in out
    assert (tmp_path / "w" / "waveglow_2").is_file()
