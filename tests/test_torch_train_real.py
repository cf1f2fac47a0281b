"""The port's real-data training path against the JAX package's, on the
CPU: the reference-format dataset, its batches, the prefetch loader, SSIM,
and the training CLI on a corpus on disk.

The corpus is written from ``np.random.RandomState(0)`` as the JAX
package's ``tests/test_data.py`` fixture writes it (80 mel channels, phone
IDs < 313, subword IDs < 500, 768-wide [CLS]).  Tolerances: data exact;
SSIM values 1e-6 absolute and gradients 1e-6 absolute plus 1e-5 relative
(the same five f32 convolutions, summed in another order).

The two CLIs' losses cannot match: their dropout and SMA noise come from
different generators (threefry against torch).  So the CLIs are held to
the same batches here, and numeric parity of a step stays with
``tests/test_torch_train.py``, which injects JAX's randomness."""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.data import dataset as JD
from tacotron2_subword_tpu.ops import ssim as JS
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import train as TAPP
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.data import dataset as TD
from tacotron2_subword_tpu_torch.ops import ssim as TS
from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
from tests.test_model import SMALL

N_TRAIN, N_VAL = 6, 2
# SMALL at the corpus's widths; soft-DTW, SSIM and the KL alignment on
CLI_CFG = SMALL.replace(n_symbols=313, sub_n_symbols=500,
                        bert_embedding_dim=768, n_mel_channels=80,
                        softdtw_loss_weight=1.0, ssim_loss_weight=1.0,
                        align_loss="KL", iters_per_checkpoint=2)


def write_corpus(root, n, rng):
    """One split of a reference-format corpus under ``root`` (the JAX
    fixture's draws): ``durs/``, ``mels/``, ``subs/``, ``cls/`` and the list
    ``root + ".txt"`` of ``wav|durations.npy`` rows; returns the rows."""
    for d in ("mels", "subs", "cls", "durs"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rows = []
    for i in range(n):
        T_text = rng.randint(5, 20)
        durs = rng.randint(1, 6, T_text)
        dur = np.stack([rng.randint(0, 313, T_text), durs], axis=1)
        dur_path = os.path.join(root, "durs", f"{i}.npy")
        np.save(dur_path, dur)
        np.save(os.path.join(root, "mels", f"ljspeech-mel-{i + 1:05d}.npy"),
                rng.randn(80, int(durs.sum())).astype(np.float32))
        np.save(os.path.join(root, "subs", f"{i}.npy"),
                rng.randint(0, 500, rng.randint(3, 10)))
        np.save(os.path.join(root, "cls", f"{i}.npy"),
                rng.randn(768).astype(np.float32))
        rows.append([f"wav/{i}.wav", dur_path])
    with open(root + ".txt", "w") as f:
        f.write("".join("|".join(r) + "\n" for r in rows))
    return rows


@pytest.fixture
def corpus(tmp_path):
    """(data dir holding the train and val splits, the train rows)."""
    rng = np.random.RandomState(0)
    root = str(tmp_path / "data")
    rows = write_corpus(os.path.join(root, "train"), N_TRAIN, rng)
    write_corpus(os.path.join(root, "val"), N_VAL, rng)
    return root, rows


def _dirs(split_root):
    return [os.path.join(split_root, d) for d in ("mels", "subs", "cls")]


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ---------------------------------------------------------------------------
# Dataset, batches, prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("load_alignment", [False, True])
def test_dataset_matches_jax(corpus, load_alignment):
    root, rows = corpus
    tr = os.path.join(root, "train")
    jds = JD.BertTacotron2Dataset(rows, *_dirs(tr),
                                  load_alignment=load_alignment)
    tds = TD.BertTacotron2Dataset(rows, *_dirs(tr),
                                  load_alignment=load_alignment)
    assert len(tds) == len(jds) == len(rows)
    for i in range(len(rows)):
        _equal(tds[i], jds[i])
        assert tds.lengths(i) == jds.lengths(i)
    path = tr + ".txt"
    assert TD.load_filepaths(path) == JD.load_filepaths(path)


@pytest.mark.parametrize("durations,n_frames,n_phones", [
    ([2, 1, 3], 6, None),        # exact
    ([2, 1, 3], 9, None),        # frames past the durations stay 0
    ([4, 4, 4], 6, None),        # durations overrun n_frames
    ([3, 0, 5, 2], 7, 6),        # a zero duration, more phones than given
])
def test_create_alignment_target_matches_jax(durations, n_frames, n_phones):
    d = np.asarray(durations, np.int32)
    _equal({"a": TD.create_alignment_target(d, n_frames, n_phones)},
           {"a": JD.create_alignment_target(d, n_frames, n_phones)})


def test_bucketed_batches_match_jax_for_two_epochs(corpus):
    root, rows = corpus
    tr = os.path.join(root, "train")
    jl = JD.BucketedLoader(JD.BertTacotron2Dataset(rows, *_dirs(tr),
                                                   load_alignment=True),
                           batch_size=3, with_alignment=True,
                           text_edges=(8, 16, 32), mel_edges=(32, 64, 128))
    tl = TD.BucketedLoader(TD.BertTacotron2Dataset(rows, *_dirs(tr),
                                                   load_alignment=True),
                           batch_size=3, with_alignment=True,
                           text_edges=(8, 16, 32), mel_edges=(32, 64, 128))
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) > 2
        for a, b in zip(jb, tb):
            _equal(a, b)


def _data_argv(root):
    tr, va = os.path.join(root, "train"), os.path.join(root, "val")
    return ["--train-list", tr + ".txt", "--val-list", va + ".txt",
            "--mel-dir", os.path.join(tr, "mels"),
            "--sub-dir", os.path.join(tr, "subs"),
            "--cls-dir", os.path.join(tr, "cls"),
            "--val-mel-dir", os.path.join(va, "mels"),
            "--val-sub-dir", os.path.join(va, "subs"),
            "--val-cls-dir", os.path.join(va, "cls")]


def test_cli_batches_match_the_jax_cli(corpus):
    """The datasets and loaders as the two CLIs build them (the JAX CLI's
    loader_kw, one process), train and val, with the alignment target."""
    root, _ = corpus
    cfg = CLI_CFG.replace(batch_size=2)
    args = TAPP.build_argparser().parse_args(["-o", "x"] + _data_argv(root))
    tr, va = TAPP._datasets(args, TConfig(**dataclasses.asdict(cfg)))
    jkw = dict(batch_size=2, shard_index=0, num_shards=1,
               with_alignment=True, frames_per_step=1,
               shard_within_batch=True)
    tkw = dict(batch_size=2, with_alignment=True, frames_per_step=1)
    for split, tds, n in (("train", tr, N_TRAIN), ("val", va, N_VAL)):
        d = os.path.join(root, split)
        jds = JD.BertTacotron2Dataset(JD.load_filepaths(d + ".txt"),
                                      *_dirs(d), load_alignment=True)
        assert len(tds) == n
        jl = JD.BucketedLoader(jds, seed=cfg.seed, **jkw)
        tl = TD.BucketedLoader(tds, **tkw)
        for _ in range(2):
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb)
            for a, b in zip(jb, tb):
                _equal(a, b)


def _new_threads(before):
    """Threads alive now that were not in ``before``."""
    return [t for t in threading.enumerate()
            if t not in before and t.is_alive()]


def test_prefetch_keeps_order_and_stages_in_the_producer():
    main = threading.get_ident()
    before = set(threading.enumerate())
    threads = []

    def stage(x):
        threads.append(threading.get_ident())
        return x * 10

    src = list(range(20))
    got = list(TD.PrefetchLoader(src, depth=3, stage=stage))
    assert got == list(JD.PrefetchLoader(src, depth=3,
                                         stage=lambda x: x * 10))
    assert got == [x * 10 for x in src]
    assert len(threads) == 20 and main not in threads
    assert not _new_threads(before)


def test_prefetch_raises_the_producer_error():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("bad npy")

    it = iter(TD.PrefetchLoader(gen(), depth=2))
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(RuntimeError, match="bad npy"):
        next(it)
    with pytest.raises(ValueError):
        TD.PrefetchLoader([], depth=0)


def test_prefetch_early_close_stops_and_joins_the_producer():
    before = set(threading.enumerate())
    it = iter(TD.PrefetchLoader(iter(range(1000)), depth=1))
    assert next(it) == 0
    t0 = time.perf_counter()
    it.close()  # joins the producer before it returns
    assert time.perf_counter() - t0 < 10.0
    assert not _new_threads(before)


def test_prefetch_reusable_over_epochs(corpus):
    """One PrefetchLoader over a BucketedLoader runs a fresh epoch (a new
    shuffle) per iteration, with the same batches as the JAX class."""
    root, rows = corpus
    tr = os.path.join(root, "train")
    tl = TD.PrefetchLoader(TD.BucketedLoader(
        TD.BertTacotron2Dataset(rows, *_dirs(tr)), batch_size=2), depth=2)
    jl = JD.PrefetchLoader(JD.BucketedLoader(
        JD.BertTacotron2Dataset(rows, *_dirs(tr)), batch_size=2), depth=2)
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert sum(int(b["weight"].sum()) for b in tb) == len(rows)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            _equal(a, b)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------

SSIM_SHAPES = [(2, 1, 16, 24), (3, 1, 80, 37), (2, 1, 5, 7)]  # last < window


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(*shape).astype(np.float32)
    b = (0.7 * a + 0.5 * rng.randn(*shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("shape", SSIM_SHAPES)
def test_ssim_value_and_gradient_match_jax(shape, size_average):
    a, b = _images(shape, seed=sum(shape))
    # the gradient of sum(v * c) with fixed weights c, so that every per
    # sample value counts with its own weight
    c = np.linspace(0.5, 1.5, shape[0]).astype(np.float32)
    red = (lambda v: v) if size_average else (lambda v: (v * c).sum())

    def jfun(x):
        return red(JS.ssim(x, jnp.asarray(b), size_average=size_average))

    jv = JS.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average)
    jg = jax.grad(jfun)(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    tv = TS.ssim(ta, torch.from_numpy(b), size_average=size_average)
    tred = tv if size_average else (tv * torch.from_numpy(c)).sum()
    (tg,) = torch.autograd.grad(tred, ta)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_ssim_mel_loss_matches_jax(weighted):
    out, tgt = _images((3, 80, 29), seed=5)
    w = np.asarray([1.0, 1.0, 0.0], np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    jv, jg = jax.value_and_grad(
        lambda x: JT.ssim_mel_loss(x, jnp.asarray(tgt), jw))(jnp.asarray(out))
    to = torch.from_numpy(out).requires_grad_(True)
    tv = TT.ssim_mel_loss(to, torch.from_numpy(tgt), tw)
    (tg,) = torch.autograd.grad(tv, to)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_ssim_window_is_cached_per_device():
    w1 = TS._window_on(11, 1.5, 1, torch.device("cpu"))
    assert TS._window_on(11, 1.5, 1, torch.device("cpu")) is w1
    np.testing.assert_array_equal(w1[0, 0].numpy(),
                                  JS._gaussian_window(11, 1.5))


# ---------------------------------------------------------------------------
# The CLI on a corpus on disk
# ---------------------------------------------------------------------------

def _hparams(cfg):
    default = dataclasses.asdict(TConfig())
    return "[" + "-".join(f"{k}:{v}" for k, v in
                          dataclasses.asdict(cfg).items()
                          if v != default[k]) + "]"


def _cli_argv(root, out, *extra):
    return ["-o", out, *_data_argv(root), "--batch-size", "2",
            "--hparams", _hparams(CLI_CFG), "--device", "cpu", *extra]


def test_cli_trains_resumes_profiles_and_warm_starts(corpus, tmp_path,
                                                     capsys, monkeypatch):
    """4 iterations with validation every 2 (checkpoints 2 and 4, best),
    TensorBoard logs; a second call resumes at 4 with the checkpoint's
    state bit for bit and learning rate, stops at 6 and traces step 5; a
    warm start keeps a fresh embedding and the rest of checkpoint 2."""
    root, _ = corpus
    out = str(tmp_path / "out")
    logs = tmp_path / "logs"
    res = TAPP.main(_cli_argv(root, out, "-l", str(logs), "--max-iters", "4"))
    log = capsys.readouterr().out
    assert res["start_iteration"] == 0 and res["iterations"] == 4
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 4
    assert np.isfinite(res["val_loss"])
    assert log.count("validation loss") == 2 and "new best val loss" in log
    for name in ("checkpoint_2", "checkpoint_4", "checkpoint_best"):
        for f in ("state.pt", "meta.json"):
            assert os.path.isfile(os.path.join(out, name, f)), (name, f)
    val = {n: json.loads((tmp_path / "out" / n / "meta.json").read_text())
           ["val_loss"] for n in ("checkpoint_2", "checkpoint_4",
                                  "checkpoint_best")}
    assert val["checkpoint_best"] == min(val["checkpoint_2"],
                                         val["checkpoint_4"])
    assert any(p.name.startswith("events.out.tfevents")
               for p in logs.iterdir())

    # the resumed run takes the learning rate its checkpoint recorded
    meta4 = tmp_path / "out" / "checkpoint_4" / "meta.json"
    meta4.write_text(json.dumps({**json.loads(meta4.read_text()),
                                 "learning_rate": 5e-4}))
    loaded = []
    real_load = TCK.load_checkpoint
    monkeypatch.setattr(TCK, "load_checkpoint", lambda *a, **k: (
        loaded.append(real_load(*a, **k)) or loaded[-1]))
    prof = tmp_path / "prof"
    res = TAPP.main(_cli_argv(root, out, "--max-iters", "6",
                              "--profile-dir", str(prof)))
    log = capsys.readouterr().out
    assert f"resumed from {out}/checkpoint_4 at iteration 4" in log
    assert res["start_iteration"] == 4 and res["iterations"] == 6
    assert json.loads((tmp_path / "out" / "checkpoint_6" / "meta.json")
                      .read_text())["learning_rate"] == 5e-4
    want, _ = real_load(os.path.join(out, "checkpoint_4"), "cpu")
    got = loaded[0][0]
    assert got.step == want.step == 4
    for a, b in zip(tree_leaves((got.params, got.bn_state,
                                 list(got.opt_state))),
                    tree_leaves((want.params, want.bn_state,
                                 list(want.opt_state)))):
        assert torch.equal(a, b)
    trace = prof / "trace_steps_5-5.json"
    assert trace.is_file() and f"profiler trace written to {trace}" in log
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert "ProfilerStep#5" in names

    warmed = []
    real_warm = TCK.warm_start
    monkeypatch.setattr(TCK, "warm_start", lambda *a, **k: (
        warmed.append(real_warm(*a, **k)) or warmed[-1]))
    res = TAPP.main(_cli_argv(root, str(tmp_path / "warm"), "-c",
                              os.path.join(out, "checkpoint_2"),
                              "--warm_start", "--max-iters", "1"))
    assert "warm-started from" in capsys.readouterr().out
    assert res["start_iteration"] == 0 and res["iterations"] == 1
    tcfg = TConfig(**dataclasses.asdict(CLI_CFG))
    fresh, _ = TT.create_train_state(
        torch.Generator().manual_seed(tcfg.seed), tcfg, device="cpu")
    ck, _ = real_load(os.path.join(out, "checkpoint_2"), "cpu")
    w = warmed[0]
    assert w.step == 0
    assert torch.equal(w.params["embedding"], fresh.params["embedding"])
    assert not torch.equal(w.params["embedding"], ck.params["embedding"])
    for k in ck.params:
        if k != "embedding":
            for a, b in zip(tree_leaves(w.params[k]),
                            tree_leaves(ck.params[k])):
                assert torch.equal(a, b), k


def test_cli_needs_the_file_lists_or_synthetic(tmp_path):
    with pytest.raises(SystemExit, match="--cls-dir"):
        TAPP.main(["-o", str(tmp_path), "--train-list", "t", "--val-list",
                   "v", "--mel-dir", "m", "--sub-dir", "s", "--device",
                   "cpu"])


def test_cli_needs_cuda_unless_told_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _ = corpus
    argv = _cli_argv(root, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TAPP.main(argv[:argv.index("--device")])


@pytest.mark.parametrize("cap", [None, 3])
def test_logger_writes_scalars_histograms_and_images(tmp_path, capsys, cap):
    """log_training's scalars; log_validation's loss, one histogram per
    param leaf (at most ``max_histograms``) and the five images."""
    from tacotron2_subword_tpu_torch.utils.logging_utils import \
        Tacotron2Logger
    tcfg = TConfig(**dataclasses.asdict(SMALL))
    state, _ = TT.create_train_state(torch.Generator().manual_seed(0), tcfg,
                                     device="cpu")
    logger = Tacotron2Logger(str(tmp_path), max_histograms=cap)
    seen = {"scalar": [], "histogram": [], "image": []}
    for kind in seen:
        real = getattr(logger.writer, f"add_{kind}")
        setattr(logger.writer, f"add_{kind}",
                lambda tag, *a, _r=real, _k=kind, **k: (
                    seen[_k].append(tag), _r(tag, *a, **k)))
    rng = np.random.RandomState(0)
    metrics = {k: torch.tensor(v) for k, v in
               (("total", 1.5), ("mel", 0.5), ("gate", 0.25),
                ("align", 0.0), ("align_bert", 0.0), ("grad_norm", 3.0))}
    logger.log_training(metrics, 1e-3, 0.5, 1)
    assert len(seen["scalar"]) == 8 and "training.loss" in seen["scalar"]
    outputs = {"alignments": torch.rand(2, 13, 11),
               "alignments_bert": torch.rand(2, 13, 7),
               "mel_postnet": torch.randn(2, 5, 13),
               "gate": torch.randn(2, 13)}
    batch = {"mels": torch.from_numpy(rng.randn(2, 5, 13)),
             "gate_target": TT.make_gate_target(torch.tensor([13, 9]), 13)}
    logger.log_validation(0.75, state.params, outputs, batch, 2)
    logger.close()
    n_leaves = len(tree_leaves(state.params))
    assert len(seen["histogram"]) == len(set(seen["histogram"])) \
        == (cap or n_leaves)
    if cap is None:  # slash-joined paths of the nested params
        assert {"embedding", "decoder/gate_layer/w"} <= set(seen["histogram"])
    assert ("histogram cap" in capsys.readouterr().out) == bool(cap)
    assert seen["image"] == ["alignment", "alignment_bert", "mel_predicted",
                             "mel_target", "gate"]
    assert "validation.loss" in seen["scalar"]
    assert any(p.name.startswith("events.out.tfevents")
               for p in tmp_path.iterdir())
