"""The port's after-training apps against the JAX package's on the CPU at
the SMALL size of tests/test_apps_cli.py: the metrics, the GTA mel dump,
the checkpoint sweep, the MCD / soft-DTW evaluation and silence trimming.

Both acoustic checkpoints hold the params of the JAX tests' ``ckpt_dir``
(``create_train_state(PRNGKey(0), SMALL)`` at steps 100 and 200), the port's
written through ``tacotron2_params_from_numpy``; prenet dropout is off
(the port cannot replay JAX's RNG).

Tolerances: the metrics 1e-12 (the same numpy code); GTA mels 1e-5 of
their scale (f32, summed in another order); ledger rows to their 4
rounded decimals (+1e-4 relative) with the same ``failed`` count;
evaluation means 1e-5 relative; trimmed wavs exactly."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read, write

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.apps import best_checkpoint as JBC
from tacotron2_subword_tpu.apps import evaluation as JE
from tacotron2_subword_tpu.apps import gta as JG
from tacotron2_subword_tpu.apps import remove_silence as JRS
from tacotron2_subword_tpu.eval import metrics as JM
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.text import lexicon as JL
from tacotron2_subword_tpu.utils import checkpoint as JCK
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import best_checkpoint as TBC
from tacotron2_subword_tpu_torch.apps import evaluation as TE
from tacotron2_subword_tpu_torch.apps import gta as TG
from tacotron2_subword_tpu_torch.apps import remove_silence as TRS
from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.eval import metrics as TM
from tacotron2_subword_tpu_torch.ops import softdtw as SD
from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
from tacotron2_subword_tpu_torch.utils.import_jax import \
    tacotron2_params_from_numpy
from tests.test_apps_cli import HP as SMALL_HP
from tests.test_model import SMALL
from tests.test_torch_checkpoint import hifigan_state_dict
from tests.test_torch_text import LEXICON, RESOURCE_NAMES

HP = SMALL_HP[:-1] + "-prenet_dropout_always_on:false]"
SR = 22050
# the sweep's vocoder: 256x upsampling of SMALL's 5 mel channels
HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 4],
           "upsample_kernel_sizes": [16, 16, 8], "upsample_initial_channel": 16,
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
           "num_mels": SMALL.n_mel_channels, "sampling_rate": SR}


def _tone(seconds, freq, seed, sr=SR, noise=0.02):
    """Harmonics of ``freq`` plus seeded noise, in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    w = sum(0.3 / k * np.sin(2 * np.pi * k * freq * t) for k in (1, 2, 3))
    return (w + noise * rng.randn(len(t))).astype(np.float32)


def _write(path, wav, sr=SR):
    write(str(path), sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


# ---------------------------------------------------------------------------
# eval/metrics: the same numpy code
# ---------------------------------------------------------------------------

def _metric_cases():
    a = _tone(0.25, 180.0, 0)
    b = _tone(0.2, 220.0, 1)
    b16 = JM.resample_to(b, SR, 16000)
    rng = np.random.RandomState(2)
    x, y = rng.randn(23, 4), rng.randn(31, 4)
    D = ((x[:, None] - y[None]) ** 2).sum(-1).astype(np.float32)
    quiet = np.concatenate([np.zeros(700), a[:900], 1e-4 * a[:500]])
    return {
        "estimate_f0": lambda M: M.estimate_f0(b16, 16000),
        "mel_cepstrum": lambda M: M.mel_cepstrum(b16, 16000),
        "dtw_path": lambda M: M.dtw_path(x, y),
        "softdtw_np": lambda M: M.softdtw_np(D, gamma=0.7),
        "resample_to": lambda M: M.resample_to(a, SR, 16000),
        "mcd_between_wavs": lambda M: M.mcd_between_wavs(a, b, fs=SR),
        "trim_silence": lambda M: M.trim_silence(quiet, fs=SR),
    }


@pytest.mark.parametrize("name", list(_metric_cases()))
def test_metrics_match_jax(name):
    fn = _metric_cases()[name]
    ref, out = fn(JM), fn(TM)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape and o.size > 0
        np.testing.assert_allclose(o, r, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the apps: shared assets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Resources, both packages' checkpoints 100 and 200 of one set of
    params, a reference-format HiFi-GAN file, a 4-row training corpus
    (wavs, durations, subword IDs, [CLS]) and a 2-line script with its
    ground-truth wavs."""
    d = tmp_path_factory.mktemp("apps")
    res = d / "res"
    res.mkdir()
    for name in RESOURCE_NAMES + ("small.lex",):
        (res / name).write_text(LEXICON, encoding="utf-8")
    p2i, _ = JL.build_phone_id_map([JL.load_lexicon(str(res / "small.lex"))],
                                   ["_", "-", "~", "+", " ", ",", ".", "!",
                                    "?"])
    JL.dump_phone_id_file(p2i, str(res / "phone_id_list.txt"))

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        state, _ = JT.create_train_state(jax.random.PRNGKey(0), SMALL)
    tcfg = TConfig(**dataclasses.asdict(SMALL))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, bn = tacotron2_params_from_numpy(np_tree(state.params),
                                             np_tree(state.bn_state), tcfg,
                                             device="cpu")
    opt = TT.make_optimizer(tcfg).init(params)
    for step in (100, 200):
        JCK.save_checkpoint(state._replace(step=jnp.asarray(step, jnp.int32)),
                            str(d / "jax_ck"))
        TCK.save_checkpoint(TT.TrainState(step, params, bn, opt),
                            str(d / "port_ck"))

    (d / "config.json").write_text(json.dumps(HIFIGAN))
    h = JHG.HifiganConfig.from_json(str(d / "config.json"))
    gen = JHG.init_generator(jax.random.PRNGKey(2), h)
    unit = lambda t: ({k: (jnp.ones_like(v) if k == "g" else unit(v))
                       for k, v in t.items()} if isinstance(t, dict)
                      else [unit(v) for v in t] if isinstance(t, list) else t)
    gen = unit(gen)                      # rows of norm 1 keep the scale
    gen["conv_post"]["g"] = gen["conv_post"]["g"] * 0.1
    torch.save({"generator": hifigan_state_dict(gen)}, str(d / "g_00000100"))

    rng = np.random.RandomState(0)
    for sub in ("wav", "durs", "subs", "cls", "gt"):
        (d / sub).mkdir()
    rows = []
    for i, n in enumerate((800, 1000, 600, 1024)):   # samples: 4, 4, 3, 5 frames
        _write(d / "wav" / f"utt{i}.wav", _tone(n / SR, 150 + 40 * i, i))
        n_ph = 3 + i
        np.save(d / "durs" / f"{i}.npy", np.stack(
            [rng.randint(1, SMALL.n_symbols, n_ph), rng.randint(1, 3, n_ph)],
            axis=1).astype(np.int32))
        np.save(d / "subs" / f"{i}.npy",
                rng.randint(0, SMALL.sub_n_symbols, 2 + i).astype(np.int32))
        np.save(d / "cls" / f"{i}.npy",
                rng.randn(SMALL.bert_embedding_dim).astype(np.float32))
        rows.append(f"{d / 'wav' / f'utt{i}.wav'}|{d / 'durs' / f'{i}.npy'}")
    (d / "train.txt").write_text("\n".join(rows) + "\n")
    (d / "val.txt").write_text("0|ba me\n1|em nam an\n", encoding="utf-8")
    _write(d / "gt" / "0.wav", _tone(0.2, 200.0, 10))
    _write(d / "gt" / "1.wav", _tone(0.15, 260.0, 11))
    return d


# ---------------------------------------------------------------------------
# GTA
# ---------------------------------------------------------------------------

def _gta_argv(d, ck, out, *extra):
    return [str(d / "train.txt"), str(d / ck / "checkpoint_200"),
            str(d / out), "--sub-dir", str(d / "subs"), "--cls-dir",
            str(d / "cls"), "--batch-size", "2", "--hparams", HP, *extra]


def test_gta_matches_jax(assets):
    """Both CLIs from the wavs, two batches of 2 after the stable sort by
    mel length: the same files, mels of the targets' frame counts."""
    d = assets
    n_jax = JG.gta_synthesis(JG.build_argparser().parse_args(
        _gta_argv(d, "jax_ck", "gta_jax")))
    n_port = TG.main(_gta_argv(d, "port_ck", "gta_port", "--device", "cpu"))
    assert n_jax == n_port == 4
    for i, n in enumerate((800, 1000, 600, 1024)):
        j = np.load(d / "gta_jax" / f"utt{i}.npy")
        t = np.load(d / "gta_port" / f"utt{i}.npy")
        assert t.shape == j.shape == (SMALL.n_mel_channels, n // 256 + 1)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_gta_mel_dir_resume_and_overwrite(assets):
    """--mel-dir reads row i's mel as ljspeech-mel-{i+1:05d}.npy: with the
    wavs' own mels there the dump is the from-wav one; a second run skips
    every row and --overwrite redoes them."""
    d = assets
    (d / "mels").mkdir(exist_ok=True)
    ref_out = d / "gta_ref"
    assert TG.main(_gta_argv(d, "port_ck", "gta_ref", "--device", "cpu")) == 4
    from tacotron2_subword_tpu_torch.ops import stft as S
    for i in range(4):
        _, w = read(str(d / "wav" / f"utt{i}.wav"))
        mel = S.mel_spectrogram(torch.from_numpy(
            w.astype(np.float32)[None] / 32768.0), n_mel_channels=5)[0]
        np.save(d / "mels" / f"ljspeech-mel-{i + 1:05d}.npy", mel.numpy())
    argv = _gta_argv(d, "port_ck", "gta_md", "--device", "cpu", "--mel-dir",
                     str(d / "mels"))
    assert TG.main(argv) == 4
    for i in range(4):
        np.testing.assert_array_equal(np.load(d / "gta_md" / f"utt{i}.npy"),
                                      np.load(ref_out / f"utt{i}.npy"))
    assert TG.main(argv) == 0
    assert TG.main(argv + ["--overwrite"]) == 4


# ---------------------------------------------------------------------------
# the checkpoint sweep
# ---------------------------------------------------------------------------

def _sweep_argv(d, ck, csv):
    return ["--checkpoint-dir", str(d / ck), "--script", str(d / "val.txt"),
            "--gt-dir", str(d / "gt"), "--out-csv", str(d / csv),
            "--g2p-lexicon", str(d / "res" / "small.lex"),
            "--hifigan-checkpoint", str(d / "g_00000100"),
            "--hifigan-config", str(d / "config.json"),
            "--max-decoder-steps", "16", "--gate-threshold", "0.425",
            "--hparams", HP]


def test_best_checkpoint_matches_jax_and_resumes(assets, monkeypatch,
                                                 capsys):
    """Both sweeps over checkpoints 100 and 200 with HiFi-GAN, the gate at
    0.425: these weights' gate probabilities rise through 0.41-0.43, and at
    0.425 both lines stop, apart (4 and 6 frames; the nearest crossing
    6e-4 from the threshold), in both packages, so the rows hold MCD and
    soft-DTW of real audio (MCD needs voiced frames, which random weights
    do not make; ``mcd_between_wavs`` is held to JAX's above).  A second
    port sweep skips every row."""
    d = assets
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(d / "res"))
    j_rows = JBC.sweep(JBC.build_argparser().parse_args(
        _sweep_argv(d, "jax_ck", "jax.csv")))
    lens = []
    infer = TBC.M.infer
    monkeypatch.setattr(TBC.M, "infer", lambda *a, **k: (
        lens.append(infer(*a, **k)) or lens[-1]))
    t_rows = TBC.main(_sweep_argv(d, "port_ck", "port.csv")
                      + ["--device", "cpu"])
    assert [r["checkpoint"] for r in t_rows] == ["checkpoint_100",
                                                 "checkpoint_200"]
    assert set(t_rows[0]["seconds"]) == {"decode", "vocode", "metrics"}
    assert lens[0]["mel_lengths"].tolist() == [4, 6]
    j_led = JBC.read_ledger(str(d / "jax.csv"))
    t_led = TBC.read_ledger(str(d / "port.csv"))
    assert len(j_rows) == 2 and t_led.keys() == j_led.keys()
    for name, jr in j_led.items():
        tr = t_led[name]
        assert list(tr) == list(jr)
        assert tr["failed"] == jr["failed"] == "0"
        assert tr["n_utts"] == jr["n_utts"] == "2"
        # random weights make unvoiced audio: no MCD in either ledger
        assert tr["mcd_mean"] == jr["mcd_mean"] == ""
        for k in ("softdtw_mean", "silence_mean_s"):
            np.testing.assert_allclose(float(tr[k]), float(jr[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    capsys.readouterr()
    assert TBC.main(_sweep_argv(d, "port_ck", "port.csv")
                    + ["--device", "cpu"]) == []
    assert capsys.readouterr().out.count("already in ledger") == 2


# ---------------------------------------------------------------------------
# the CLIs with the other attention variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli, variant", [
    ("inference", "DynamicConvolutionAttention"),
    ("gta", "LocationSensitiveAttention"),
    ("best_checkpoint", "ForwardAttentionV2")])
def test_clis_run_other_attention_variants(assets, tmp_path, monkeypatch,
                                           cli, variant):
    """Each CLI with ``--hparams ...-attention:<Variant>`` on a port
    checkpoint of that variant (``save_checkpoint`` of a seeded SMALL
    state); finite outputs of the expected count."""
    from tacotron2_subword_tpu_torch.apps import inference as TI
    d = assets
    hp = HP[:-1] + f"-attention:{variant}]"
    tcfg = TConfig(**dataclasses.asdict(SMALL.replace(attention=variant)))
    state, _ = TT.create_train_state(torch.Generator().manual_seed(0), tcfg,
                                     device="cpu")
    ck = str(tmp_path / "ck")
    path = TCK.save_checkpoint(state._replace(step=100), ck)
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(d / "res"))
    if cli == "inference":
        n = TI.main(["--script", str(d / "val.txt"), "--checkpoint-dir", ck,
                     "--out-dir", str(tmp_path / "out"), "--g2p-lexicon",
                     str(d / "res" / "small.lex"), "--max-decoder-steps",
                     "8", "--hparams", hp, "--device", "cpu"])
        wavs = sorted((tmp_path / "out").rglob("*.wav"))
        assert n == 2 and len(wavs) == 2
        assert all(np.isfinite(read(str(w))[1]).all() for w in wavs)
    elif cli == "gta":
        n = TG.main([str(d / "train.txt"), path, str(tmp_path / "gta"),
                     "--sub-dir", str(d / "subs"), "--cls-dir",
                     str(d / "cls"), "--batch-size", "2", "--hparams", hp,
                     "--device", "cpu"])
        mels = [np.load(tmp_path / "gta" / f"utt{i}.npy") for i in range(4)]
        assert n == 4 and all(np.isfinite(m).all() for m in mels)
    else:
        argv = _sweep_argv(d, "port_ck", "x.csv")
        argv[argv.index("--checkpoint-dir") + 1] = ck
        argv[argv.index("--out-csv") + 1] = str(tmp_path / "v.csv")
        argv[argv.index("--hparams") + 1] = hp
        rows = TBC.main(argv + ["--device", "cpu"])
        assert [r["checkpoint"] for r in rows] == ["checkpoint_100"]
        row = TBC.read_ledger(str(tmp_path / "v.csv"))["checkpoint_100"]
        assert row["failed"] == "0" and row["n_utts"] == "2"


# ---------------------------------------------------------------------------
# evaluation and silence trimming
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A benchmark dir of 2 synthesized wavs (one with a silent head and
    tail), their ground truths, and a wav with no ground truth."""
    d = tmp_path_factory.mktemp("bench")
    for sub in ("bench", "gt"):
        (d / sub).mkdir()
    pad = np.zeros(700, np.float32)
    _write(d / "bench" / "a.wav",
           np.concatenate([pad, _tone(0.25, 200.0, 0), pad]))
    _write(d / "bench" / "b.wav", _tone(0.3, 240.0, 1))
    _write(d / "bench" / "c.wav", _tone(0.1, 240.0, 2))
    _write(d / "gt" / "a.wav", _tone(0.3, 210.0, 3))
    _write(d / "gt" / "b.wav", _tone(0.25, 250.0, 4))
    return d


@pytest.mark.parametrize("metric", ["mcd", "softdtw"])
def test_evaluation_matches_jax(bench, metric, monkeypatch):
    """Each metric's mean over the 2 pairs against the JAX CLI's; the
    soft-DTW arm goes through softdtw_value (K3's entry point) once per
    file."""
    import argparse
    d = bench
    ref = getattr(JE, f"eval_{metric}")(argparse.Namespace(
        benchmark=str(d / "bench"), gt_dir=str(d / "gt")))
    calls = []
    value = SD.softdtw_value
    monkeypatch.setattr(SD, "softdtw_value", lambda D, *a, **k: (
        calls.append(tuple(D.shape)) or value(D, *a, **k)))
    out = TE.main([metric, "--benchmark", str(d / "bench"), "--gt-dir",
                   str(d / "gt"), "--device", "cpu"])
    assert np.isfinite(out)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert len(calls) == (2 if metric == "softdtw" else 0)
    assert all(B == 1 for B, _, _ in calls)


def test_remove_silence_matches_jax(bench, tmp_path, monkeypatch):
    """The same int16 files as the JAX CLI's, the silent pad trimmed."""
    import sys
    d = bench
    monkeypatch.setattr(sys, "argv", ["prog", "--in-dir", str(d / "bench"),
                                      "--out-dir", str(tmp_path / "jax")])
    JRS.main()
    assert TRS.main(["--in-dir", str(d / "bench"), "--out-dir",
                     str(tmp_path / "port")]) == 3
    for name in ("a.wav", "b.wav", "c.wav"):
        sr_j, j = read(str(tmp_path / "jax" / name))
        sr_t, t = read(str(tmp_path / "port" / name))
        assert sr_t == sr_j == SR and t.dtype == np.int16
        np.testing.assert_array_equal(t, j)
    _, a = read(str(d / "bench" / "a.wav"))
    _, ta = read(str(tmp_path / "port" / "a.wav"))
    assert 0 < len(ta) <= len(a) - 2 * 600


def test_softdtw_distance_takes_the_kernel_entry_points(monkeypatch):
    """softdtw_distance goes through softdtw_value (K3) without a gradient
    and softdtw_grad (K2) with one; on CPU tensors both take their plain
    versions."""
    calls = []
    for name in ("softdtw_value", "softdtw_grad"):
        fn = getattr(SD, name)
        monkeypatch.setattr(SD, name, lambda D, *a, _n=name, _f=fn, **k: (
            calls.append(_n) or _f(D, *a, **k)))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 6, 3).astype(np.float32))
    y = torch.from_numpy(rng.randn(1, 8, 3).astype(np.float32))
    v = SD.softdtw_distance(x, y)
    xg = x.clone().requires_grad_(True)
    vg = SD.softdtw_distance(xg, y)
    (g,) = torch.autograd.grad(vg.sum(), xg)
    assert calls == ["softdtw_value", "softdtw_grad"]
    assert torch.equal(v, vg.detach()) and torch.isfinite(g).all()


@pytest.mark.parametrize("cli", ["gta", "train_hifigan", "best_checkpoint",
                                 "evaluation"])
def test_clis_need_cuda_unless_told_cpu(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"gta": lambda: TG.main(["l.txt", "ck", str(tmp_path)]),
            "train_hifigan": lambda: TTH.main(["-o", str(tmp_path),
                                               "--synthetic", "1"]),
            "best_checkpoint": lambda: TBC.main([
                "--checkpoint-dir", "ck", "--script", "s", "--gt-dir", "g"]),
            "evaluation": lambda: TE.main(["softdtw", "--gt-dir", "g"])}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        argv[cli]()
