"""The port's measurement and demo tools on the CPU, at small widths, where
the kernels take their plain versions.

- ``serving_latency``: the front end's phone and subword IDs equal the JAX
  tool's ``front_end`` (spied in its run) for the default text on one
  small lexicon; the result's keys equal the JAX tool's; the device
  columns are null (not measured) and one decoder-step count is returned
  per acoustic call.
- ``kernel_evidence``: K2's and K3's plain reference (the port's scan)
  against the JAX package's scan value and gradient (1e-5 relative, the
  tool's tolerance), each comparison row at a small shape, and the tool's
  main at small shapes.
- ``infer_wav_demo``: a gate-stopped decode (a decoder whose gate fires
  near frame 5, ``chip_smoke.timer_gate``) written as a wav.
- ``gta_vocoder_smoke``: its four steps (Griffin-Lim wavs, the GTA CLI,
  the HiFi-GAN CLI, held-out mel-L1 and MCD) at a narrow generator.  It
  trains the HiFi-GAN CLI on the CPU, hence ``slow``.
"""

import contextlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_subword_tpu.models import tacotron2 as JM
from tacotron2_subword_tpu.ops import softdtw as JSD
from tacotron2_subword_tpu_torch import train_lib as PT
from tacotron2_subword_tpu_torch.config import create_config
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.ops import softdtw as SD
from tacotron2_subword_tpu_torch.text import Text2Seq
from tacotron2_subword_tpu_torch.tools import gta_vocoder_smoke as GVS
from tacotron2_subword_tpu_torch.tools import infer_wav_demo as IWD
from tacotron2_subword_tpu_torch.tools import kernel_evidence as KE
from tacotron2_subword_tpu_torch.tools import serving_latency as SL
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tests.test_apps_cli import HP as SMALL_HP
from tests.test_torch_text import LEXICON, RESOURCE_NAMES
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# the SMALL architecture with 80 mels (Griffin-Lim's filterbank)
HP = SMALL_HP.replace("n_mel_channels:5", "n_mel_channels:80")


def _jax_tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def lexicon(tmp_path, monkeypatch):
    """A resources dir holding the tiny lexicon under the reference names
    (both front ends read it there); the Vietnamese one's path."""
    res = tmp_path / "res"
    res.mkdir()
    for name in RESOURCE_NAMES:
        (res / name).write_text(LEXICON, encoding="utf-8")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(res))
    return str(res / RESOURCE_NAMES[0])


def _port_checkpoint(root: Path, hp: str, stop_at=None) -> str:
    """A seeded port checkpoint at the config of ``hp``; with ``stop_at``
    its gate fires near that frame at threshold 0.5."""
    cfg = create_config(hp)
    state, _ = PT.create_train_state(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    if stop_at:
        chip_smoke.timer_gate(state.params["decoder"], stop_at)
    return CK.save_checkpoint(state, str(root), name="checkpoint_1")


def test_serving_latency_matches_jax_tool(tmp_path, lexicon, monkeypatch,
                                          capsys):
    import tacotron2_subword_tpu.apps.inference as JI
    import tacotron2_subword_tpu.text.bert as JB
    import tacotron2_subword_tpu.utils.platform as JP
    import tacotron2_subword_tpu.utils.xprof as JX
    from tacotron2_subword_tpu.text import Text2Seq as JText2Seq

    argv = ["--checkpoint", "ck", "--hparams", HP, "--g2p-lexicon", lexicon,
            "--repeats", "1", "--max-decoder-steps", "8"]
    # the JAX tool on the CPU: random SMALL params for the checkpoint, no
    # trace files, no compilation cache; its front end spied
    seen = {}
    monkeypatch.setattr(JI, "load_acoustic_model", lambda ck, cfg:
                        JM.init_tacotron2(jax.random.PRNGKey(0), cfg))
    monkeypatch.setattr(JP, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(JX, "device_module_ms", lambda d: 1.0)
    monkeypatch.setattr(jax.profiler, "trace",
                        lambda d: contextlib.nullcontext())
    g2s, hsi = JText2Seq.grapheme_to_sequence, JB.hashed_subword_ids
    monkeypatch.setattr(JText2Seq, "grapheme_to_sequence", lambda self, t:
                        seen.setdefault("seq", g2s(self, t)))
    monkeypatch.setattr(JB, "hashed_subword_ids", lambda t, n:
                        seen.setdefault("sub", hsi(t, n)))
    monkeypatch.setattr(sys, "argv", ["serving_latency.py", *argv])
    capsys.readouterr()
    _jax_tool("serving_latency").main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    ck = _port_checkpoint(tmp_path / "run", HP)
    argv[1] = ck
    result, steps = SL.main(argv + ["--device", "cpu",
                                    "--out-md", str(tmp_path / "l.md")])
    assert set(result) == set(ref)
    seq, sub = SL.front_end(Text2Seq(lexicon), SL.DEFAULT_TEXT,
                            create_config(HP).sub_n_symbols)
    assert np.array_equal(seq, np.asarray(seen["seq"]))
    assert np.array_equal(sub, np.asarray(seen["sub"]))
    assert result["phones"] == ref["phones"] == len(seq)
    assert result["acoustic_device_ms"] is None
    audio_s = result["frames"] * 256 / 22050
    assert result["rtf_device"] is None and result["rtf_wall"] == \
        pytest.approx(audio_s / (result["e2e_wall_ms"] / 1e3), abs=6e-3)
    assert result["vocoder"] == ref["vocoder"] == "griffin_lim"
    # first call, 1 timed, 1 end-to-end x 5; no trace off the card
    assert len(steps) == 1 + 1 + 5 and all(0 < s <= 8 for s in steps)
    assert "not measured" in (tmp_path / "l.md").read_text()


def test_kernel_evidence_reference_matches_jax_scan():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 2), dtype=np.float32)
    y = rng.standard_normal((3, 7, 2), dtype=np.float32)
    D = np.array(JSD.euclidean_dist_matrix(jnp.asarray(x), jnp.asarray(y)))
    v_j, g_j = jax.jit(jax.value_and_grad(
        lambda d: jnp.sum(JSD.softdtw(d, 1.0, 0.0))))(jnp.asarray(D))
    v_p, E_p = SD.softdtw_grad_plain(torch.from_numpy(D), 1.0, 0.0)
    assert abs(float(v_p.sum()) - float(v_j)) <= 1e-5 * abs(float(v_j))
    assert float((E_p - torch.from_numpy(np.array(g_j))).abs().max()) \
        <= 1e-5 * float(np.abs(np.asarray(g_j)).max())


@pytest.mark.parametrize("kind", ["softdtw", "int8", "mel_f32", "mel_bf16"])
def test_kernel_evidence_rows_on_cpu(kind):
    cpu, rng = torch.device("cpu"), np.random.default_rng(1)
    if kind == "softdtw":
        r = KE.softdtw_row(4, 9, 7, cpu, rng, 2)
        assert r["ok"] and r["k2_ms"] is None and r["rel_dgrad_k2"] == 0.0
    elif kind == "int8":
        r = KE.int8_row(2, 3, 64, 32, cpu, rng, 2)
        assert r["ok"] and r["k1_ms"] is None and r["rel_err"] == 0.0
    else:
        dtype = torch.float32 if kind == "mel_f32" else torch.bfloat16
        r = KE.mel_row(2, 4096, dtype, cpu, rng, 2)
        assert r["finite"] and r["ms"] is None and r["frames"] == 17
        assert r["bound_ms"] > 0 and r["bytes_hi"] > r["bytes_min"]


def test_kernel_evidence_main_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(KE, "SDTW_SHAPES", ((2, 9, 7), (3, 16, 16)))
    monkeypatch.setattr(KE, "K1_SHAPES", ((2, 3, 64, 32),))
    monkeypatch.setattr(KE, "MEL_SHAPE", (2, 4096))
    res = KE.main(["--device", "cpu", "--repeats", "1",
                   "--out", str(tmp_path / "e.md")])
    out = capsys.readouterr().out
    assert res["ok"] and out.count("OK") == 3 and "MISMATCH" not in out
    assert len(res["mel"]) == 2 and "not measured" in out
    assert (tmp_path / "e.md").read_text().startswith("# Hand-written")


def _corpus(root: Path, n: int, cfg, frames=(40, 48, 36, 44), seed=0):
    """A val split in the synthetic corpus's layout: durations (phone IDs
    in column 0), subword IDs, [CLS] vectors and 80-band log-mels."""
    rng = np.random.RandomState(seed)
    base = root / "val"
    for d in ("durations", "sub", "cls", "mels"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        k = 6 + i
        dur = np.stack([rng.randint(1, cfg.n_symbols, k),
                        rng.randint(2, 9, k)], 1).astype(np.int32)
        np.save(base / "durations" / f"{i}.npy", dur)
        np.save(base / "sub" / f"{i}.npy",
                rng.randint(3, cfg.sub_n_symbols, 4).astype(np.int32))
        np.save(base / "cls" / f"{i}.npy",
                rng.randn(cfg.bert_embedding_dim).astype(np.float32))
        mel = (rng.randn(80, frames[i % len(frames)]) - 5.0).astype(
            np.float32)
        np.save(base / "mels" / f"ljspeech-mel-{i + 1:05d}.npy", mel)
    return root


def test_infer_wav_demo_gate_stops(tmp_path, capsys):
    from scipy.io.wavfile import read
    data = _corpus(tmp_path / "data", 1, create_config(HP))
    ck = _port_checkpoint(tmp_path / "run", HP, stop_at=5)
    out = tmp_path / "wav" / "demo.wav"
    res = IWD.main(["--data", str(data), "--checkpoint", ck, "--out",
                    str(out), "--max-steps", "16", "--gate-threshold",
                    "0.5", "--hparams", HP, "--device", "cpu"])
    assert res["gate_stopped"] and 3 <= res["frames"] <= 8
    assert "gate_stopped=True" in capsys.readouterr().out
    sr, wav = read(out)
    assert sr == 22050 and len(wav) == res["samples"] > 0
    assert np.abs(wav).max() == int(0.8 * 32767)
    # the gate that never fires fails the demo, as the JAX tool's assert
    with pytest.raises(AssertionError, match="gate did not stop"):
        IWD.main(["--data", str(data), "--checkpoint", ck, "--out",
                  str(out), "--max-steps", "16", "--gate-threshold", "1.1",
                  "--hparams", HP, "--device", "cpu"])


@pytest.mark.slow
def test_gta_vocoder_smoke_on_cpu(tmp_path):
    narrow = {"resblock": "1", "upsample_rates": [8, 8, 4],
              "upsample_kernel_sizes": [16, 16, 8],
              "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]]}
    h_path = tmp_path / "h.json"
    h_path.write_text(json.dumps(narrow))
    cfg = create_config(HP)
    data = _corpus(tmp_path / "data", 4, cfg)
    ck = _port_checkpoint(tmp_path / "run", HP)
    res = GVS.main(["--data", str(data), "--checkpoint", ck, "--work",
                    str(tmp_path / "work"), "--n", "4", "--iters", "2",
                    "--eval-n", "1", "--hparams", HP, "--hifigan-config",
                    str(h_path), "--report", str(tmp_path / "report"),
                    "--device", "cpu"])
    assert res["ft_iters"] == 2 and res["samples"] == 44 * 256
    assert all(np.isfinite(res[k]) for k in (
        "mel_l1_init", "mel_l1_ft", "mel_l1_init_vs_wav", "mel_l1_ft_vs_wav"))
    assert res["mel_l1_ft"] != res["mel_l1_init"]
    md = (tmp_path / "report" / "gta_hifigan_finetune.md").read_text()
    assert "| fine-tuned (2 iters) |" in md
    assert (tmp_path / "report" / "vocoded_gta_hifigan.wav").is_file()
    h = HG.HifiganConfig.from_json(str(h_path))
    assert len(h.upsample_rates) == 3
