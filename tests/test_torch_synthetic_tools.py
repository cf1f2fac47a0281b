"""The port's synthetic-corpus tools against the root ``tools/`` scripts of
the JAX package, on the CPU.

- ``make_synthetic_dataset``: the same flags and seed give byte-equal file
  trees (mels, IDs, [CLS], durations, wavs, the row lists and, with
  ``--from-text``, the sentences), in phone mode and in ``--from-text``
  mode with a tiny lexicon and a trained tokenizer JSON.  Tolerance: none,
  the bytes are equal.
- ``train_tokenizer``: a byte-equal JSON on a tiny corpus (whose words
  make the library's trainer deterministic: see TOKENIZER_WORDS).
- ``gan_batch_scaling.measure`` at a narrow generator, B 1 and 2: every
  row key, a finite loss, each B's steps ``gan_step`` chained from the
  seeded state on that B's draw (the row's loss the last step's), and the
  first step bit-equal to an independent ``gan_step`` with
  ``make_optimizer(2e-4, lr_decay=1.0)``.  Tolerance: none.
"""

import filecmp
import functools
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.tools import gan_batch_scaling as TGB
from tacotron2_subword_tpu_torch.tools import make_synthetic_dataset as TMS
from tacotron2_subword_tpu_torch.tools import train_tokenizer as TTK
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_text import LEXICON, RESOURCE_NAMES
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# a 256x generator narrow enough for the CPU (the discriminators have no
# size knob)
NARROW = HG.HifiganConfig(upsample_rates=(8, 8, 4),
                          upsample_kernel_sizes=(16, 16, 8),
                          upsample_initial_channel=16,
                          resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),))
SEGMENT = 512


def _jax_tool(name):
    """A root ``tools/`` script of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    mod.main()


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture
def resources(tmp_path, monkeypatch):
    """A resources dir holding the tiny lexicon under the reference names
    (no phone-ID list: both front ends build the map from the lexicon)."""
    res = tmp_path / "res"
    res.mkdir()
    for name in RESOURCE_NAMES:
        (res / name).write_text(LEXICON, encoding="utf-8")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(res))
    return res / RESOURCE_NAMES[0]


@pytest.mark.parametrize("mode", ["phones", "from_text"])
def test_make_synthetic_dataset_tree_matches_jax(mode, tmp_path, resources,
                                                 monkeypatch):
    """Both tools write the same files with the same bytes.  Each runs in
    its own directory with the same relative --out, so the row lists'
    paths are equal too."""
    argv = ["--out", "synth", "--n-train", "3", "--n-val", "1",
            "--seed", "2"]
    if mode == "from_text":
        pytest.importorskip("tokenizers")
        tok = TTK.train_wordpiece(
            [LEXICON.replace("\n", " ")] * 4 + ["ba em", "nam anh me"],
            vocab_size=64)
        tok.save(str(tmp_path / "vibert.json"))
        argv += ["--from-text", "--lexicon", str(resources),
                 "--tokenizer-json", str(tmp_path / "vibert.json")]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            _run_jax_main(_jax_tool("make_synthetic_dataset"), argv,
                          monkeypatch)
        else:
            TMS.main(argv)
    a, b = tmp_path / "jax" / "synth", tmp_path / "port" / "synth"
    files = _tree(a)
    assert files == _tree(b)
    n_expected = 4 * 5 + 2 + (2 if mode == "from_text" else 0)
    assert len(files) == n_expected
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f
    # the rows point at the files written
    rows = (b / "train.txt").read_text().split()
    assert rows[0] == "synth/train/wav/0.wav|synth/train/durations/0.npy"
    mel = np.load(b / "val" / "mels" / "ljspeech-mel-00001.npy")
    dur = np.load(b / "val" / "durations" / "0.npy")
    assert mel.shape == (80, int(dur[:, 1].sum())) and np.isfinite(mel).all()


# tokenizers' WordPiece trainer numbers the "##x" continuation tokens in
# the order it meets them while walking a hash map of the words, so on most
# corpora two runs of the same tool write different JSONs.  Here every
# word's continuation letters are a prefix of one order (a, n, h): any walk
# meets them in that order, and the output is fixed.
TOKENIZER_WORDS = ("ba", "ban", "banh", "ma", "man", "manh", "na", "nan",
                   "nanh", "ta", "tan", "tanh")


def test_train_tokenizer_json_matches_jax(tmp_path, monkeypatch):
    """The same sentences (a text file of id|sentence rows plus seeded
    lexicon sentences) give a byte-equal tokenizer JSON; the JAX tool run
    twice shows that the output is fixed for this corpus."""
    pytest.importorskip("tokenizers")
    lex = tmp_path / "words.lex"
    lex.write_text("".join(f"{w} b a_1\n" for w in TOKENIZER_WORDS),
                   encoding="utf-8")
    texts = tmp_path / "train_text.txt"
    texts.write_text("0|ba man tanh\n1|nan banh ma\n2|Tan NA ban\n",
                     encoding="utf-8")
    common = ["--vocab-size", "48", "--texts", str(texts),
              "--from-lexicon", "40", "--lexicon", str(lex), "--seed", "1"]
    jax_tool = _jax_tool("train_tokenizer")
    outs = [tmp_path / n for n in ("jax.json", "jax2.json", "port.json")]
    for out in outs[:2]:
        _run_jax_main(jax_tool, common + ["--out", str(out)], monkeypatch)
    assert TTK.main(common + ["--out", str(outs[2])]) == str(outs[2])
    assert outs[0].read_bytes() == outs[1].read_bytes()
    assert outs[0].read_bytes() == outs[2].read_bytes()
    assert (TTK.lexicon_sentences(str(lex), 5, seed=1)
            == jax_tool.lexicon_sentences(str(lex), 5, seed=1))
    assert TTK.read_text_file(str(texts)) == jax_tool.read_text_file(
        str(texts))


def test_train_tokenizer_names_the_missing_package(monkeypatch):
    """Without tokenizers the tool raises, naming the package; it does not
    fall back to anything."""
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="'tokenizers'"):
        TTK.train_wordpiece(["ba me"], 8)


@pytest.fixture
def two_threads():
    """The discriminators' 70M params dominate a CPU step; with every core
    per test worker the suite's workers starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gan_batch_scaling_measure_is_gan_step(monkeypatch, two_threads):
    """measure at B 1 and 2 (no warm-up, 1 timed step; 512-sample
    segments, as the discriminators have no size knob): every key of the
    JAX tool's rows plus peak_gb, a finite loss; each B's two steps are
    gan_step chained from the same seeded state on that B's draw of the
    segment stream, the row's loss is the last step's d + g, and the first
    step equals gan_step with make_optimizer(2e-4, lr_decay=1.0) on a
    fresh init_state."""
    segments = functools.partial(TTH.SyntheticSegments, segment=SEGMENT)
    monkeypatch.setattr(TGB, "SyntheticSegments", segments)
    calls = []

    def spy(state, mel, audio, *rest):
        new, m = TTH.gan_step(state, mel, audio, *rest)
        calls.append((state, mel, audio, new, m))
        return new, m
    monkeypatch.setattr(TGB, "gan_step", spy)
    rows = TGB.measure([1, 2], iters=1, warmup=0, device="cpu", h=NARROW)
    assert [r["B"] for r in rows] == [1, 2] and len(calls) == 4
    for r in rows:
        assert set(r) == {"B", "s_per_it", "segments_per_s", "audio_s_per_s",
                          "compile_s", "loss", "peak_gb"}
        assert math.isfinite(r["loss"]) and r["s_per_it"] > 0
        assert r["peak_gb"] is None  # CPU
        assert r["segments_per_s"] == pytest.approx(r["B"] / r["s_per_it"])
    init, _ = TGB.init_state(NARROW, "cpu")
    ds = segments(32)
    for k, r in enumerate(rows):
        mel, audio = (torch.from_numpy(a) for a in ds.sample_batch(r["B"]))
        first, second = calls[2 * k:2 * k + 2]
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(first[0]), tree_leaves(init)))
        assert second[0] is first[3]
        for c in (first, second):
            assert torch.equal(c[1], mel) and torch.equal(c[2], audio)
        m = second[4]
        assert r["loss"] == float(m["d_loss"] + m["g_loss"])
    mel, audio, new, m = calls[0][1:]
    tx = TTH.make_optimizer(2e-4, lr_decay=1.0)
    want, wm = TTH.gan_step(init, mel, audio, NARROW, tx, tx)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                   tree_leaves(want)))
    assert float(m["g_loss"]) == float(wm["g_loss"])


def test_gan_batch_scaling_main_appends_the_table(tmp_path, monkeypatch):
    """--out appends the JAX tool's markdown table, one row per B."""
    rows = [{"B": 1, "s_per_it": 0.5, "segments_per_s": 2.0,
             "audio_s_per_s": 0.74, "compile_s": 3.0, "loss": 1.0,
             "peak_gb": None},
            {"B": 2, "s_per_it": 0.8, "segments_per_s": 2.5,
             "audio_s_per_s": 0.93, "compile_s": 3.5, "loss": 1.0,
             "peak_gb": None}]
    monkeypatch.setattr(TGB, "measure", lambda *a, **k: rows)
    out = tmp_path / "report.md"
    TGB.main(["--batches", "1", "2", "--out", str(out), "--device", "cpu"])
    lines = out.read_text().strip().splitlines()
    assert lines[0].startswith("| B | ms/it | segments/s")
    assert lines[2] == "| 1 | 500.0 | 2.0 | 1 | 3 | 1.00x | 1.00x |"
    assert lines[3] == "| 2 | 800.0 | 2.5 | 1 | 4 | 1.60x | 1.25x |"
