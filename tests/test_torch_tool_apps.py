"""The port's tool CLIs against the JAX package's, on the CPU: preprocess
(all five subcommands), dump_phone_id_map, the packaged tokenizer and
check_bert_emb, and the news-reader demo.

Tolerances: mels within 1e-5 of their scale (the same f32 STFT summed in
another order); ID files, [CLS] files, lists, phone-ID maps and token
streams byte-equal; the demo's int16 wav within 2 LSB of the JAX demo's
(f32 decode and vocoder in another order, then a truncating cast), run in
one process (its subword IDs are Python's salted ``hash``) with JAX's
prenet masks injected."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read, write

from tacotron2_subword_tpu.apps import check_bert_emb as JCB
from tacotron2_subword_tpu.apps import demo as JD
from tacotron2_subword_tpu.apps import dump_phone_id_map as JDP
from tacotron2_subword_tpu.apps import preprocess as JP
from tacotron2_subword_tpu.apps import inference as JI
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.models import tacotron2 as JM
from tacotron2_subword_tpu.text import bert as JB
from tacotron2_subword_tpu.text import lexicon as JL
from tacotron2_subword_tpu_torch.apps import check_bert_emb as TCB
from tacotron2_subword_tpu_torch.apps import demo as TD
from tacotron2_subword_tpu_torch.apps import dump_phone_id_map as TDP
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.apps import preprocess as TP
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.text import bert as TB
from tacotron2_subword_tpu_torch.text import lexicon as TL
from tacotron2_subword_tpu_torch.utils.import_jax import \
    tacotron2_params_from_numpy
from tests.test_apps_cli import HP as SMALL_HP
from tests.test_model import SMALL
from tests.test_torch_checkpoint import hifigan_state_dict
from tests.test_torch_vocoder_runtimes import _unit_norm
from tests.test_torch_text import LEXICON, RESOURCE_NAMES
from tests.torch_threads import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _jax_main(main, argv):
    """A JAX CLI's main(), which reads sys.argv."""
    old = sys.argv
    sys.argv = ["prog"] + argv
    try:
        return main()
    finally:
        sys.argv = old


@pytest.fixture
def resources(tmp_path, monkeypatch):
    res = tmp_path / "res"
    res.mkdir()
    for name in RESOURCE_NAMES + ("small.lex",):
        (res / name).write_text(LEXICON, encoding="utf-8")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(res))
    return res


# ---------------------------------------------------------------------------
# dump_phone_id_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--delimiter", "z",
                                        "--pause-symbols", "sil"]])
def test_dump_phone_id_map_matches_jax(tmp_path, resources, extra):
    lex = str(resources / "small.lex")
    argv = ["--vi-lex", lex, "--en-lex", lex, "--foreign-lex", lex] + extra
    _jax_main(JDP.main, argv + ["--out", str(tmp_path / "j.txt")])
    n = TDP.main(argv + ["--out", str(tmp_path / "t.txt")])
    data = (tmp_path / "t.txt").read_bytes()
    assert data == (tmp_path / "j.txt").read_bytes()
    assert n == len(data.decode("utf-8").splitlines())
    p2i, _ = TL.load_phone_id_file(str(tmp_path / "t.txt"))
    TL.dump_phone_id_file(p2i, str(tmp_path / "t2.txt"))
    JL.dump_phone_id_file(p2i, str(tmp_path / "j2.txt"))
    assert (tmp_path / "t2.txt").read_bytes() == data == \
        (tmp_path / "j2.txt").read_bytes()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

TRANSCRIPT = "a|Ba me, em!\nb|em nam an banh\nc|Anh ba me nhanh.\n"


def test_preprocess_matches_jax(tmp_path, resources):
    wavd = tmp_path / "wav"
    wavd.mkdir()
    rng = np.random.RandomState(0)
    # named as the phones files, so that the lists' rows exist
    for name, seconds in (("0", 0.5), ("1", 0.31), ("2", 0.8)):
        n = int(seconds * 22050)
        t = np.arange(n) / 22050
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.02 * rng.randn(n)
        write(str(wavd / f"{name}.wav"), 22050,
              (wav * 32767).astype(np.int16))
    (tmp_path / "t.txt").write_text(TRANSCRIPT, encoding="utf-8")
    lex = str(resources / "small.lex")
    tok = TB.packaged_tokenizer_path()
    runs = {
        "mels": ["mels", "--wav-dir", str(wavd), "--out-dir", "{}/mels"],
        "phones": ["phones", "--transcript", str(tmp_path / "t.txt"),
                   "--out-dir", "{}/phones", "--g2p-lexicon", lex],
        "subwords": ["subwords", "--transcript", str(tmp_path / "t.txt"),
                     "--sub-dir", "{}/sub", "--cls-dir", "{}/cls",
                     "--vocab", "64"],
        "tokenized": ["subwords", "--transcript", str(tmp_path / "t.txt"),
                      "--sub-dir", "{}/tok", "--cls-dir", "{}/tok_cls",
                      "--vocab", "300", "--tokenizer-json", tok],
        "lists": ["lists", "--wav-dir", str(wavd), "--dur-dir",
                  "{}/phones", "--train-out", "{}/lists/train.txt",
                  "--val-out", "{}/lists/val.txt", "--val-fraction", "0.4"]}
    counts = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        for key, argv in runs.items():
            argv = [a.format(out) for a in argv]
            if side == "jax":
                _jax_main(JP.main, argv)
            else:
                counts[key] = TP.main(argv + (["--device", "cpu"]
                                              if key == "mels" else []))
    assert counts == {"mels": 3, "phones": 3, "subwords": 3,
                      "tokenized": 3, "lists": 3}
    j, t = tmp_path / "jax", tmp_path / "port"
    names = sorted(os.listdir(j / "mels"))
    assert names == sorted(os.listdir(t / "mels")) == [
        f"ljspeech-mel-{i:05d}.npy" for i in (1, 2, 3)]
    for name in names:
        jm, tm = np.load(j / "mels" / name), np.load(t / "mels" / name)
        assert tm.dtype == jm.dtype == np.float32 and tm.shape == jm.shape
        assert tm.shape[0] == 80
        np.testing.assert_allclose(tm, jm, rtol=0,
                                   atol=1e-5 * np.abs(jm).max())
    for sub in ("phones", "sub", "cls", "tok", "tok_cls", "lists"):
        files = sorted(os.listdir(j / sub))
        assert files and files == sorted(os.listdir(t / sub))
        for f in files:
            # each side's lists name its own phones dir
            got = (t / sub / f).read_bytes().replace(bytes(t), bytes(j))
            assert got == (j / sub / f).read_bytes(), f"{sub}/{f}"
    # the port's lists point at the port's phones dir: its paths all exist
    assert TP.main(["check", str(t / "lists" / "train.txt")]) == 0
    (t / "lists" / "broken.txt").write_text(
        f"{wavd / '0.wav'}|{tmp_path / 'nope.npy'}\n")
    jargs = JP.argparse.Namespace(list_file=str(t / "lists" / "broken.txt"))
    assert TP.main(["check", str(t / "lists" / "broken.txt")]) == \
        JP.cmd_check(jargs) == 1


def test_preprocess_mels_need_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.main(["mels", "--wav-dir", str(tmp_path), "--out-dir",
                 str(tmp_path / "m")])


# ---------------------------------------------------------------------------
# The packaged tokenizer and check_bert_emb
# ---------------------------------------------------------------------------

TEXT = "toi so gian qua hoa lieu ba me em"


def test_packaged_tokenizer_is_the_jax_asset():
    path = TB.packaged_tokenizer_path()
    assert path is not None and path.startswith(os.path.dirname(
        os.path.dirname(os.path.abspath(TB.__file__))))
    with open(path, "rb") as f, open(JB.packaged_tokenizer_path(), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kw", [
    {}, {"fallback_vocabs": [5500, 6000, 7500]},
    {"tokenizers": "packaged", "fallback_vocabs": [64]}])
def test_check_bert_emb_matches_jax(kw):
    if kw.get("tokenizers") == "packaged":
        kw = dict(kw, tokenizers=[TB.packaged_tokenizer_path()])
    t, j = TCB.check(TEXT, **kw), JCB.check(TEXT, **kw)
    assert t == j
    assert t["variants"] and all(not v["has_cls"]
                                 for v in t["variants"].values())


def test_check_bert_emb_cli_prints_variants_and_pairs(capsys):
    rep = TCB.main(["--text", TEXT, "--fallback-vocabs", "5500", "6000"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("crc32_5500: vocab=5500 n_tokens=9 ids=")
    assert out[2].startswith("crc32_5500|crc32_6000: {'len_a': 9")
    assert rep["pairs"]["crc32_5500|crc32_6000"]["jaccard"] < 1.0
    with pytest.raises(ValueError, match="no tokenizer variants"):
        TCB.check(TEXT, tokenizers=[], fallback_vocabs=[])


# ---------------------------------------------------------------------------
# The news-reader demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "Ba me em. Em nam!  Anh banh?\nNam an", "no terminal punctuation",
    "  a.b. c! d?e  ", ""])
def test_split_sentences_matches_jax(text):
    assert TD.split_sentences(text) == JD.split_sentences(text)


DEMO_TEXT = "Ba me em. Em me ba!\nMe ba em?"   # one length: one JAX compile
DEMO_STEPS = 16


def _jax_prenet_masks(steps, prenet_dim):
    """The scaled prenet keep-masks [4, 1, P] of each decoder step that the
    JAX demo's ``M.infer(rng=PRNGKey(0))`` draws."""
    key = jax.random.split(jax.random.PRNGKey(0), 5)[3]
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(JM._prenet_masks(
            k, 4, (1, prenet_dim), np.float32))))
    return out


DEMO_HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 4],
                "upsample_kernel_sizes": [16, 16, 8],
                "upsample_initial_channel": 16,
                "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
                "num_mels": SMALL.n_mel_channels}


@pytest.fixture
def demo_assets(tmp_path, resources, monkeypatch):
    """One set of SMALL acoustic weights handed to both demos in place of
    their checkpoints (the inference CLI tests cover loading), and a
    unit-norm HiFi-GAN file with its config."""
    import dataclasses
    import json
    params, bn = jax.jit(lambda k: JM.init_tacotron2(k, SMALL))(
        jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tp, tbn = tacotron2_params_from_numpy(
        np_tree(params), np_tree(bn), TConfig(**dataclasses.asdict(SMALL)),
        device="cpu")
    monkeypatch.setattr(JI, "load_acoustic_model", lambda ck, cfg: (params,
                                                                    bn))
    monkeypatch.setattr(TI, "load_acoustic_model", lambda ck, cfg, dev: (
        tp, tbn))
    (tmp_path / "ck" / "checkpoint_1").mkdir(parents=True)
    (tmp_path / "config.json").write_text(json.dumps(DEMO_HIFIGAN))
    h = JHG.HifiganConfig.from_json(str(tmp_path / "config.json"))
    gen = _unit_norm(jax.jit(lambda k: JHG.init_generator(k, h))(
        jax.random.PRNGKey(2)))
    torch.save({"generator": hifigan_state_dict(gen)},
               str(tmp_path / "g_00000100"))
    (tmp_path / "news.txt").write_text(DEMO_TEXT, encoding="utf-8")
    return tmp_path


def test_demo_matches_jax(demo_assets, monkeypatch):
    """Both demos on three sentences (prenet dropout on, with JAX's masks
    injected into the port's decode, restarting at each sentence as the
    JAX demo restarts its key), gate 0.45 so the sentences stop before
    the step limit: the same wav within 2 LSB, each sentence followed by
    0.15 s of silence."""
    d = demo_assets
    hp = SMALL_HP[:-1] + "-gate_threshold:0.45]"
    argv = ["--text-file", str(d / "news.txt"), "--g2p-lexicon",
            str(d / "res" / "small.lex"), "--hifigan-checkpoint",
            str(d / "g_00000100"), "--hifigan-config",
            str(d / "config.json"), "--max-decoder-steps", str(DEMO_STEPS),
            "--hparams", hp, "--checkpoint-dir", str(d / "ck")]
    _jax_main(JD.main, argv + ["--out", str(d / "jax_news.wav")])

    masks = _jax_prenet_masks(DEMO_STEPS, SMALL.prenet_dim)
    it = [iter(masks)]
    real_infer = TM.infer
    frames = []

    def infer(*a, **k):
        it[0] = iter(masks)
        out = real_infer(*a, **k)
        frames.append(int(out["mel_lengths"][0]))
        return out
    monkeypatch.setattr(TM, "infer", infer)
    monkeypatch.setattr(TM, "_prenet_masks",
                        lambda gen, n, shape, dtype, dev: next(it[0]).to(
                            dtype))
    wav = TD.main(argv + ["--out", str(d / "port_news.wav"), "--device",
                          "cpu"])
    # the gate stops each sentence (below 8 frames here: the mel is cut to
    # 8, the JAX demo's floor)
    assert len(frames) == 3 and max(frames) < DEMO_STEPS, frames
    pause = int(0.15 * 22050)
    assert len(wav) == sum(max(n, 8) * 256 + pause for n in frames)
    sr_j, j = read(str(d / "jax_news.wav"))
    sr_t, t = read(str(d / "port_news.wav"))
    assert sr_j == sr_t == 22050 and t.dtype == j.dtype == np.int16
    assert t.shape == j.shape == wav.shape
    # not silent: the bound of 2 LSB is ~1 % of the peak or less
    peak = np.abs(j.astype(np.int32))
    assert peak.max() > 200 and (peak >= 32767).mean() < 0.01, peak.max()
    assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 2
    # the pause after each sentence is silent
    assert not t[-pause:].any()
