"""The port's text → wav CLI against the JAX package's, both run end to end
on one script at the SMALL size (the hparams string of
tests/test_apps_cli.py, prenet dropout off: the port cannot replay JAX's
RNG), on the same weights: the JAX CLI reads its Orbax checkpoint, the port
its own checkpoint of the same params, and both the same reference-format
HiFi-GAN file and JSON config, with bias removal.

Tolerances: mel lengths exactly; the int16 wavs within 2 LSB (f32
arithmetic summed in another order, then a truncating cast); the mels
1e-5 of their scale."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read

from tacotron2_subword_tpu import train_lib as JT
from tacotron2_subword_tpu.apps import inference as JI
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.text import lexicon as JL
from tacotron2_subword_tpu.utils import checkpoint as JCK
from tacotron2_subword_tpu_torch import train_lib as TT
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.config import TacotronConfig as TConfig
from tacotron2_subword_tpu_torch.utils import checkpoint as TCK
from tacotron2_subword_tpu_torch.utils.import_jax import \
    tacotron2_params_from_numpy
from tests.test_apps_cli import HP as SMALL_HP
from tests.test_model import SMALL
from tests.test_torch_checkpoint import hifigan_state_dict
from tests.test_torch_text import LEXICON, RESOURCE_NAMES

HP = SMALL_HP[:-1] + "-prenet_dropout_always_on:false-gate_threshold:0.45]"
SCRIPT = "u0|ba me em\nu1|Nam, anh banh!\nu2|em nam an ba me nhanh\n"
HIFIGAN = {"resblock": "1", "upsample_rates": [8, 8, 4],
           "upsample_kernel_sizes": [16, 16, 8],
           "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 5],
           "resblock_dilation_sizes": [[1, 3], [1, 3]],
           "num_mels": SMALL.n_mel_channels, "sampling_rate": 22050}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Resources (lexicons, phone_id_list.txt), both checkpoints of one
    set of params, a reference-format HiFi-GAN file and its config."""
    d = tmp_path_factory.mktemp("cli")
    res = d / "res"
    res.mkdir()
    for name in RESOURCE_NAMES + ("small.lex",):
        (res / name).write_text(LEXICON, encoding="utf-8")
    lexicons = [JL.load_lexicon(str(res / "small.lex"))]
    p2i, _ = JL.build_phone_id_map(lexicons, ["_", "-", "~", "+", " ", ",",
                                              ".", "!", "?"])
    JL.dump_phone_id_file(p2i, str(res / "phone_id_list.txt"))

    # under the JAX CLI's own device context, so that its restore template
    # reuses these compiled init ops
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        state, _ = JT.create_train_state(jax.random.PRNGKey(0), SMALL)
    state = state._replace(step=jnp.asarray(200, jnp.int32))
    JCK.save_checkpoint(state, str(d / "jax_ck"))
    tcfg = TConfig(**dataclasses.asdict(SMALL))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, bn = tacotron2_params_from_numpy(np_tree(state.params),
                                             np_tree(state.bn_state), tcfg,
                                             device="cpu")
    opt = TT.make_optimizer(tcfg).init(params)
    TCK.save_checkpoint(TT.TrainState(200, params, bn, opt),
                        str(d / "port_ck"))

    (d / "config.json").write_text(json.dumps(HIFIGAN))
    h = JHG.HifiganConfig.from_json(str(d / "config.json"))
    gen = JHG.init_generator(jax.random.PRNGKey(2), h)

    def unit_norm(tree):  # g = 1: rows of norm 1 keep the signal's scale
        if isinstance(tree, dict):
            return {k: (jnp.ones_like(v) if k == "g" else unit_norm(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [unit_norm(v) for v in tree]
        return tree
    gen = unit_norm(gen)
    gen["conv_post"]["g"] = gen["conv_post"]["g"] * 0.1  # tanh unsaturated
    torch.save({"generator": hifigan_state_dict(gen)}, str(d / "g_00000100"))
    (d / "script.txt").write_text(SCRIPT, encoding="utf-8")
    return d


def _argv(d, ckpt, out, *extra):
    return ["--script", str(d / "script.txt"), "--checkpoint-dir",
            str(d / ckpt), "--out-dir", str(d / out), "--g2p-lexicon",
            str(d / "res" / "small.lex"), "--max-decoder-steps", "16",
            "--hparams", HP, *extra]


@pytest.fixture(scope="module")
def rendered(assets):
    """Both CLIs on the script with HiFi-GAN; the mels and lengths each
    hands to its vocoder."""
    d = assets
    voc = ["--hifigan-checkpoint", str(d / "g_00000100"),
           "--hifigan-config", str(d / "config.json")]
    seen = {"jax": [], "port": []}
    j_vocode, t_synth = JI.vocode_bucketed, TI.synthesize_text

    def j_spy(vocode, mel, n, *a, **k):
        seen["jax"].append((n, np.asarray(mel)[0, :, :max(n, 8)]))
        return j_vocode(vocode, mel, n, *a, **k)

    def t_spy(syn, text):
        r = t_synth(syn, text)
        seen["port"].append((r["n_frames"], r["mel"]))
        return r

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("T2S_RESOURCES_DIR", str(d / "res"))
        mp.setattr(JI, "vocode_bucketed", j_spy)
        mp.setattr(TI, "synthesize_text", t_spy)
        n_jax = JI.run_inference(JI.build_argparser().parse_args(
            _argv(d, "jax_ck", "jax_out", *voc)))
        n_port = TI.main(_argv(d, "port_ck", "port_out", *voc,
                               "--device", "cpu"))
    return d, n_jax, n_port, seen


def test_cli_wavs_match_jax(rendered):
    d, n_jax, n_port, seen = rendered
    assert n_jax == n_port == 3
    assert [n for n, _ in seen["port"]] == [n for n, _ in seen["jax"]]
    assert len({n for n, _ in seen["port"]}) > 1   # the gate stops lines apart
    for (_, tm), (_, jm) in zip(seen["port"], seen["jax"]):
        assert np.abs(tm - jm).max() <= 1e-5 * np.abs(jm).max()
    for utt in ("u0", "u1", "u2"):
        sr_t, t = read(str(d / "port_out" / "audio" / f"{utt}.wav"))
        sr_j, j = read(str(d / "jax_out" / "audio" / f"{utt}.wav"))
        assert sr_t == sr_j == 22050 and t.dtype == j.dtype == np.int16
        assert t.shape == j.shape
        peak = np.abs(j.astype(np.int32))
        assert peak.max() > 1000 and (peak >= 32767).mean() < 0.01, peak.max()
        assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 2


def test_cli_writes_plots(rendered):
    pytest.importorskip("matplotlib")
    d = rendered[0]
    for sub in ("alignment", "alignment_bert", "mels"):
        for utt in ("u0", "u1", "u2"):
            assert (d / "port_out" / sub / f"{utt}.png").stat().st_size > 0


def test_cli_griffin_lim_resume_and_overwrite(assets, monkeypatch):
    """No vocoder checkpoint: Griffin-Lim, a 22050 Hz int16 wav of
    max(n, 8) * 256 samples; a second run skips the rendered id and
    --overwrite renders it again."""
    d = assets
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(d / "res"))
    (d / "one.txt").write_text("g0|ba nam\n", encoding="utf-8")
    seen = []
    synth = TI.synthesize_text
    monkeypatch.setattr(TI, "synthesize_text",
                        lambda syn, text: seen.append(synth(syn, text))
                        or seen[-1])
    argv = _argv(d, "port_ck", "gl_out", "--device", "cpu")
    argv[1] = str(d / "one.txt")
    assert TI.main(argv) == 1
    sr, wav = read(str(d / "gl_out" / "audio" / "g0.wav"))
    assert sr == 22050 and wav.dtype == np.int16
    assert len(wav) == max(seen[0]["n_frames"], 8) * 256
    assert set(seen[0]["times"]) == {"front_end", "acoustic", "vocoder",
                                     "wav_write"}
    assert TI.main(argv) == 0
    assert TI.main(argv + ["--overwrite"]) == 1


def test_cli_needs_cuda_unless_told_cpu(assets, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(assets / "res"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TI.main(_argv(assets, "port_ck", "nocuda_out"))


@pytest.mark.parametrize("name", ["g.onnx", "g.tflite", "orbax_dir"])
def test_unported_vocoder_formats_raise(tmp_path, name, monkeypatch):
    """Orbax generator directories are not read (the message names
    tools/orbax_to_torch.py, which converts them);
    an .onnx path is opened (a missing file raises), and a .tflite one
    needs tensorflow."""
    path = tmp_path / name
    if name == "orbax_dir":
        path.mkdir()
        err, match = NotImplementedError, "tools/orbax_to_torch.py"
    elif name == "g.onnx":
        err, match = FileNotFoundError, "g.onnx"
    else:
        monkeypatch.setitem(__import__("sys").modules, "tensorflow", None)
        err, match = RuntimeError, "tensorflow is not installed"
    with pytest.raises(err, match=match):
        TI.load_vocoder(str(path), None, "cpu")
