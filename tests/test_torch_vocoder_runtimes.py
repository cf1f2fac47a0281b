"""The port's exported-vocoder path against the JAX package's, on the CPU:
the ONNX encoder / decoder (utils/onnx_lite), the torch executor against
JAX's numpy ``run_model``, the port's exporter against JAX
tools/export_hifigan_onnx.py, ``load_vocoder`` and the inference CLI with
an ``.onnx`` vocoder, and the TFLite path without tensorflow.

Tolerances: encoded bytes and decoded graphs exactly; the executor 1e-5
of the output's scale against JAX's numpy executor (the same f32
convolutions summed in another order); initializers of the two exporters
1e-6 of each tensor's scale (weight norm fused by each package); the CLI's
int16 wavs within 2 LSB of the JAX CLI's for the same acoustic output (a
truncating cast after f32 arithmetic in another order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read

from tacotron2_subword_tpu.apps import inference as JI
from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu.utils import onnx_lite as JOX
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.models import vocoder_runtimes as TVR
from tacotron2_subword_tpu_torch.tools import export_hifigan_onnx as TEX
from tacotron2_subword_tpu_torch.utils import onnx_lite as TOX
from tacotron2_subword_tpu_torch.utils.import_jax import \
    hifigan_params_from_numpy
from tools import export_hifigan_onnx as JEX

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CONFIGS = {
    "v1": dict(resblock="1", upsample_rates=(4, 4),
               upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
               resblock_kernel_sizes=(3, 5),
               resblock_dilation_sizes=((1, 2, 3), (1, 2)), num_mels=8),
    "v3": dict(resblock="2", upsample_rates=(4,), upsample_kernel_sizes=(8,),
               upsample_initial_channel=16, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), num_mels=8),
    # 256x upsampling: one mel frame per hop, as the CLI cuts the wav
    "cli": dict(resblock="1", upsample_rates=(8, 8, 4),
                upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                num_mels=8)}


def _unit_norm(tree):
    """g = 1 (rows of norm 1 keep the signal's scale; the init's output is
    too small for an int16 wav), 0.1 on conv_post (tanh unsaturated)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: jnp.ones_like(v) if k == "g" else walk(v)
                    for k, v in t.items()}
        return [walk(v) for v in t] if isinstance(t, list) else t
    tree = walk(tree)
    tree["conv_post"]["g"] = tree["conv_post"]["g"] * 0.1
    return tree


def _generator(name, seed=0, unit=False):
    """(JAX config, port config, weight-normed JAX params, port params)."""
    jh, th = JHG.HifiganConfig(**CONFIGS[name]), THG.HifiganConfig(
        **CONFIGS[name])
    raw = JHG.init_generator(jax.random.PRNGKey(seed), jh)
    if unit:
        raw = _unit_norm(raw)
    tp = hifigan_params_from_numpy(jax.tree_util.tree_map(np.asarray, raw),
                                   th, device="cpu")
    return jh, th, raw, tp


def test_encode_and_decode_match_jax_bytes():
    rng = np.random.RandomState(0)
    inits = {"w": rng.randn(4, 3, 5).astype(np.float32),
             "b": rng.randn(4).astype(np.float32),
             "s": np.asarray([0.5], np.float32)}
    attrs = {"pads": [2, 2], "dilations": [1], "strides": [1], "group": 1,
             "alpha": 0.2, "mode": "x", "scales": [0.5, 1.5]}
    args = (inits, {"x": ["B", 3, "T"]}, {"y": ["B", 4, "T"]}, "g")
    jb = JOX.encode_model([JOX.Node("Conv", ["x", "w", "b"], ["y"], attrs)],
                          *args, producer="p")
    tb = TOX.encode_model([TOX.Node("Conv", ["x", "w", "b"], ["y"], attrs)],
                          *args, producer="p")
    assert tb == jb
    jn, ji, jin, jout = JOX.decode_model(jb)
    tn, ti, tin, tout = TOX.decode_model(jb)
    assert (tin, tout) == (jin, jout) == (["x"], ["y"])
    assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in tn] == \
        [(n.op_type, n.inputs, n.outputs, n.attrs) for n in jn]
    assert ti.keys() == ji.keys() == inits.keys()
    for k in inits:
        np.testing.assert_array_equal(ti[k], ji[k])
        np.testing.assert_array_equal(ti[k], inits[k])


@pytest.mark.parametrize("name", ["v1", "v3"])
def test_executor_matches_jax_numpy_executor(tmp_path, name):
    jh, _, raw, _ = _generator(name)
    path = str(tmp_path / f"{name}.onnx")
    JEX.export_onnx(raw, jh, path)
    blob = open(path, "rb").read()
    mel = np.random.RandomState(1).randn(2, 8, 7).astype(np.float32)
    j = JOX.run_model(JOX.decode_model(blob), {"mel": mel})[0]
    graph = TOX.load_graph(TOX.decode_model(blob), "cpu")
    t = TOX.run_model(graph, {"mel": torch.from_numpy(mel)})[0]
    assert t.dtype == torch.float32 and t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_executor_asymmetric_pads_and_unsupported_ops():
    """Conv / ConvTranspose pads of two sizes, grouped and strided Conv
    against JAX's numpy executor; unknown ops and grouped ConvTranspose
    raise."""
    rng = np.random.RandomState(2)
    inits = {"w": rng.randn(6, 2, 3).astype(np.float32),
             "b": rng.randn(6).astype(np.float32),
             "wt": rng.randn(6, 3, 4).astype(np.float32),
             "bt": rng.randn(3).astype(np.float32)}
    nodes = [JOX.Node("Conv", ["x", "w", "b"], ["h"],
                      {"pads": [3, 1], "group": 2, "strides": [2],
                       "dilations": [2]}),
             JOX.Node("ConvTranspose", ["h", "wt", "bt"], ["y"],
                      {"pads": [1, 2], "strides": [3]})]
    blob = JOX.encode_model(nodes, inits, {"x": ["B", 4, "T"]},
                            {"y": ["B", 3, "T"]})
    x = rng.randn(2, 4, 13).astype(np.float32)
    j = JOX.run_model(JOX.decode_model(blob), {"x": x})[0]
    t = TOX.run_model(TOX.load_graph(TOX.decode_model(blob), "cpu"),
                      {"x": torch.from_numpy(x)})[0]
    assert t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())
    for node in (JOX.Node("Sin", ["x"], ["y"]),
                 JOX.Node("ConvTranspose", ["x", "wt"], ["y"],
                          {"group": 2})):
        blob = JOX.encode_model([node], inits, {"x": ["B", 6, "T"]},
                                {"y": ["B", 6, "T"]})
        with pytest.raises(NotImplementedError):
            TOX.run_model(TOX.load_graph(TOX.decode_model(blob), "cpu"),
                          {"x": torch.zeros(1, 6, 5)})


@pytest.mark.parametrize("name", ["v1", "v3"])
def test_exporter_matches_jax_tool(tmp_path, name):
    """The port's exporter on the port's copy of the weights writes the JAX
    tool's graph: the same nodes, initializer names and values, and the
    same wav through either executor."""
    jh, th, raw, tp = _generator(name, seed=3)
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    JEX.export_onnx(raw, jh, jpath)
    assert TEX.export_onnx(tp, th, tpath) > 1000
    jn, ji, jin, jout = TOX.decode_model(open(jpath, "rb").read())
    tn, ti, tin, tout = TOX.decode_model(open(tpath, "rb").read())
    assert (tin, tout) == (jin, jout) == (["mel"], ["wav"])
    assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in tn] == \
        [(n.op_type, n.inputs, n.outputs, n.attrs) for n in jn]
    assert list(ti) == list(ji)
    for k in ji:
        np.testing.assert_allclose(ti[k], ji[k], rtol=0,
                                   atol=1e-6 * np.abs(ji[k]).max(), err_msg=k)
    mel = np.random.RandomState(4).randn(1, 8, 9).astype(np.float32)
    ref = np.asarray(JHG.generator_apply(JHG.fuse_generator(raw), jh,
                                         jnp.asarray(mel)))
    voc = TVR.load_onnx_vocoder(tpath, "cpu")
    out = voc(torch.from_numpy(mel))
    assert out.shape == (1, 9 * th.total_upsample)
    np.testing.assert_allclose(out.numpy(), ref.reshape(1, -1), rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_exporter_cli_reads_a_g_file(tmp_path):
    jh, th, raw, tp = _generator("v1", seed=5)
    g = tmp_path / "g_00000001"
    torch.save({"generator": THG.export_torch_generator(tp)}, str(g))
    cfg = tmp_path / "c.json"
    cfg.write_text(__import__("json").dumps(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in CONFIGS["v1"].items()}))
    out = str(tmp_path / "g.onnx")
    n = TEX.main(["--out", out, "--checkpoint", str(g), "--config",
                  str(cfg)])
    assert n == len(open(out, "rb").read())
    ref = str(tmp_path / "ref.onnx")
    TEX.export_onnx(tp, th, ref)
    assert open(ref, "rb").read() == open(out, "rb").read()
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        TEX.main(["--out", out, "--checkpoint", str(tmp_path / "orbax")])


# ---------------------------------------------------------------------------
# load_vocoder and the inference CLI with an .onnx vocoder
# ---------------------------------------------------------------------------

HP = ("[n_symbols:23-sub_n_symbols:31-symbols_embedding_dim:16-"
      "encoder_embedding_dim:16-bert_embedding_dim:12-attention_rnn_dim:20-"
      "attention_dim:8-decoder_rnn_dim:24-prenet_dim:10-n_mel_channels:8-"
      "postnet_embedding_dim:16-max_decoder_steps:30-parity_mode:true]")
N_FRAMES = 21   # the stubbed acoustic model's mel length (padded to 64)


def test_load_vocoder_onnx(tmp_path):
    jh, th, raw, tp = _generator("v1", seed=6)
    path = str(tmp_path / "v.onnx")
    TEX.export_onnx(tp, th, path)
    vocode, name = TI.load_vocoder(path, None, "cpu")
    assert name == "hifigan-onnx"
    mel = torch.full((1, 8, 9), -5.0)
    wav = TI.vocode_bucketed(vocode, mel, [9], hop=th.total_upsample)[0]
    padded = torch.cat([mel, torch.full((1, 8, 55), TI.MEL_FLOOR)], dim=-1)
    ref = THG.generator_apply(THG.fuse_generator(tp), th, padded)[0, 0,
                                                                  :9 * 16]
    np.testing.assert_allclose(wav.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def _stub_acoustic(monkeypatch, mel):
    """Both CLIs' acoustic models replaced by one fixed output (their
    checkpoints are not read), so the two lines differ only in the vocoder
    path."""
    n = mel.shape[-1]
    monkeypatch.setattr(JI, "load_acoustic_model", lambda ck, cfg: (None,
                                                                    None))
    monkeypatch.setattr(TI, "load_acoustic_model", lambda ck, cfg, dev: (
        None, None))

    class JaxModel:
        @staticmethod
        def infer(*a, **k):
            return {"mel_postnet": jnp.asarray(mel),
                    "mel_lengths": jnp.asarray([n]),
                    "infer_ok": jnp.asarray([True]),
                    "alignments": jnp.ones((1, n, 4)) / 4,
                    "alignments_bert": jnp.ones((1, n, 4)) / 4}

    class PortModel:
        @staticmethod
        def infer(*a, **k):
            return {"mel_postnet": torch.from_numpy(mel),
                    "mel_lengths": torch.tensor([n]),
                    "infer_ok": torch.tensor([True]), "steps_run": n,
                    "alignments": torch.ones(1, n, 4) / 4,
                    "alignments_bert": torch.ones(1, n, 4) / 4}
    monkeypatch.setattr(JI, "M", JaxModel)
    monkeypatch.setattr(TI, "M", PortModel)


def test_cli_onnx_line_matches_jax_cli(tmp_path, monkeypatch):
    """One script line through both CLIs with ``--hifigan-checkpoint
    x.onnx`` and the same acoustic output: the same int16 wav within 2
    LSB, scaled by 32768 (not 32768 x 1.7) and not denoised."""
    from tests.test_torch_text import LEXICON, RESOURCE_NAMES
    res = tmp_path / "res"
    res.mkdir()
    for n in RESOURCE_NAMES + ("small.lex",):
        (res / n).write_text(LEXICON, encoding="utf-8")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(res))
    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / "checkpoint_1").mkdir()
    (tmp_path / "s.txt").write_text("u0|ba me em nam\n", encoding="utf-8")
    jh, th, raw, tp = _generator("cli", seed=7, unit=True)
    onnx = str(tmp_path / "g.onnx")
    TEX.export_onnx(tp, th, onnx)
    mel = (np.random.RandomState(8).randn(1, 8, N_FRAMES) - 2).astype(
        np.float32)
    _stub_acoustic(monkeypatch, mel)
    monkeypatch.setattr(TI, "save_plots", lambda *a: None)
    monkeypatch.setattr(JI, "_save_plot", lambda *a: None)
    seen = []
    real = TI.synthesize_text
    monkeypatch.setattr(TI, "synthesize_text",
                        lambda syn, text: seen.append(real(syn, text))
                        or seen[-1])

    def argv(out):
        return ["--script", str(tmp_path / "s.txt"), "--checkpoint-dir",
                str(tmp_path / "ck"), "--out-dir", str(tmp_path / out),
                "--g2p-lexicon", str(res / "small.lex"), "--hparams", HP,
                "--hifigan-checkpoint", onnx]
    assert JI.run_inference(JI.build_argparser().parse_args(
        argv("jax"))) == 1
    assert TI.main(argv("port") + ["--device", "cpu"]) == 1
    sr_j, j = read(str(tmp_path / "jax" / "audio" / "u0.wav"))
    sr_t, t = read(str(tmp_path / "port" / "audio" / "u0.wav"))
    assert sr_j == sr_t == 22050 and t.shape == j.shape == (N_FRAMES * 256,)
    assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 2
    peak = np.abs(j.astype(np.int32))
    assert peak.max() > 1000 and (peak >= 32767).mean() < 0.01, peak.max()
    # 32768 x the vocoder's output, no denoiser
    ref = THG.generator_apply(THG.fuse_generator(tp), th, torch.from_numpy(
        np.pad(mel, ((0, 0), (0, 0), (0, 64 - N_FRAMES)),
               constant_values=TI.MEL_FLOOR)))[0, 0, :N_FRAMES * 256]
    np.testing.assert_allclose(seen[0]["wav"], (ref * 32768).numpy(),
                               rtol=0, atol=1e-5 * 32768)
    assert "denoiser" not in seen[0]["times"]


def test_tflite_without_tensorflow_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    path = str(tmp_path / "g.tflite")
    with pytest.raises(RuntimeError, match="tensorflow is not installed"):
        TVR.load_tflite_vocoder(path)
    with pytest.raises(RuntimeError, match="tensorflow is not installed"):
        TI.load_vocoder(path, None, "cpu")
