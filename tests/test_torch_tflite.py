"""The port's TFLite path on the CPU: the hand-written flatbuffer writer and
reader (utils/tflite_lite) against tensorflow's own schema reader, the
torch executor against ``tf.lite.Interpreter`` and the JAX generator on the
root jax2tf tool's file, the port's exporter (tools/export_hifigan_tflite)
under ``tf.lite.Interpreter``, odd SAME paddings, the errors, and the
inference CLI with a ``.tflite`` vocoder.

Tolerances: decoded tensors, ops and options exactly; every vocoder output
within 1e-5 of its max |value| (the same f32 convolutions summed in another
order, and TFLite's tanh), the weights drawn so that this max is >= 0.1;
the one-op files within 1e-5 of their max; the CLI's int16 wav within 1
LSB of the g_ line's vocoder output x 32768 (a truncating cast)."""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import read

from tacotron2_subword_tpu.models import hifigan as JHG
from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.models import hifigan as THG
from tacotron2_subword_tpu_torch.models import vocoder_runtimes as TVR
from tacotron2_subword_tpu_torch.tools import export_hifigan_tflite as TEX
from tacotron2_subword_tpu_torch.utils import tflite_lite as TL
from tacotron2_subword_tpu_torch.utils.import_jax import \
    hifigan_params_from_numpy

tf = pytest.importorskip("tensorflow")
from tensorflow.lite.python import schema_py_generated as SCHEMA  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: F401


# the root test_tflite_export_roundtrip's config, with a second resblock
# kernel so that the resblocks' average (a MUL) is in the graph
CONFIG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 2, 3), (1, 2, 3)), num_mels=8)
FRAMES = 12
TOL = 1e-5


def _generator(resblock, seed):
    """(JAX config, port config, fused JAX params, port params): the JAX
    init with every weight redrawn at 1 / sqrt(fan-in) and biases at 0.1,
    so the waveform's max is >= 0.1 and tanh is not saturated."""
    jh = JHG.HifiganConfig(resblock=resblock, **CONFIG)
    th = THG.HifiganConfig(resblock=resblock, **CONFIG)
    raw = jax.tree_util.tree_map(np.asarray, JHG.fuse_generator(
        JHG.init_generator(jax.random.PRNGKey(seed), jh)))
    rng = np.random.RandomState(seed)

    def redraw(p, transposed=False):
        w = p["w"]
        fan_in = (w.shape[0] if transposed else w.shape[1]) * w.shape[2]
        return {"w": (rng.randn(*w.shape) / np.sqrt(fan_in)).astype(
                    np.float32),
                "b": (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)}
    raw = {"conv_pre": redraw(raw["conv_pre"]),
           "conv_post": redraw(raw["conv_post"]),
           "ups": [redraw(p, transposed=True) for p in raw["ups"]],
           "resblocks": [{k: [redraw(c) for c in v] for k, v in rb.items()}
                         for rb in raw["resblocks"]]}
    return jh, th, raw, hifigan_params_from_numpy(raw, th, device="cpu")


def _mel(seed, shape=(1, 8, FRAMES)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _interpret(blob, *feeds):
    it = tf.lite.Interpreter(model_content=blob)
    it.allocate_tensors()
    for d, x in zip(it.get_input_details(), feeds):
        it.set_tensor(d["index"], x)
    it.invoke()
    return it.get_tensor(it.get_output_details()[0]["index"])


def _close(out, ref, name=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg=name)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """One jax2tf export of the root tool, shared by the module's tests."""
    from tools.export_hifigan_tflite import export_tflite
    jh, th, raw, tp = _generator("1", seed=0)
    path = tmp_path_factory.mktemp("jax") / "g.tflite"
    export_tflite({k: jax.tree_util.tree_map(jnp.asarray, v)
                   for k, v in raw.items()}, jh, str(path), frames=FRAMES)
    return jh, th, raw, tp, path.read_bytes()


def test_writer_round_trip():
    """encode -> decode gives back the same tensors, ops and options; the
    bytes parse under tensorflow's generated schema reader into the same
    model; a second encode writes the same bytes."""
    _, th, _, tp = _generator("1", seed=1)
    model = TEX.generator_tflite_model(tp, th, frames=FRAMES)
    blob = TL.encode_model(model)
    back = TL.decode_model(blob)
    assert (back.inputs, back.outputs) == (model.inputs, model.outputs)
    assert len(back.tensors) == len(model.tensors)
    for a, b in zip(back.tensors, model.tensors):
        assert (a.name, a.shape, a.dtype) == (b.name, b.shape, b.dtype)
        assert (a.data is None) == (b.data is None)
        if b.data is not None:
            assert a.data.dtype == b.data.dtype
            np.testing.assert_array_equal(a.data, b.data)
    assert [(o.code, o.inputs, o.outputs, o.options, o.version)
            for o in back.ops] == \
        [(o.code, o.inputs, o.outputs, TL.full_options(o.code, o.options),
          o.version) for o in model.ops]
    assert TL.encode_model(back) == blob
    assert collections.Counter(TL.op_name(o.code) for o in model.ops) == {
        "TRANSPOSE": 1, "RESHAPE": 2, "CONV_2D": 26, "TRANSPOSE_CONV": 2,
        "LEAKY_RELU": 25, "ADD": 14, "MUL": 2, "TANH": 1}

    m = SCHEMA.ModelT.InitFromObj(SCHEMA.Model.GetRootAs(blob, 0))
    assert blob[4:8] == b"TFL3" and m.version == 3
    assert len(m.subgraphs) == 1 and len(m.buffers[0].data or []) == 0
    g = m.subgraphs[0]
    assert list(g.inputs) == model.inputs and list(g.outputs) == model.outputs
    for t, ref in zip(g.tensors, model.tensors):
        assert t.name.decode() == ref.name
        assert tuple(t.shape) == ref.shape and t.type == ref.dtype
        if ref.data is not None:
            data = m.buffers[t.buffer].data
            raw = np.asarray(data, np.uint8).tobytes()
            assert raw == np.asarray(ref.data).astype(
                ref.data.dtype.newbyteorder("<")).tobytes()
    codes = [max(c.deprecatedBuiltinCode, c.builtinCode)
             for c in m.operatorCodes]
    for op, ref in zip(g.operators, model.ops):
        assert codes[op.opcodeIndex] == ref.code
        assert list(op.inputs) == ref.inputs
        opts = op.builtinOptions
        if ref.code == TL.CONV_2D:
            assert (opts.padding, opts.strideW, opts.strideH,
                    opts.dilationWFactor, opts.dilationHFactor) == (
                TL.SAME, 1, 1, ref.options["dilation_w_factor"], 1)
        elif ref.code == TL.TRANSPOSE_CONV:
            assert (opts.padding, opts.strideW, opts.strideH) == (
                TL.SAME, ref.options["stride_w"], 1)
        elif ref.code == TL.LEAKY_RELU:
            assert opts.alpha == np.float32(ref.options["alpha"])


def test_data_is_16_byte_aligned():
    _, th, _, tp = _generator("2", seed=2)
    blob = TL.encode_model(TEX.generator_tflite_model(tp, th, frames=FRAMES))
    root = TL._Reader(memoryview(blob), int.from_bytes(blob[:4], "little"))
    starts = [b._target(0) + 4 for b in root.tables(4) if b._field(0)]
    assert len(starts) > 10 and all(s % 16 == 0 for s in starts)


def test_jax_tool_file_runs_in_the_port(jax_file):
    """The root jax2tf tool's file through the port's executor on the
    CPU, against tf.lite.Interpreter on the same file and the JAX
    generator."""
    jh, th, raw, tp, blob = jax_file
    model = TL.decode_model(blob)
    ops = collections.Counter(TL.op_name(o.code) for o in model.ops)
    assert set(ops) == {"RESHAPE", "TRANSPOSE", "CONV_2D", "LEAKY_RELU",
                        "TRANSPOSE_CONV", "ADD", "MUL", "TANH"}, ops
    # the port's graph has the same convolutions and activations, without
    # jax2tf's layout changes around each convolution (and its bias ADDs)
    port_ops = collections.Counter(TL.op_name(o.code) for o in
                                   TEX.generator_tflite_model(
                                       tp, th, frames=FRAMES).ops)
    for name in ("CONV_2D", "LEAKY_RELU", "TRANSPOSE_CONV", "MUL", "TANH"):
        assert port_ops[name] == ops[name], name
    assert ops["RESHAPE"] + ops["TRANSPOSE"] > 100
    mel = _mel(3)
    out = TL.run_model(TL.load_graph(model, "cpu"), [torch.from_numpy(mel)])
    ref = np.asarray(JHG.generator_apply(
        {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in raw.items()},
        jh, jnp.asarray(mel)))
    assert np.abs(ref).max() >= 0.1
    _close(out[0].numpy(), _interpret(blob, mel), "executor vs TF")
    _close(out[0].numpy(), ref, "executor vs JAX")


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_port_file_runs_under_tf(tmp_path, resblock):
    """The port exporter's file under tf.lite.Interpreter matches the
    port's generator_apply and the JAX generator with the same weights;
    the port's executor on its own file matches too."""
    jh, th, raw, tp = _generator(resblock, seed=4)
    path = str(tmp_path / "g.tflite")
    n = TEX.export_tflite(tp, th, path, frames=FRAMES)
    blob = open(path, "rb").read()
    assert n == len(blob)
    mel = _mel(5)
    tf_out = _interpret(blob, mel)
    port = THG.generator_apply(tp, th, torch.from_numpy(mel)).numpy()
    jax_out = np.asarray(JHG.generator_apply(
        {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in raw.items()},
        jh, jnp.asarray(mel)))
    assert tf_out.shape == (1, 1, FRAMES * 16)
    assert np.abs(port).max() >= 0.1
    _close(tf_out, port, "TF vs port")
    _close(tf_out, jax_out, "TF vs JAX")
    voc = TVR.load_tflite_vocoder(path, "cpu")
    _close(voc(torch.from_numpy(mel)).numpy(), port.reshape(1, -1),
           "executor vs port")


def _one_op_model(code, x_shape, w_shape, out_shape, options, seed):
    rng = np.random.RandomState(seed)
    tensors = [TL.Tensor("x", x_shape),
               TL.Tensor("w", w_shape, data=rng.randn(*w_shape).astype(
                   np.float32)),
               TL.Tensor("b", (w_shape[0],), data=rng.randn(
                   w_shape[0]).astype(np.float32)),
               TL.Tensor("y", out_shape)]
    if code == TL.CONV_2D:
        inputs = [0, 1, 2]
    else:
        tensors.append(TL.Tensor("out_shape", (4,), TL.INT32,
                                 np.asarray(out_shape, np.int32)))
        inputs = [4, 1, 0, 2]
    return TL.Model(tensors, [TL.Op(code, inputs, [3],
                                    TL.full_options(code, options))],
                    [0], [3]), rng.randn(*x_shape).astype(np.float32)


# (op, input NHWC, filter OHWI, output NHWC, options): SAME with an odd
# total, so TFLite pads one more after than before, and VALID; 2-D, and
# along one axis (the executor's F.conv1d path)
ONE_OPS = {
    "conv_k4_s2_d2_same": (TL.CONV_2D, (2, 4, 12, 3), (4, 3, 4, 3),
                           (2, 2, 6, 4), dict(padding=TL.SAME, stride_w=2,
                                              stride_h=2, dilation_w_factor=2,
                                              dilation_h_factor=1)),
    "conv_k4_s2_d2_valid": (TL.CONV_2D, (2, 4, 12, 3), (4, 3, 4, 3),
                            (2, 1, 3, 4), dict(padding=TL.VALID, stride_w=2,
                                               stride_h=2,
                                               dilation_w_factor=2,
                                               dilation_h_factor=1)),
    "conv_line_k4_s2_d2_same": (TL.CONV_2D, (2, 1, 12, 3), (4, 1, 4, 3),
                                (2, 1, 6, 4), dict(padding=TL.SAME,
                                                   stride_w=2, stride_h=2,
                                                   dilation_w_factor=2,
                                                   dilation_h_factor=1)),
    # an output_shape one past the full result: the bias alone there
    "transpose_conv_line_k5_s2_valid_out18": (
        TL.TRANSPOSE_CONV, (2, 1, 7, 3), (4, 1, 5, 3), (2, 1, 18, 4),
        dict(padding=TL.VALID, stride_w=2, stride_h=1)),
    "transpose_conv_k5_s2_same": (TL.TRANSPOSE_CONV, (2, 1, 7, 3),
                                  (4, 1, 5, 3), (2, 1, 14, 4),
                                  dict(padding=TL.SAME, stride_w=2,
                                       stride_h=1)),
    "transpose_conv_k5_s2_valid": (TL.TRANSPOSE_CONV, (2, 3, 7, 3),
                                   (4, 3, 5, 3), (2, 5, 17, 4),
                                   dict(padding=TL.VALID, stride_w=2,
                                        stride_h=1)),
}


@pytest.mark.parametrize("name", sorted(ONE_OPS))
def test_one_op_files_match_tf(name):
    model, x = _one_op_model(*ONE_OPS[name], seed=len(name))
    blob = TL.encode_model(model)
    out = TL.run_model(TL.load_graph(TL.decode_model(blob), "cpu"),
                       [torch.from_numpy(x)])[0]
    _close(out.numpy(), _interpret(blob, x), name)


@pytest.mark.parametrize("case", ["shape", "op", "activation",
                                  "transpose_conv_past_full"])
def test_errors(case):
    """A wrong input shape raises ValueError naming both shapes; an op
    outside the set, a fused activation and a TRANSPOSE_CONV output_shape
    a stride or more past the full result raise NotImplementedError."""
    model, x = _one_op_model(*ONE_OPS["conv_k4_s2_d2_same"], seed=0)
    if case == "shape":
        with pytest.raises(ValueError, match=r"\(2, 4, 11, 3\).*"
                                             r"\(2, 4, 12, 3\)"):
            TL.run_model(TL.load_graph(model, "cpu"),
                         [torch.zeros(2, 4, 11, 3)])
        return
    if case == "op":
        model.ops[0].code = 34                    # PAD
        match = "PAD|builtin op 34"
    elif case == "activation":
        model.ops[0].options["fused_activation_function"] = 1   # RELU
        match = "CONV_2D with fused activation 1"
    else:
        model, x = _one_op_model(TL.TRANSPOSE_CONV, (2, 1, 7, 3),
                                 (4, 1, 5, 3), (2, 1, 19, 4),
                                 dict(padding=TL.VALID, stride_w=2,
                                      stride_h=1), seed=0)
        match = "past its full result"
    graph = TL.load_graph(TL.decode_model(TL.encode_model(model)), "cpu")
    with pytest.raises(NotImplementedError, match=match):
        TL.run_model(graph, [torch.from_numpy(x)])


def test_exporter_cli_reads_a_g_file(tmp_path):
    _, th, _, tp = _generator("1", seed=6)
    g = tmp_path / "g_00000001"
    torch.save({"generator": THG.export_torch_generator(tp)}, str(g))
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"resblock": "1", **{
        k: [list(x) for x in v] if k == "resblock_dilation_sizes"
        else list(v) if isinstance(v, tuple) else v
        for k, v in CONFIG.items()}}))
    out = str(tmp_path / "g.tflite")
    n = TEX.main(["--out", out, "--checkpoint", str(g), "--config",
                  str(cfg), "--frames", str(FRAMES)])
    ref = str(tmp_path / "ref.tflite")
    TEX.export_tflite(tp, th, ref, frames=FRAMES)
    assert n == len(open(out, "rb").read())
    assert open(ref, "rb").read() == open(out, "rb").read()
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        TEX.main(["--out", out, "--checkpoint", str(tmp_path / "orbax")])


HP = ("[n_symbols:23-sub_n_symbols:31-symbols_embedding_dim:16-"
      "encoder_embedding_dim:16-bert_embedding_dim:12-attention_rnn_dim:20-"
      "attention_dim:8-decoder_rnn_dim:24-prenet_dim:10-n_mel_channels:8-"
      "postnet_embedding_dim:16-max_decoder_steps:30-parity_mode:true]")
N_FRAMES = 21   # the stubbed acoustic model's mel length (padded to 64)
CLI_CONFIG = dict(resblock="1", upsample_rates=(8, 8, 4),
                  upsample_kernel_sizes=(16, 16, 8),
                  upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),), num_mels=8)


def test_cli_tflite_line_matches_the_g_file_line(tmp_path, monkeypatch):
    """One script line through the port's CLI with ``--hifigan-checkpoint
    x.tflite`` (exported from a g_ file at the bucket's 64 frames) and with
    the g_ file itself, the acoustic model stubbed to one fixed mel: the
    same vocoder output, the .tflite line scaled by 32768 and not
    denoised."""
    from tests.test_torch_text import LEXICON, RESOURCE_NAMES
    res = tmp_path / "res"
    res.mkdir()
    for n in RESOURCE_NAMES + ("small.lex",):
        (res / n).write_text(LEXICON, encoding="utf-8")
    monkeypatch.setenv("T2S_RESOURCES_DIR", str(res))
    (tmp_path / "ck" / "checkpoint_1").mkdir(parents=True)
    (tmp_path / "s.txt").write_text("u0|ba me em nam\n", encoding="utf-8")
    th = THG.HifiganConfig(**CLI_CONFIG)
    tp = THG.init_generator(torch.Generator().manual_seed(7), th,
                            device="cpu")
    tp = THG.fuse_generator(tp)
    for p in [tp["conv_pre"], tp["conv_post"], *tp["ups"]] + [
            c for rb in tp["resblocks"] for v in rb.values() for c in v]:
        p["w"] = p["w"] / p["w"].flatten(1).norm(dim=1).clamp_min(
            1e-12).reshape(-1, *[1] * (p["w"].dim() - 1))
    tp["conv_post"]["w"] = tp["conv_post"]["w"] * 0.1
    g = str(tmp_path / "g_00000001")
    torch.save({"generator": THG.export_torch_generator(tp)}, g)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        k: [list(x) for x in v] if k == "resblock_dilation_sizes"
        else list(v) if isinstance(v, tuple) else v
        for k, v in CLI_CONFIG.items()}))
    tfl = str(tmp_path / "g.tflite")
    TEX.main(["--out", tfl, "--checkpoint", g, "--config", str(cfg),
              "--frames", "64"])

    mel = (np.random.RandomState(8).randn(1, 8, N_FRAMES) - 2).astype(
        np.float32)
    monkeypatch.setattr(TI, "load_acoustic_model",
                        lambda ck, cfg, dev: (None, None))

    class PortModel:
        @staticmethod
        def infer(*a, **k):
            return {"mel_postnet": torch.from_numpy(mel),
                    "mel_lengths": torch.tensor([N_FRAMES]),
                    "infer_ok": torch.tensor([True]), "steps_run": N_FRAMES,
                    "alignments": torch.ones(1, N_FRAMES, 4) / 4,
                    "alignments_bert": torch.ones(1, N_FRAMES, 4) / 4}
    monkeypatch.setattr(TI, "M", PortModel)
    monkeypatch.setattr(TI, "save_plots", lambda *a: None)
    seen, vocoded = [], []
    real, real_voc = TI.synthesize_text, TI.vocode_bucketed
    monkeypatch.setattr(TI, "synthesize_text",
                        lambda syn, text: seen.append(real(syn, text))
                        or seen[-1])
    monkeypatch.setattr(TI, "vocode_bucketed",
                        lambda *a, **k: vocoded.append(real_voc(*a, **k))
                        or vocoded[-1])

    def argv(out, voc):
        return ["--script", str(tmp_path / "s.txt"), "--checkpoint-dir",
                str(tmp_path / "ck"), "--out-dir", str(tmp_path / out),
                "--g2p-lexicon", str(res / "small.lex"), "--hparams", HP,
                "--hifigan-checkpoint", voc, "--hifigan-config", str(cfg),
                "--device", "cpu"]
    assert TI.main(argv("tflite", tfl)) == 1
    assert TI.main(argv("g", g)) == 1
    wav_t, wav_g = vocoded[0][0], vocoded[1][0]
    assert wav_t.shape == wav_g.shape == (N_FRAMES * 256,)
    assert wav_g.abs().max() >= 0.1
    _close(wav_t.numpy(), wav_g.numpy(), "tflite line vs g_ line")
    sr, t = read(str(tmp_path / "tflite" / "audio" / "u0.wav"))
    assert sr == 22050 and t.shape == (N_FRAMES * 256,)
    np.testing.assert_allclose(seen[0]["wav"], wav_t.numpy() * 32768,
                               rtol=0, atol=1e-3)
    assert np.abs(t.astype(np.int32) - seen[0]["wav"]).max() <= 1
    assert "denoiser" not in seen[0]["times"]
    assert "denoiser" in seen[1]["times"]
