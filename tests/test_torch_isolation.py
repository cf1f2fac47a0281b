"""The port stands alone: importing every module of
tacotron2_subword_tpu_torch loads neither JAX nor the JAX package."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import tacotron2_subword_tpu_torch as port
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="tacotron2_subword_tpu_torch."))


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("config", "ops.quant", "nn.layers", "models.attention",
                 "models.tacotron2", "models.hifigan", "utils.import_jax",
                 "apps.inference", "ops.softdtw", "train_lib",
                 "data.dataset", "apps.train",
                 "text", "text.lexicon", "text.fst_g2p", "text.g2p",
                 "text.text_to_sequence", "text.bert", "ops.stft",
                 "models.denoiser", "utils.import_torch", "utils.checkpoint",
                 "utils.logging_utils", "ops.ssim", "eval", "eval.metrics",
                 "apps.gta", "apps.train_hifigan", "apps.best_checkpoint",
                 "apps.evaluation", "apps.remove_silence", "utils.audio",
                 "models.waveglow", "apps.train_waveglow", "utils.onnx_lite",
                 "models.vocoder_runtimes", "tools.export_hifigan_onnx",
                 "apps.preprocess", "apps.demo", "apps.check_bert_emb",
                 "apps.dump_phone_id_map", "parallel", "parallel.mesh",
                 "tools.make_synthetic_dataset", "tools.train_tokenizer",
                 "tools.eval_synthetic", "tools.gan_batch_scaling",
                 "bench", "utils.xprof", "tools.train_step_profile",
                 "tools.serving_latency", "tools.kernel_evidence",
                 "tools.gta_vocoder_smoke", "tools.infer_wav_demo",
                 "utils.tflite_lite", "tools.export_hifigan_tflite",
                 "utils.loss_scaler"):
        assert f"tacotron2_subword_tpu_torch.{name}" in mods
    # the G2P engine is built from the port's own copy of the C++ source,
    # check_bert_emb's default tokenizer is the port's own copy of the asset
    assert (ROOT / "tacotron2_subword_tpu_torch" / "native"
            / "g2p_fst.cpp").is_file()
    assert (ROOT / "tacotron2_subword_tpu_torch" / "assets"
            / "vibert_512.json").is_file()


@pytest.mark.parametrize("module,lazy", [
    ("text.g2p", "yaml"), ("utils.logging_utils", "matplotlib"),
    ("utils.logging_utils", "tensorboardX"), ("text.bert", "tokenizers"),
    ("text.bert", "transformers"), ("models.vocoder_runtimes", "tensorflow"),
    ("apps.check_bert_emb", "tokenizers"), ("apps.demo", "streamlit"),
    ("tools.train_tokenizer", "tokenizers"),
    ("utils.xprof", "torch.profiler")])
def test_optional_packages_load_only_when_used(module, lazy):
    """The card's machine may lack PyYAML, matplotlib, tensorboardX,
    tokenizers, transformers, tensorflow and streamlit: importing the
    modules that use them loads none of them.  ``utils.xprof`` loads
    torch's profiler only when it reads a trace."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('tacotron2_subword_tpu_torch.{module}')\n"
        f"print({lazy!r} in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "False"


@pytest.mark.parametrize("banned", ["jax", "tacotron2_subword_tpu"])
def test_port_imports_no_jax(banned):
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"b = {banned!r}\n"
        "print(json.dumps(sorted(n for n in sys.modules\n"
        "                        if n == b or n.startswith(b + '.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("banned", ["tensorflow", "flatbuffers"])
@pytest.mark.parametrize("module", ["models.vocoder_runtimes",
                                    "utils.tflite_lite",
                                    "tools.export_hifigan_tflite"])
def test_tflite_path_loads_no_tensorflow(tmp_path, module, banned):
    """The card's machine has neither tensorflow nor flatbuffers: importing
    the TFLite modules, writing a file and running it loads neither."""
    code = (
        "import importlib, sys, torch\n"
        f"importlib.import_module('tacotron2_subword_tpu_torch.{module}')\n"
        "from tacotron2_subword_tpu_torch.models import hifigan as HG\n"
        "from tacotron2_subword_tpu_torch.models import vocoder_runtimes\n"
        "from tacotron2_subword_tpu_torch.tools import "
        "export_hifigan_tflite as EX\n"
        "h = HG.HifiganConfig(resblock='2', upsample_rates=(2,), "
        "upsample_kernel_sizes=(4,), upsample_initial_channel=4, "
        "resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),), "
        "num_mels=4)\n"
        "p = HG.init_generator(torch.Generator().manual_seed(0), h, 'cpu')\n"
        f"EX.export_tflite(p, h, {str(tmp_path / 'g.tflite')!r}, frames=8)\n"
        "voc = vocoder_runtimes.load_tflite_vocoder("
        f"{str(tmp_path / 'g.tflite')!r}, 'cpu')\n"
        "assert voc(torch.zeros(1, 4, 8)).shape == (1, 16)\n"
        f"print({banned!r} in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "False"
