"""The port stands alone: importing every module of
tacotron2_subword_tpu_torch loads neither JAX nor the JAX package."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import tacotron2_subword_tpu_torch as port

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
                 "tools.eval_synthetic", "tools.gan_batch_scaling"):
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
    ("tools.train_tokenizer", "tokenizers")])
def test_optional_packages_load_only_when_used(module, lazy):
    """The card's machine may lack PyYAML, matplotlib, tensorboardX,
    tokenizers, transformers, tensorflow and streamlit: importing the
    modules that use them loads none of them."""
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
