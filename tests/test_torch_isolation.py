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
                 "data.dataset", "apps.train"):
        assert f"tacotron2_subword_tpu_torch.{name}" in mods


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
