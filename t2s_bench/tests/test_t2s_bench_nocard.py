"""The measurement path fails, and does not fall back to the CPU, where
it finds no card; it fails too in a checkout without the program."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from t2s_bench import layout, run as R


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "sma-v1.synth-b256", "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(R.NoCard):
        R.run(layout.cell("sma-v1.synth-b256"), 1, 1.0, False)


def test_without_the_program(bench_copy, tmp_path):
    """A directory with only the benchmark's files: the run fails before
    any result (the program cannot be imported)."""
    (tmp_path / "BENCHMARK.json").write_text("{}")
    code = ("import sys; from t2s_bench import layout, run as R; "
            "R.run(layout.cell('tiny'), 1, 0.0, False, device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "tacotron2_subword_tpu_torch" in p.stderr
    shutil.rmtree(bench_copy)
