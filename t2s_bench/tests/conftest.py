"""A copy of the benchmark with a tiny cell, for the CPU tests: the same
files, and a configuration, a traffic mix and a cell made small enough to
run on the CPU in seconds, with the limits of ``sma-v1.synth-b256``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent

TINY_TACOTRON = dict(
    n_symbols=20, sub_n_symbols=30, symbols_embedding_dim=16,
    encoder_embedding_dim=16, encoder_kernel_size=5, encoder_n_convolutions=3,
    bert_embedding_dim=8, attention="StepwiseMonotonicAttention",
    attention_rnn_dim=32, decoder_rnn_dim=32, attention_dim=8,
    attention_location_n_filters=4, attention_location_kernel_size=5,
    prenet_dim=8, n_mel_channels=8, n_frames_per_step=1,
    postnet_embedding_dim=16, postnet_kernel_size=5, postnet_n_convolutions=5,
    sampling_rate=22050, hop_length=256, max_decoder_steps=60,
    prenet_dropout_always_on=True, compute_dtype="bfloat16",
    decode_quant="int8")
TINY_HIFIGAN = dict(
    resblock="1", upsample_rates=[8, 8, 2, 2],
    upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=16,
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5]] * 3, num_mels=8,
    sampling_rate=22050)
TINY_MIX = dict(generator="synth_batches", batch=4, batches=2,
                seconds=dict(min=0.1, mean=0.3, max=0.55), symbols_per_s=15.196,
                subwords_per_s=2.621, gate_threshold=0.5, max_steps=60,
                check_batches=2, check_rows=3)


def write_tiny(root: Path, name: str = "tiny", attention: str =
               "StepwiseMonotonicAttention") -> None:
    """A tiny configuration, mix and cell named ``name`` under ``root``."""
    src = "sma" if attention.startswith("Stepwise") else "lsa"
    full = {"sma": ("t2s-sma-int8-hifigan-v1", "sma-v1.synth-b256"),
            "lsa": ("t2s-lsa-bf16-hifigan-v2", "lsa-v2.synth-b1024")}[src]
    cfg = json.loads((root / "configs" / f"{full[0]}.json").read_text())
    cfg.update(name=name, tacotron=dict(
        TINY_TACOTRON, attention=attention,
        decode_quant=cfg["tacotron"]["decode_quant"]), hifigan=TINY_HIFIGAN)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (root / "traffic" / f"{name}.json").write_text(json.dumps(TINY_MIX))
    wl = json.loads((root / "workloads" / f"{full[1]}.json").read_text())
    wl.update(config=name, traffic=name, why="a tiny cell for the CPU tests")
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of the benchmark's files and of ``BENCHMARK.json`` beside it,
    with the tiny cells "tiny" (SMA, int8) and "tiny-lsa" (LSA, bf16)
    listed for the metrics their full cells report."""
    root = tmp_path / "t2s_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    write_tiny(root)
    write_tiny(root, "tiny-lsa", "LocationSensitiveAttention")
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m["workloads"] += [{"sma-v1.synth-b256": "tiny",
                            "lsa-v2.synth-b1024": "tiny-lsa"}[w]
                           for w in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
