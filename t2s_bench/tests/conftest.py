"""A copy of the benchmark with a tiny twin of each cell, for the CPU tests.

Each cell of ``BENCHMARK.json`` has a twin file, ``tiny/<cell>.json``:

    twin      the tiny cell's name
    config    top-level keys of the cell's configuration that the twin
              replaces: the ``tacotron`` group and the vocoder part's group,
              each whole, at sizes that run on the CPU in seconds
    traffic   top-level keys of the cell's traffic mix that the twin
              replaces

The twin keeps the rest of the configuration (system adapter, reference,
vocoder part, precision, control) and the cell's limits, and reports the
per-layer metrics that its cell reports.  A new cell joins the CPU tests by
its twin file alone.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
TWINS = "tiny"


def twins(bench: Path) -> dict:
    """Every twin file under ``bench``: {cell: its contents}."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((bench / "tests" / TWINS).glob("*.json"))}


def write_twin(root: Path, cell: str, twin: dict) -> None:
    """The twin's configuration, mix and cell under ``root``, a copy of the
    benchmark that holds ``cell``."""
    name = twin["twin"]
    wl = json.loads((root / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((root / "configs" / f"{wl['config']}.json").read_text())
    cfg.update(twin["config"], name=name)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / f"{wl['traffic']}.json").read_text())
    mix.update(twin["traffic"])
    (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    wl.update(config=name, traffic=name, why=f"the tiny twin of {cell}")
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))


def copy_with_twins(bench: Path, dest: Path) -> Path:
    """A copy of the benchmark ``bench`` (its files and the
    ``BENCHMARK.json`` beside it) under ``dest``, with the twin of each cell
    that has a twin file, listed for the metrics its cell reports.
    Returns the copy's benchmark folder."""
    root = dest / "t2s_bench"
    shutil.copytree(bench, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    files = twins(bench)
    for cell, t in files.items():
        write_twin(root, cell, t)
    pairs = {cell: t["twin"] for cell, t in files.items()}
    manifest = json.loads((bench.parent / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        m["workloads"] += [pairs[w] for w in m["workloads"] if w in pairs]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of the benchmark's files and of ``BENCHMARK.json`` beside it,
    with a tiny twin of each cell (among them "tiny", SMA int8, and
    "tiny-lsa", LSA bf16), listed for the metrics their full cells
    report."""
    return copy_with_twins(BENCH, tmp_path)


@pytest.fixture
def twin_copy(tmp_path):
    """``copy_with_twins`` of another benchmark folder, into the test's
    ``tmp_path``."""
    def make(bench: Path) -> Path:
        dest = tmp_path / "twins"
        dest.mkdir()
        return copy_with_twins(bench, dest)
    return make
