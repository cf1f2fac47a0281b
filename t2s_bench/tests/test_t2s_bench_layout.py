"""The harness finds each part by its name in BENCHMARK.json, and a cell, a
configuration and a per-layer metric are added as files alone."""

from __future__ import annotations

import json
import re
from pathlib import Path

from t2s_bench import layout

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_added_files_are_found(bench_copy):
    cfg = json.loads((bench_copy / "configs" / "tiny.json").read_text())
    (bench_copy / "configs" / "tiny-2.json").write_text(
        json.dumps(dict(cfg, name="tiny-2")))
    (bench_copy / "traffic" / "tiny-2.json").write_text(
        (bench_copy / "traffic" / "tiny.json").read_text())
    wl = json.loads((bench_copy / "workloads" / "tiny.json").read_text())
    (bench_copy / "workloads" / "tiny-2.cell.json").write_text(
        json.dumps(dict(wl, config="tiny-2", traffic="tiny-2")))
    (bench_copy / "metrics" / "extra_ms.synth.py").write_text(
        'LAYER = "vocoder"\nUNIT = "ms"\nBETTER = "lower"\n'
        'SOURCE = "program_span"\nMOVES = "audio_s_per_s"\n\n\n'
        'def read(obs):\n    return 1.0\n')
    manifest = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(manifest.read_text())
    bench["per_layer"].append({
        "name": "extra_ms.synth", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "vocoder",
        "moves": "audio_s_per_s", "workloads": ["tiny-2.cell"]})
    manifest.write_text(json.dumps(bench))
    cell = layout.cell("tiny-2.cell", bench_copy)
    assert cell["config"]["name"] == "tiny-2"
    assert cell["mix"]["generator"] == "synth_batches"
    assert layout.generator(cell["mix"]["generator"], bench_copy).make
    metrics = layout.metrics(bench_copy)
    assert metrics["extra_ms.synth"].read({}) == 1.0
    assert set(layout.metrics()) < set(metrics)
    assert layout.cell_metrics("tiny-2.cell", bench_copy) == [
        "extra_ms.synth"]
    assert "k1_roofline.synth" in layout.cell_metrics("tiny", bench_copy)
    assert "k1_roofline.synth" not in layout.cell_metrics("tiny-lsa",
                                                          bench_copy)


def test_benchmark_json_matches_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["t2s_bench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert c["file"] == f"t2s_bench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = set()
    for w in bench["workloads"]:
        f = layout.workload(w["name"])
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs and len(w["why"]) <= 200
        layout.traffic(w["traffic"])
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    metrics = layout.metrics()
    assert {m["name"] for m in bench["per_layer"]} == set(metrics)
    for m in bench["per_layer"]:
        mod = metrics[m["name"]]
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    assert all(layout.cell_metrics(c) for c in cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024
