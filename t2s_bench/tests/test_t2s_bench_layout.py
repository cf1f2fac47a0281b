"""The harness finds each part by its name in BENCHMARK.json, and a cell, a
configuration (with its own vocoder, system adapter and reference) and a
per-layer metric are added as files alone."""

from __future__ import annotations

import hashlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from t2s_bench import layout, run as R

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "t2s_bench"
SEED = 2 ** 31 + 4242
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


def _check_manifest(repo: Path) -> None:
    """``BENCHMARK.json`` in ``repo`` against the files of its benchmark."""
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    root = repo / "t2s_bench"
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["t2s_bench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        f = json.loads((repo / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert c["file"] == f"t2s_bench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    cells = set()
    for w in bench["workloads"]:
        f = layout.workload(w["name"], root)
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs and len(w["why"]) <= 200
        layout.traffic(w["traffic"], root)
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    metrics = layout.metrics(root)
    assert {m["name"] for m in bench["per_layer"]} == set(metrics)
    for m in bench["per_layer"]:
        mod = metrics[m["name"]]
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    assert all(layout.cell_metrics(c, root) for c in cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((repo / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_benchmark_json_matches_its_files():
    _check_manifest(REPO)


def _twin_faults(bench: Path) -> list:
    """The cells of the ``BENCHMARK.json`` beside ``bench`` whose twin file
    is missing or does not fit the cell's configuration, with the
    reason."""
    manifest = json.loads((bench.parent / "BENCHMARK.json").read_text())
    files = {p.stem: json.loads(p.read_text())
             for p in (bench / "tests" / "tiny").glob("*.json")}
    names = [t["twin"] for t in files.values()]
    faults = [(c, "twin named twice") for c in files
              if names.count(files[c]["twin"]) > 1]
    for w in manifest["workloads"]:
        t = files.get(w["name"])
        if t is None:
            faults.append((w["name"], "no twin file"))
            continue
        cfg = layout.config(w["config"], bench)
        if not (NAME.match(t["twin"]) and set(t) == {"twin", "config",
                                                     "traffic"}):
            faults.append((w["name"], "twin file's keys"))
        elif not ({"tacotron", cfg["vocoder"]} <= set(t["config"])
                  <= set(cfg)):
            faults.append((w["name"], "config groups"))
        elif not set(t["traffic"]) <= set(layout.traffic(w["traffic"],
                                                         bench)):
            faults.append((w["name"], "traffic keys"))
    return faults


def test_every_cell_has_a_twin():
    """Each cell of BENCHMARK.json has a twin file (``tests/tiny/<cell>
    .json``) that shrinks its configuration's ``tacotron`` and vocoder
    groups and overrides only keys its configuration and mix have, so each
    cell runs in the CPU tests."""
    assert _twin_faults(BENCH) == []


@pytest.mark.parametrize("name, leaves, numel, digest", [
    ("t2s-sma-int8-hifigan-v1", 270, 65_813_346,
     "534f1355ed3ca98f28a638b7b7029138edf963150185df7598903b22b3dfbcbc"),
    ("t2s-lsa-bf16-hifigan-v2", 274, 52_825_474,
     "162d02119ce3b15b0730271071961f57a01565ee5333051a1425676d15bcab84")])
def test_full_configs_draw_the_same_leaves(name, leaves, numel, digest):
    """The leaves ``make_tree`` draws (names, shapes, bounds, in order) are
    those of the Tacotron 2 followed by the HiFi-GAN generator as they were
    drawn before the vocoder became a part, so one seed makes the same
    tree: the digest is of that list's ``repr``."""
    specs = R.tree_specs(layout.config(name))
    assert len(specs) == leaves
    assert sum(math.prod(shape) for _, shape, _, _ in specs) == numel
    assert hashlib.sha256(repr(specs).encode()).hexdigest() == digest
    assert [n for n, *_ in specs if n.startswith("gen.")] == [
        n for n, *_ in layout.vocoder("hifigan").specs(
            layout.config(name)["hifigan"])]


@pytest.mark.parametrize("file", ["run.py", "judge.py", "flops.py",
                                  "weights.py"])
def test_the_harness_names_no_vocoder(file):
    """The vocoder is the configuration's part: the files every
    configuration runs through name none."""
    text = (BENCH / file).read_text().lower()
    assert "hifigan" not in text and "hifi-gan" not in text


TOY_PART = '''"""A toy stochastic vocoder: each mel frame's ``hop`` samples are tanh
of a linear map of the frame, plus ``sigma`` N(0, 1) noise."""

import math


def specs(v):
    b = 1.0 / math.sqrt(v["num_mels"])
    return [("gen.proj.w", (v["num_mels"], v["hop"]), -b, b),
            ("gen.proj.b", (v["hop"],), -b, b)]


def frame_flops(v):
    return 2.0 * v["num_mels"] * v["hop"]
'''

TOY_SYSTEM = '''"""The program's decode, then the toy vocoder through the program's
bucketing, its noise drawn from the serving generator after the decode."""

import importlib

import torch

SPANS = ()
KERNELS = {}
FAULT = %r


def module(name):
    return importlib.import_module(name)


def counters():
    return {}


class System:
    def __init__(self, config, mix, tree, device):
        from tacotron2_subword_tpu_torch.config import TacotronConfig
        known = TacotronConfig.__dataclass_fields__
        self.cfg = TacotronConfig().replace(**{
            k: v for k, v in config["tacotron"].items() if k in known})
        self.v, self.mix, self.device = (config["toy_noise"], mix,
                                         torch.device(device))
        self.params, self.bn, self.gen = (tree["params"], tree["bn"],
                                          tree["gen"])

    @torch.inference_mode()
    def serve(self, requests, generator):
        from tacotron2_subword_tpu_torch.apps import inference as I
        from tacotron2_subword_tpu_torch.models import tacotron2 as M
        before = generator.get_state()
        text, sub, cls_p, cls_s, t_len, s_len = I.pad_requests(
            requests, self.device)
        out = M.infer(self.params, self.bn, self.cfg, text, sub, cls_p,
                      cls_s, generator=generator,
                      max_steps=self.mix["max_steps"],
                      gate_threshold=self.mix["gate_threshold"],
                      text_lengths=t_len, sub_lengths=s_len)
        g = generator
        if FAULT == "fresh":
            g = torch.Generator(device=self.device).manual_seed(0)
        elif FAULT == "early":      # one mask draw short of the decode's
            g = torch.Generator(device=self.device)
            g.set_state(before)
            for _ in range(out["steps_run"] - 1):
                torch.rand((4, len(requests), self.cfg.prenet_dim),
                           generator=g, device=self.device)
        p, v = self.gen["proj"], self.v

        def vocode(m):
            w = torch.tanh(torch.einsum("bmf,mh->bfh", m, p["w"]) + p["b"])
            w = w.reshape(m.shape[0], -1)
            return w + v["sigma"] * torch.randn(w.shape, generator=g,
                                                device=w.device)
        wavs = I.vocode_bucketed(vocode, out["mel_postnet"],
                                 out["mel_lengths"].tolist(),
                                 hop=self.cfg.hop_length)
        out["wavs"] = [torch.clamp(w * I.MAX_WAV_VALUE, -32768.0, 32767.0)
                       for w in wavs]
        return out
'''

TOY_REFERENCE = '''"""The plain reference of the toy configuration: the acoustic model of
``tacotron2_hifigan.py``, and the toy vocoder, whose one draw is
N(0, 1) [batch, frames * hop] from the serving generator after the decode,
of which the kept rows read theirs."""

from pathlib import Path

import torch

from t2s_bench import layout

_base = layout.module_from(Path(__file__).with_name("tacotron2_hifigan.py"))
Precision, encode, bucket = _base.Precision, _base.encode, _base.bucket
decode_teacher_forced, postnet = _base.decode_teacher_forced, _base.postnet


def vocode(G, cfg, mel, rows, batch, frames, prec, generator):
    v, p = cfg["toy_noise"], G["proj"]
    w = torch.tanh(torch.einsum("kmf,mh->kfh", mel, p["w"]) + p["b"])
    noise = torch.randn((batch, frames * v["hop"]), generator=generator(),
                        device=mel.device)
    idx = torch.as_tensor(rows, device=mel.device)
    return w.reshape(mel.shape[0], -1) + v["sigma"] * noise[idx]
'''


def _snapshot(root: Path) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def _add_toy(root: Path, fault) -> None:
    """A configuration "tiny-toy" whose vocoder is the toy, and its cell,
    written as new files only."""
    before = _snapshot(root)
    (root / "vocoders" / "toy_noise.py").write_text(TOY_PART)
    (root / "system" / "toy_noise.py").write_text(TOY_SYSTEM % fault)
    (root / "reference" / "toy_noise.py").write_text(TOY_REFERENCE)
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    del cfg["hifigan"]
    cfg.update(name="tiny-toy", system="toy_noise", reference="toy_noise",
               vocoder="toy_noise", toy_noise=dict(
                   num_mels=cfg["tacotron"]["n_mel_channels"],
                   hop=cfg["tacotron"]["hop_length"], sigma=0.1))
    (root / "configs" / "tiny-toy.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "tiny.json").read_text())
    (root / "workloads" / "tiny-toy.json").write_text(
        json.dumps(dict(wl, config="tiny-toy")))
    after = _snapshot(root)
    assert all(after[p] == b for p, b in before.items())
    assert len(after) == len(before) + 5


@pytest.mark.parametrize("fault", [None, "fresh", "early"])
def test_a_stochastic_vocoder_joins_as_files(bench_copy, fault):
    """A configuration with a vocoder that draws noise, added as new files
    alone, runs through the harness on the CPU: correct where the noise
    follows the decode's last mask draw on the serving generator, and
    caught by ``wav_gap`` alone where it comes from a fresh generator or
    from one mask draw early."""
    _add_toy(bench_copy, fault)
    res = R.run(layout.cell("tiny-toy", bench_copy), SEED, 0.0, False,
                device="cpu", root=bench_copy)
    checks = res["checks"]
    if fault is None:
        assert res["correct"], checks
    else:
        assert not res["correct"]
        assert [k for k, c in checks.items()
                if not c["value"] <= c["limit"]] == ["wav_gap"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "early"])
def test_a_stochastic_vocoder_on_card(bench_copy, fault):
    """As above on the card, where the decode runs as CUDA graph replays
    that hand the serving generator back past their mask draws."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _add_toy(bench_copy, fault)
    res = R.run(layout.cell("tiny-toy", bench_copy), SEED, 0.5, False,
                root=bench_copy)
    assert res["correct"] is (fault is None), res["checks"]


TOY_METRIC = '''"""The frames the vocoder ran in the traced run's window,
padding included: the program's ``vocoder.frames_run`` counter."""

LAYER = "vocoder"
UNIT = "frames"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "audio_s_per_s"


def read(obs):
    prog = obs.get("program")
    if not prog or not prog["window"]:
        return None
    return float(prog["window"][1].get("vocoder.frames_run", 0)) or None
'''


def test_a_configuration_joins_as_files_with_its_twin(tmp_path, twin_copy):
    """A third configuration (the toy vocoder behind the SMA int8 model,
    with a system adapter that has a ``_trace`` file), its cell, its twin
    file and a metric that reads a program counter, written into a copy of
    the benchmark as new files and ``BENCHMARK.json`` entries alone: the
    manifest holds, every cell has a twin, and the twin's traced run on
    the CPU is correct and reports the metric."""
    src = tmp_path / "src"
    shutil.copytree(BENCH, src / "t2s_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", src / "BENCHMARK.json")
    root = src / "t2s_bench"
    before = _snapshot(root)
    cell, cfg_name = "sma-toy.synth-b256", "t2s-sma-int8-toy"
    (root / "vocoders" / "toy_noise.py").write_text(TOY_PART)
    (root / "system" / "toy_noise.py").write_text(TOY_SYSTEM % None)
    (root / "system" / "toy_noise_trace.py").write_text(
        (root / "system" / "synthesize_trace.py").read_text())
    (root / "reference" / "toy_noise.py").write_text(TOY_REFERENCE)
    cfg = layout.config("t2s-sma-int8-hifigan-v1", root)
    del cfg["hifigan"]
    cfg.update(name=cfg_name, system="toy_noise", reference="toy_noise",
               vocoder="toy_noise", toy_noise=dict(num_mels=80, hop=256,
                                                   sigma=0.1))
    (root / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
    wl = dict(layout.workload("sma-v1.synth-b256", root), config=cfg_name,
              why="the toy vocoder behind the int8 SMA model")
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    sma = json.loads((root / "tests" / "tiny" / "sma-v1.synth-b256.json")
                     .read_text())
    (root / "tests" / "tiny" / f"{cell}.json").write_text(json.dumps({
        "twin": "tiny-toy", "traffic": sma["traffic"],
        "config": {"tacotron": sma["config"]["tacotron"],
                   "toy_noise": dict(num_mels=8, hop=256, sigma=0.1)}}))
    (root / "metrics" / "vocoder_frames_run.toy.py").write_text(TOY_METRIC)
    manifest = json.loads((src / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": cfg_name, "source": "a toy vocoder of the tests",
        "file": f"t2s_bench/configs/{cfg_name}.json", "reduced": [],
        "why": "a vocoder that draws noise, with the program's tracing"})
    manifest["workloads"].append({
        "name": cell, "config": cfg_name, "traffic": "synth-b256",
        "chips": 1, "why": wl["why"]})
    manifest["per_layer"].append({
        "name": "vocoder_frames_run.toy", "unit": "frames",
        "better": "lower", "source": "program_counter", "layer": "vocoder",
        "moves": "audio_s_per_s", "workloads": [cell]})
    (src / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _snapshot(root)
    assert all(after[p] == b for p, b in before.items())
    assert len(after) == len(before) + 8
    _check_manifest(src)
    assert _twin_faults(root) == []

    tiny = twin_copy(root)
    assert layout.cell_metrics("tiny-toy", tiny) == [
        "vocoder_frames_run.toy"]
    res = R.run(layout.cell("tiny-toy", tiny), SEED, 0.0, True,
                device="cpu", root=tiny)
    assert res["correct"], res["checks"]
    frames = res["metrics"]["vocoder_frames_run.toy"]["value"]
    counters = res["obs"]["program"]["window"][1]
    assert frames == counters["vocoder.frames_run"]
    assert frames >= res["attempted"] * 8
