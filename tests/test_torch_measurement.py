"""The port's measurement layer against the JAX package's, on the CPU.

- ``utils/xprof``: the synthetic xplane of ``tests/test_tools.py`` read by
  the JAX ``parse_xplane_ops``, and the same durations given as serial
  device intervals to the port's row helper: the same rows and counts, the
  port's busy time the ops' sum and its span the 'XLA Modules' time, to
  1e-9.  Overlapping intervals count once in busy time.
- ``bench``: the port's ``_build_infer`` inputs bit-equal to the root
  bench.py's (read from the closure of its ``make_jfn``), the
  ``run_train`` batch equal to the one bench.py gives its jitted step
  (both captured at a small config and t_out=16), and the two mains'
  JSON key sets equal but for ``infer_device_busy_share`` and ``gpu``
  (the ``run_*`` functions and the probe subprocess stubbed).
- ``tools/train_step_profile``: ``categorize`` on synthetic CUDA kernel
  names, every category hit once; the tool at a small config on the CPU
  (no device activity: "not measured").
- The traces: ``xprof.marked_window`` splits rows at the markers, and
  the bench retakes a window whose calls hold unequal record counts.
"""

import dataclasses
import importlib.util
import inspect
import json
import subprocess
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tacotron2_subword_tpu.utils import xprof as JX
from tacotron2_subword_tpu_torch import bench as PB
from tacotron2_subword_tpu_torch import config as PC
from tacotron2_subword_tpu_torch import train_lib as PT
from tacotron2_subword_tpu_torch.tools import train_step_profile as TSP
from tacotron2_subword_tpu_torch.utils import xprof as PX
from tests.test_model import SMALL
from tests.test_tools import _write_synthetic_xplane
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# the architecture of tests.test_model.SMALL with the vocabulary, mel and
# [CLS] sizes the bench draws its inputs from left at their defaults
ARCH = {k: v for k, v in dataclasses.asdict(SMALL).items()
        if k in ("symbols_embedding_dim", "encoder_embedding_dim",
                 "attention_rnn_dim", "attention_dim", "decoder_rnn_dim",
                 "prenet_dim", "postnet_embedding_dim",
                 "attention_location_n_filters",
                 "attention_location_kernel_size")}
SMALL_FIELDS = {f.name: getattr(SMALL, f.name)
                for f in dataclasses.fields(SMALL)
                if f.name in {g.name for g in dataclasses.fields(
                    PC.TacotronConfig)}}


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_xprof_matches_jax_parse(tmp_path):
    _write_synthetic_xplane(str(tmp_path))
    ops_j, module_ms = JX.parse_xplane_ops(str(tmp_path))
    # the xplane's ops, in order, as serial device intervals; one idle gap
    # makes the span the 'XLA Modules' time
    durs = [("fusion.1", 2.0), ("dot.7", 5.0), ("copy.2", 1.0),
            ("dynamic-update-slice.3", 0.5), ("fusion.1", 3.0)]
    total = sum(d for _, d in durs)
    gap_us = (module_ms - total) * 1e3
    rows, t = [], 100.0
    for k, (name, ms) in enumerate(durs):
        rows.append((name, t, ms * 1e3))
        t += ms * 1e3 + (gap_us if k == 1 else 0.0)
    s = PX.summarize_rows(rows)
    assert [(n, k) for n, _, k in s.ops] == [(n, k) for n, _, k in ops_j]
    for (n, ms, _), (nj, msj, _) in zip(s.ops, ops_j):
        assert n == nj and abs(ms - msj) <= 1e-9
    assert abs(s.busy_ms - sum(ms for _, ms, _ in ops_j)) <= 1e-9
    assert abs(s.span_ms - module_ms) <= 1e-9
    assert s.n_events == sum(n for _, _, n in ops_j) == 5


def test_xprof_overlap_is_a_union():
    # a copy beside a kernel, a nested kernel, and a later one after a gap
    rows = [("gemm", 0.0, 1000.0), ("Memcpy HtoD", 400.0, 1000.0),
            ("elementwise", 500.0, 100.0), ("gemm", 3000.0, 250.0)]
    s = PX.summarize_rows(rows)
    assert s.busy_ms == pytest.approx(1.4 + 0.25, abs=1e-9)
    assert s.span_ms == pytest.approx(3.25, abs=1e-9)
    assert sum(ms for _, ms, _ in s.ops) == pytest.approx(2.35, abs=1e-9)
    assert s.ops[0] == ("gemm", pytest.approx(1.25), 2)
    assert PX.summarize_rows([]) == PX.DeviceProfile([], 0.0, 0.0, 0)


def test_xprof_reads_a_cpu_profile():
    """A trace without CUDA activity holds no device rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert PX.device_rows(prof) == []
    assert PX.parse_profile_ops(prof) == ([], 0.0)
    assert PX.device_busy_ms(prof) == 0.0


def test_bench_inputs_bit_equal(jax_bench, monkeypatch):
    import tacotron2_subword_tpu.config as JC
    real = JC.TacotronConfig
    monkeypatch.setattr(JC, "TacotronConfig",
                        lambda **kw: real(**{**ARCH, **kw}))
    _cfg_j, make_jfn = jax_bench._build_infer("cpu", 3)
    ref = inspect.getclosurevars(make_jfn).nonlocals
    cfg_p, make_fn = PB._build_infer("cpu", 3,
                                     PC.TacotronConfig(**ARCH))
    got = inspect.getclosurevars(make_fn).nonlocals
    for k in ("text", "sub", "cls_p", "cls_s"):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
        assert np.array_equal(a, b) and (a.dtype.kind != "f"
                                         or a.tobytes() == b.tobytes())
    # the port's decode runs on those inputs
    out = make_fn(3)(1)
    assert out.shape == () and torch.isfinite(out)
    res = PB.run_infer("cpu", 2, 3, repeats=2, cfg=cfg_p)
    assert set(res) == {"audio_per_s_wall", "us_per_step_wall", "dt_wall"}


def test_bench_train_batch_equal(jax_bench, monkeypatch):
    captured = {}

    def fake_jit(fn, **kw):
        def step(state, batch, key, cfg, tx):
            captured.setdefault("jax", batch)
            return state, {"total": np.float32(0.0)}
        return step
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", fake_jit)
        jax_bench.run_train(3, t_out=16, repeats=1, **SMALL_FIELDS)

    def fake_step(state, batch, cfg, tx, generator=None):
        captured.setdefault("port", batch)
        return state, {"total": torch.tensor(0.0)}
    monkeypatch.setattr(PT, "train_step", fake_step)
    PB.run_train(3, t_out=16, repeats=1, device="cpu", **SMALL_FIELDS)
    ref, got = captured["jax"], captured["port"]
    assert set(ref) == set(got)
    for k in ref:
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.shape == b.shape and np.array_equal(a, b), k
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _stub_runs(mod, monkeypatch, capsys):
    """Run ``mod.main`` with its run_* functions and the probe subprocess
    stubbed; returns its JSON line."""
    infer = {"audio_per_s_device": 10.0, "us_per_step_device": 1.0,
             "audio_per_s_wall": 1.0, "us_per_step_wall": 10.0,
             "wall_window_min_s": 1.0, "wall_window_max_s": 1.1,
             "device_busy_share": 0.1}
    monkeypatch.setattr(mod, "run_infer", lambda *a, **k: infer)
    monkeypatch.setattr(mod, "run_train", lambda *a, **k: (1.0, 2.0))
    monkeypatch.setattr(mod, "run_mel_extraction", lambda *a, **k: {
        "audio_per_s_device": 1.0, "us_per_frame_device": 1.0,
        "audio_per_s_wall": 1.0, "batch": 64, "samples": 66048})
    monkeypatch.setattr(mod, "run_vocoders", lambda *a, **k: {
        "hifi_f32": 1.0, "hifi_bf16": 1.0, "wg_f32": 1.0, "wg_bf16": 1.0})
    probe = json.dumps({"cpu_audio_per_s_slope": 2.0,
                        "t_probe_s": [[0.1, 0.9]]})
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=probe + "\n"))
    capsys.readouterr()
    mod.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_json_keys_match(jax_bench, monkeypatch, capsys):
    ref = _stub_runs(jax_bench, monkeypatch, capsys)
    monkeypatch.setattr(PB, "gpu_name_and_power",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    got = _stub_runs(PB, monkeypatch, capsys)
    assert set(got) == set(ref)
    assert set(got["extra"]) == set(ref["extra"]) | {
        "infer_device_busy_share", "gpu"}
    assert got["value"] == 10.0 and got["vs_baseline"] == 5.0
    assert "CUDA busy time (union of kernel intervals)" in got["metric"]
    assert "TF32" in got["metric"]


def test_categorize_hits_every_category():
    names = {
        "K1 int8 dequant matmul (hand-written)":
            "void dequant_int8_matmul_tc_kernel<64>(CUtensorMap, ...)",
        "K2 soft-DTW value + grad (hand-written)":
            "softdtw_grad_kernel(float const*, float*, float*, int)",
        "K3 soft-DTW value (hand-written)":
            "softdtw_fwd_kernel(float const*, float*, float*, int, int)",
        "NCCL collectives":
            "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
        "RNG": "void at::native::(anonymous namespace)::"
               "distribution_elementwise_grid_stride_kernel<float, 4>",
        "index / gather / scatter":
            "void at::native::index_elementwise_kernel<128, 4>",
        "copies / transposes": "Memcpy HtoD (Pageable -> Device)",
        "GEMM / convolution (cuBLAS, cuDNN)":
            "nvjet_tst_128x64_64x4_1x2_h_bz_coopA_NNT",
        "elementwise / reduce": "void at::native::reduce_kernel<512, 1>",
    }
    assert set(names) == {c for c, _ in TSP.CATEGORIES}
    ops = [(n, 1.0 + i, 1) for i, n in enumerate(names.values())]
    ops.append(("some_unknown_kernel", 0.25, 3))
    cats = TSP.categorize(ops)
    for i, (cat, n) in enumerate(names.items()):
        assert TSP.category(n) == cat
        assert cats[cat] == 1.0 + i
    assert cats["other"] == 0.25
    text, row = TSP.report("t", PX.summarize_rows(
        [(n, 10.0 * i, 5.0) for i, (n, _, _) in enumerate(ops)]),
        1e-3, 1, "us/step", 1e3, 5)
    assert "other, largest: some_unknown_kernel x1" in text
    assert row["launches"] == len(ops)


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_train_step_profile_on_cpu(mode, monkeypatch, capsys):
    hp = "[" + "-".join(f"{k}:{v}" for k, v in ARCH.items()) + "]"
    if mode == "train":
        monkeypatch.setattr(PB, "TacotronConfig",
                            lambda **kw: PC.TacotronConfig(**ARCH, **kw))
        argv = ["--batch", "2", "--t-out", "16", "--steps", "2",
                "--softdtw"]
    else:
        argv = ["--infer", "--batch", "2", "--infer-steps", "20",
                "--hparams", hp]
    row = TSP.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "not measured" in out and row["busy_ms"] is None
    assert row["launches"] == 0 and row["wall_ms"] > 0
    assert set(row["categories_ms"]) == {c for c, _ in TSP.CATEGORIES} | {
        "other"}
    if mode == "infer":
        assert row["slope"] == {"launches_per_step": 0.0,
                                "busy_us_per_step": None}


@pytest.mark.parametrize("tracer", ["train_step_profile", "bench"])
def test_card_traces_read_the_device_profile(tracer, monkeypatch):
    """On the card, the tools trace under ``xprof.device_profile`` (a
    context manager that yields the profile): here a CPU profile stands in
    for it, the CUDA sync and the bench's marker are no-ops, and the
    bench's device rows are one record between two markers."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def fake_device_profile():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof
    monkeypatch.setattr(PX, "device_profile", fake_device_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    card = types.SimpleNamespace(type="cuda")
    if tracer == "train_step_profile":
        s, wall = TSP._trace(lambda: torch.ones(4).sum(), card)
        assert s == PX.DeviceProfile([], 0.0, 0.0, 0) and wall > 0
    else:
        monkeypatch.setattr(PX, "mark", lambda: None)
        monkeypatch.setattr(PX, "device_rows", lambda prof, markers: [
            (PX.SENTINEL, 0.0, 1.0), ("k", 2.0, 3.0), (PX.SENTINEL, 6.0, 1.0)])
        tr = PB._traced([lambda: torch.ones(4).sum()], card)
        assert tr["busy_ms"] == pytest.approx(3e-3) and tr["attempts"] == 1
        assert tr["kernel_launches"] == tr["launches_per_call"] == 1
        assert tr["wall_s"] > 0 and tr["parse_s"] >= 0


def test_xprof_marked_window():
    """The last n + 1 markers in time order bound n calls: the rows
    between each two, and the window's rows from the first of them on."""
    m = PX.SENTINEL
    rows = [("copy", 99.0, 1.0), ("a", 3.0, 1.0), (m, 10.0, 1.0),
            ("pre", 0.0, 1.0), (m, 1.0, 1.0), ("b", 5.0, 1.0),
            ("c", 12.0, 1.0), (m, 20.0, 1.0), (m, -5.0, 1.0)]
    counts, window = PX.marked_window(rows, 2)
    assert counts == [2, 1]
    assert [r[0] for r in window] == ["a", "b", "c", "copy"]
    counts, window = PX.marked_window(rows, 1)
    assert counts == [1] and [r[0] for r in window] == ["c", "copy"]
    assert PX.marked_window(rows, 4) == ([], [])
    assert PX.marked_window([("a", 0.0, 1.0)], 1) == ([], [])


@pytest.mark.parametrize("lossy", [1, PB.TRACE_ATTEMPTS])
def test_bench_retraces_a_window_that_lost_records(lossy, monkeypatch):
    """A trace of two identical calls in which one call lost a record is
    taken again; after TRACE_ATTEMPTS such traces the bench fails."""
    import contextlib
    m = PX.SENTINEL
    # a sentinel, a marker, two calls of two records, each followed by a
    # marker, and the window's copy of the outputs
    full = [(m, -2.0, 1.0), (m, 0.0, 1.0), ("k", 2.0, 1.0), ("k", 4.0, 1.0),
            (m, 6.0, 1.0), ("k", 8.0, 1.0), ("k", 10.0, 1.0), (m, 12.0, 1.0),
            ("copy", 14.0, 1.0)]
    lost = [r for r in full if r[1] != 4.0]
    traces = [lost] * lossy + [full]
    monkeypatch.setattr(PX, "device_profile", contextlib.nullcontext)
    monkeypatch.setattr(PX, "mark", lambda: None)
    monkeypatch.setattr(PX, "device_rows", lambda prof, markers: traces.pop(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    card = types.SimpleNamespace(type="cuda")
    calls = [lambda: torch.ones(4).sum()] * 2
    if lossy < PB.TRACE_ATTEMPTS:
        tr = PB._traced(calls, card)
        assert tr["attempts"] == lossy + 1 and tr["launches_per_call"] == 2
        assert tr["kernel_launches"] == 5
        assert tr["busy_ms"] == pytest.approx(5e-3)
    else:
        with pytest.raises(RuntimeError, match="lost device records"):
            PB._traced(calls, card)
