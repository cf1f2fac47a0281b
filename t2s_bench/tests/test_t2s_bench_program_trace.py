"""The reading of the program's own spans and counters: device rows and
idle gaps put down to spans by their launch records, the per-layer
readers on synthetic records, a tiny cell's run with the program's
tracing on (CPU), and the shared clock of spans and launch records (on a
card)."""

from __future__ import annotations

import pytest
import torch

import numpy as np

from t2s_bench import attribution as A, judge, layout, program_trace as PT
from t2s_bench import run as R
from t2s_bench.frozen import xprof

SEED = 2 ** 31 + 77

US = 1000    # ns

# spans: serve (0-1000 us) > decode.loop (100-600) > decode.sync (400-500);
# vocode (700-900)
SPANS = [("serve", None, 0, 1000 * US), ("decode.loop", 0, 100 * US, 600 * US),
         ("decode.sync", 1, 400 * US, 500 * US),
         ("serve.vocode", 0, 700 * US, 900 * US)]


def _rows():
    # (row, launch): rows launched in the loop while the device is idle
    # (host-bound gaps); one queued behind the row before it (a 2-us gap:
    # latency); one launched in the sync span; a vocoder row launched late;
    # one launched after every span (the harness)
    return [(A.Row("a", 150 * US, 200 * US, 1), 110 * US),
            (A.Row("b", 300 * US, 350 * US, 2), 250 * US),  # gap 100
            (A.Row("c", 352 * US, 420 * US, 3), 320 * US),  # gap 2, queued
            (A.Row("d", 450 * US, 460 * US, 4), 430 * US),  # gap 30, sync
            (A.Row("e", 800 * US, 880 * US, 5), 760 * US),  # gap 340
            (A.Row("f", 1100 * US, 1110 * US, 6), 1050 * US)]  # gap 220


def test_rows_and_gaps_go_to_the_span_that_launched_them():
    rows = [r for r, _ in _rows()]
    launches = {r.corr: at for r, at in _rows()}
    a = A.attribute(rows[::-1], launches, SPANS)
    assert a.route == "launch" and a.matched == 1.0
    assert [r.name for r in a.rows] == list("abcdef")
    assert [A.label(SPANS, s) for s in a.span] == [
        "decode.loop", "decode.loop", "decode.loop", "decode.sync",
        "serve.vocode", A.OUTSIDE]
    assert a.host_bound_s == pytest.approx({
        "decode.loop": 100e-6, "decode.sync": 30e-6,
        "serve.vocode": 340e-6, A.OUTSIDE: 220e-6})
    assert a.latency_s == pytest.approx({"decode.loop": 2e-6})
    assert A.within(SPANS, 2, "decode.loop")
    assert not A.within(SPANS, 3, "decode.loop")
    assert not A.within(SPANS, None, "decode.loop")


@pytest.mark.parametrize("gap_us, host_bound", [
    (A.QUEUED_GAP_NS / US - 1, False), (A.QUEUED_GAP_NS / US + 1, True)])
def test_a_gap_is_host_bound_when_longer_than_a_queued_rows(gap_us,
                                                            host_bound):
    # the launch records put both launches before the first row ended,
    # as clocks that disagree can: the device's gap decides
    first = A.Row("x", 0, 10 * US, 1)
    second = A.Row("y", int((10 + gap_us) * US), 40 * US, 2)
    a = A.attribute([first, second], {1: 0, 2: 5 * US}, SPANS[:1])
    assert bool(a.host_bound_s) is host_bound
    assert bool(a.latency_s) is not host_bound


def test_rows_without_launch_records_take_their_start_less_the_offset():
    rows = [r for r, _ in _rows()]
    launches = {r.corr: at for r, at in _rows() if r.name != "d"}
    a = A.attribute(rows, launches, SPANS, offset_ns=60 * US)
    assert a.route == "device_start" and a.matched == pytest.approx(5 / 6)
    # launched at 450 - 60 us: inside the loop, outside its sync span
    assert a.launch_ns[3] == 390 * US
    assert A.label(SPANS, a.span[3]) == "decode.loop"
    assert a.host_bound_s["decode.loop"] == pytest.approx(130e-6)
    assert "decode.sync" not in a.host_bound_s


def test_gaps_by_length_and_by_tenth():
    rows = [r for r, _ in _rows()]
    launches = {r.corr: at for r, at in _rows()}
    g = PT.gaps(A.attribute(rows, launches, SPANS), parts=2)
    # gaps of 100, 2, 30 us, then 340, 220 us
    assert g["hist"] == [0, 0, 1, 0, 0, 0, 0, 4]
    assert g["leads"] == [[3, 20.0, 32.0, 30.0], [2, 40.0, 50.0, 340.0]]
    assert PT.gaps(A.attribute([], {}, SPANS)) == {"leads": [],
                                                   "hist": [0] * 8}


def test_innermost_follows_nesting():
    times = [t * US for t in (50, 150, 450, 550, 650, 800, 2000, 0)]
    assert A.innermost(times, SPANS) == [0, 1, 2, 1, 0, 3, None, 0]
    assert A.busy_ns([A.Row("x", 0, 10, 0), A.Row("y", 5, 20, 0),
                      A.Row("z", 30, 35, 0)]) == 25


def test_host_calls_by_span():
    calls = [A.Row("cudaLaunchKernel", 110 * US, 120 * US, 1),
             A.Row("cudaLaunchKernel", 250 * US, 290 * US, 2),
             A.Row("cudaMemcpyAsync", 420 * US, 480 * US, 3),
             A.Row("cudaLaunchKernel", 1050 * US, 1051 * US, 4)]
    assert A.host_calls(calls, SPANS) == [
        ["decode.sync", "cudaMemcpyAsync", 1, 60e-6],
        ["decode.loop", "cudaLaunchKernel", 2, 50e-6],
        [A.OUTSIDE, "cudaLaunchKernel", 1, 1e-6]]
    assert A.host_calls(calls, SPANS, top=1) == [
        ["decode.sync", "cudaMemcpyAsync", 1, 60e-6]]


def _obs():
    rows = [r for r, _ in _rows()]
    launches = {r.corr: at for r, at in _rows()}
    counters = {"decode.steps": 4, "decode.row_steps": 40,
                "decode.live_row_steps": 26, "vocoder.frames_run": 256,
                "vocoder.frames_live": 160}
    return {"window": (SPANS, counters), "profiled": (SPANS, counters),
            "attribution": A.attribute(rows, launches, SPANS),
            "wall_s": 2e-3}


def test_readers():
    m, obs = A.METRICS, _obs()
    read = {k: v.read(obs) for k, v in m.items()}
    assert read["decode_host_us_per_step.synth"] == pytest.approx(
        (500 - 100) / 4)
    # rows a, b, c, d (the sync's row inside the loop): 50+50+68+10 us
    assert read["decode_device_us_per_step.synth"] == pytest.approx(
        178 / 4)
    assert read["decode_live_share.synth"] == pytest.approx(65.0)
    assert read["vocoder_live_share.synth"] == pytest.approx(62.5)
    assert read["host_bound_idle_share.synth"] == pytest.approx(
        100 * 690e-6 / 2e-3)
    for v in m.values():
        assert v.read({}) is None
        assert v.read(dict(obs, window=None, profiled=None,
                           attribution=None)) is None
    no_steps = dict(obs, window=(SPANS, {}), profiled=(SPANS, {}))
    assert all(v.read(no_steps) is None for k, v in m.items()
               if k != "host_bound_idle_share.synth")


def test_metrics_are_named_as_the_benchmark_names_them():
    for name, m in A.METRICS.items():
        assert name.endswith(".synth") and m.better in ("lower", "higher")
        assert m.source in ("program_span", "program_counter",
                            "device_trace")


def test_tiny_cell_with_program_tracing(bench_copy):
    """The tiny cell's traced run on the CPU: correct, with the program's
    span and counter metrics beside the run's own (no device trace here),
    and live shares equal to those reckoned from the window's lengths."""
    res = PT.run(layout.cell("tiny", bench_copy), SEED, 0.0, True,
                 device="cpu", root=bench_copy)
    assert res["correct"]
    got = res["metrics"]
    assert {"decode_host_us_per_step.synth", "decode_live_share.synth",
            "vocoder_live_share.synth"} <= set(got)
    assert not {"decode_device_us_per_step.synth",
                "host_bound_idle_share.synth"} & set(got)
    assert got["decode_host_us_per_step.synth"]["value"] > 0
    for k in ("decode_live_share", "vocoder_live_share"):
        assert got[f"{k}.synth"]["value"] == pytest.approx(
            res["by_hand"][k], rel=1e-12)
        assert 0 < res["by_hand"][k] <= 100
    c = res["counters"]
    assert c["serve.batches"] >= 1 and c["decode.syncs"] >= 1
    t = res["span_s"]
    assert 0 < t["decode.sync"] < t["decode.loop"]
    assert set(t) == {"serve.pad_requests", "serve.encode", "decode.prepare",
                      "decode.loop", "decode.sync", "decode.finish",
                      "serve.postnet", "serve.read_lengths", "serve.vocode",
                      "serve.scale"}
    assert res["audio_s_per_s"] > 0


@pytest.mark.parametrize("name", ["tiny", "tiny-lsa"])
def test_traced_run_hands_readers_the_program_record(bench_copy, name):
    """A tiny cell's traced run on the CPU gives its metric readers the
    cell's whole configuration and the program's record of the window,
    and reports the program's window metrics, equal to those reckoned
    from the window's lengths; no device trace on the CPU, so no profiled
    batch."""
    cell = layout.cell(name, bench_copy)
    res = R.run(cell, SEED, 0.0, True, device="cpu", root=bench_copy)
    assert res["correct"], res["checks"]
    obs, got = res["obs"], res["metrics"]
    assert obs["config"] == cell["config"] and obs["trace"] is None
    prog = obs["program"]
    assert (prog["profiled"], prog["attribution"], prog["wall_s"]) == (
        None, None, None)
    assert prog["window"][1]["serve.sentences"] == res["attempted"]
    hand = PT.by_hand(obs["batches"],
                      cell["config"]["tacotron"]["n_frames_per_step"])
    for k in ("decode_live_share", "vocoder_live_share"):
        assert got[f"{k}.synth"]["value"] == pytest.approx(hand[k],
                                                           rel=1e-12)
    assert got["decode_host_us_per_step.synth"]["value"] > 0
    assert not {"decode_device_us_per_step.synth",
                "host_bound_idle_share.synth"} & set(got)


STUB_TRACE = '''"""A stand-in for the program's tracing that logs its loading
and each call."""

LOG = %r


def _log(what):
    with open(LOG, "a") as f:
        f.write(what + "\\n")


_log("load")


def enable():
    _log("enable")


def disable():
    _log("disable")


def take():
    _log("take")
    return [], {}
'''


@pytest.mark.parametrize("trace, stub", [(False, True), (True, True),
                                         (True, False)])
def test_only_a_traced_run_turns_the_programs_tracing_on(
        bench_copy, tmp_path, trace, stub):
    """With ``--trace 0`` the adapter's ``_trace`` file is not even
    loaded; with ``--trace 1`` it is turned on over the window (and, on a
    card, the profiled batch) and off after; an adapter without one gives
    no program record and no program metrics."""
    log = tmp_path / "trace.log"
    path = bench_copy / "system" / "synthesize_trace.py"
    if stub:
        path.write_text(STUB_TRACE % str(log))
    else:
        path.unlink()
    res = R.run(layout.cell("tiny", bench_copy), SEED, 0.0, trace,
                device="cpu", root=bench_copy)
    assert res["correct"], res["checks"]
    prog = res["obs"]["program"]
    if trace and stub:
        assert log.read_text().split() == ["load", "enable", "take", "take",
                                           "disable"]
        assert prog["window"] == ([], {})
    else:
        assert not log.exists() and prog is None
    if trace:
        assert not set(A.METRICS) & set(res["metrics"])


@pytest.mark.cuda
def test_traced_tiny_cell_on_card_reads_the_program(bench_copy):
    """On the card the traced run hands its readers the profiled batch's
    mel lengths and the program's record of that batch, which agree; and
    every metric of ``attribution.METRICS`` reads a value, the host-bound
    idle at most the whole idle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = R.run(layout.cell("tiny", bench_copy), SEED, 0.5, True,
                root=bench_copy)
    assert res["correct"], res["checks"]
    tr, prog, got = res["obs"]["trace"], res["obs"]["program"], \
        res["metrics"]
    assert len(tr["frames"]) == tr["batch"]
    assert all(type(n) is int for n in tr["frames"])
    counters = prog["profiled"][1]
    assert counters["vocoder.frames_live"] == int(
        judge.vocoder_frames(np.array(tr["frames"])).sum())
    assert counters["decode.steps"] == tr["steps"]
    assert prog["attribution"].route == "launch"
    assert set(A.METRICS) <= set(got)
    assert got["host_bound_idle_share.synth"]["value"] <= \
        got["idle_share.synth"]["value"]


@pytest.mark.cuda
def test_shared_clock_on_card(capsys):
    """Spans and kineto's launch records share one clock: each sleep
    kernel launched inside a span has its launch record inside that span
    and is put down to it.  Prints the medians (us) of the launch record
    less the span's start, the span's end less the launch record, and the
    kernel's device start less its launch record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tacotron2_subword_tpu_torch.utils import trace
    n = 20
    torch.cuda.synchronize()
    with xprof.device_profile() as prof:
        trace.enable()
        trace.take()
        for _ in range(n):
            with trace.span("clock"):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        spans = trace.take().spans
        trace.disable()
    rows, launches, _ = A.records(prof, skip=None)
    spans = [tuple(s) for s in spans]
    a = A.attribute(rows, launches, spans)
    mine = [(r, at, s) for r, at, s in zip(a.rows, a.launch_ns, a.span)
            if s is not None]
    assert len(mine) == n, (len(mine), len(rows), len(launches))
    assert sorted(s for _, _, s in mine) == list(range(n))
    for r, at, s in mine:
        assert r.corr in launches
        assert spans[s][2] <= at <= spans[s][3]
    lead = sorted((at - spans[s][2]) / 1e3 for _, at, s in mine)
    tail = sorted((spans[s][3] - at) / 1e3 for _, at, s in mine)
    start = sorted((r.start_ns - at) / 1e3 for r, at, _ in mine)
    with capsys.disabled():
        print(f"\nclock: launch - span start {lead[n // 2]:.2f} us "
              f"(min {lead[0]:.2f}); span end - launch {tail[n // 2]:.2f} "
              f"us; device start - launch {start[n // 2]:.2f} us "
              f"(min {start[0]:.2f}, max {start[-1]:.2f}); "
              f"route {a.route}, launch records {len(launches)}")
