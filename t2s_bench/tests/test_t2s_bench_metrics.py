"""The per-layer readers and the trace reduction on synthetic rows."""

from __future__ import annotations

import pytest

from t2s_bench import flops, layout, spans as S
from t2s_bench.frozen import xprof

MARK = xprof.SENTINEL
CELL = "sma-v1.synth-b256"


def _rows():
    # lead sentinels, then: enter synthesize | enc | enter acoustic |
    # enter decode_loop | 4 decode rows (2 K1) | exit decode_loop |
    # postnet | exit acoustic | enter vocoder | conv | exit vocoder | exit
    # synthesize | copy | end
    r = [(MARK, 0.0, 1.0)] * 3
    r += [(MARK, 10, 1), ("embed", 12, 2), (MARK, 20, 1), (MARK, 21, 1),
          ("dequant_int8_matmul_tc", 30, 10), ("lstm", 45, 5),
          ("dequant_int8_matmul_tc", 60, 10), ("sma", 80, 5),
          (MARK, 90, 1), ("postnet", 95, 5), (MARK, 101, 1), (MARK, 102, 1),
          ("conv", 110, 40), (MARK, 151, 1), (MARK, 152, 1),
          ("memcpy", 160, 10), (MARK, 171, 1)]
    return r


MARKS = [("synthesize", True), ("acoustic", True), ("decode_loop", True),
         ("decode_loop", False), ("acoustic", False), ("vocoder", True),
         ("vocoder", False), ("synthesize", False), ("end", False)]


def test_segments_and_idle():
    segs = S.segments(_rows(), MARKS, S.HARNESS)
    labels = [(label, [r[0] for r in rows]) for label, rows in segs]
    assert labels[0] == ("synthesize", ["embed"])
    assert labels[2][0] == "decode_loop" and len(labels[2][1]) == 4
    assert labels[3] == ("acoustic", ["postnet"])
    assert labels[5] == ("vocoder", ["conv"])
    assert labels[7] == (S.HARNESS, ["memcpy"])
    idle = S.idle_gaps(segs)
    # gaps before each row, named by the span the row ran in
    assert idle["decode_loop"] == pytest.approx((16 + 5 + 10 + 10) / 1e6)
    assert idle["acoustic"] == pytest.approx(10 / 1e6)
    assert idle["vocoder"] == pytest.approx(10 / 1e6)
    assert idle[S.HARNESS] == pytest.approx(10 / 1e6)
    assert S.segments(_rows()[3:8], MARKS, S.HARNESS) is None


def _obs(trace=True):
    t = layout.config("t2s-sma-int8-hifigan-v1")["tacotron"]
    segs = S.segments(_rows(), MARKS, S.HARNESS)
    return {"cell": CELL, "tacotron": t,
            "kernels": {"k1": "dequant_int8_matmul"}, "window_s": 10.0,
            "audio_s": 4000.0, "steps": 1000, "flops": 9.89e13,
            "spans": {"decode_loop": 1.5, "vocoder": 2.0, "acoustic": 2.5},
            "peak_bytes": 3 * 2 ** 30,
            "trace": {"segments": segs, "steps": 2, "wall_s": 200e-6,
                      "busy_s": 100e-6, "batch": 128} if trace else None}


def test_readers():
    m, obs = layout.metrics(), _obs()
    assert m["decode_us_per_step.synth"].read(obs) == pytest.approx(1500)
    assert m["launches_per_step.synth"].read(obs) == 2.0
    assert m["vocoder_ms_per_audio_s.synth"].read(obs) == pytest.approx(0.5)
    assert m["mfu.synth"].read(obs) == pytest.approx(1.0)
    assert m["idle_share.synth"].read(obs) == pytest.approx(50.0)
    assert m["peak_gib.synth"].read(obs) == 3.0
    bound = flops.k1_step_bound_s(obs["tacotron"], 128)
    assert m["k1_roofline.synth"].read(obs) == pytest.approx(
        100 * bound / 20e-6)


def test_readers_with_nothing_to_read_return_nothing():
    m, obs = layout.metrics(), _obs(trace=False)
    for name in ("launches_per_step.synth", "k1_roofline.synth",
                 "idle_share.synth"):
        assert m[name].read(obs) is None
    obs = _obs()
    obs["kernels"] = {"k1": "no_such_kernel"}
    assert m["k1_roofline.synth"].read(obs) is None
    obs["spans"], obs["steps"] = {}, 0
    assert m["decode_us_per_step.synth"].read(obs) is None
    assert m["vocoder_ms_per_audio_s.synth"].read(obs) is None


def test_summarize_rows_busy_is_the_union():
    p = xprof.summarize_rows([("a", 0, 10), ("b", 5, 10), ("a", 20, 5)])
    assert (p.busy_ms, p.span_ms, p.n_events) == (20e-3, 25e-3, 3)
    assert p.ops[0] == ("a", 15e-3, 2)
