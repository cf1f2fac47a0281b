"""The port's serving-path tracing (``utils/trace.py``) on the CPU: off, it
records nothing and hands out one shared span; on, a tiny ``synthesize``
records every span of the serving path under its parent, its counters
equal what the returned lengths give, and its outputs are bit-equal to
those of a run with tracing off."""

import time

import numpy as np
import pytest
import torch

from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.ops import quant, softdtw
from tacotron2_subword_tpu_torch.utils import trace
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = TacotronConfig(
    n_symbols=23, sub_n_symbols=31, symbols_embedding_dim=16,
    encoder_embedding_dim=16, bert_embedding_dim=12, attention_rnn_dim=20,
    attention_dim=8, decoder_rnn_dim=24, prenet_dim=10, n_mel_channels=5,
    postnet_embedding_dim=16, max_decoder_steps=30,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    hop_length=16)
TINY_H = HG.HifiganConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                          upsample_initial_channel=8, num_mels=5,
                          resblock_kernel_sizes=(3,),
                          resblock_dilation_sizes=((1, 3),))
STEPS = 14
SYNC = 4

# (name, parent's name) of every span of one served batch, in order
SERVE_SPANS = [("serve.pad_requests", None), ("serve.encode", None),
               ("decode.prepare", None), ("decode.loop", None),
               ("decode.finish", None), ("serve.postnet", None),
               ("serve.read_lengths", None), ("serve.vocode", None),
               ("serve.scale", None)]


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _model(r: int):
    cfg = TINY.replace(n_frames_per_step=r)
    gen = torch.Generator().manual_seed(0)
    params, bn = TM.init_tacotron2(gen, cfg, device="cpu")
    g = HG.fuse_generator(HG.init_generator(gen, TINY_H, device="cpu"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.n_symbols, n), rng.randint(0, 31, m),
             rng.randn(12), rng.randn(12))
            for n, m in ((9, 5), (4, 3), (7, 6), (5, 2))]
    return cfg, params, bn, g, reqs


def _serve(model, threshold):
    cfg, params, bn, g, reqs = model
    return TI.synthesize(params, bn, g, cfg, TINY_H, reqs,
                         generator=torch.Generator().manual_seed(1),
                         device="cpu", max_steps=STEPS,
                         gate_threshold=threshold)


def _threshold(model) -> float:
    """A threshold between the rows' highest gates: some rows stop early,
    one runs to the step limit."""
    out = _serve(model, 1.1)
    top = torch.sigmoid(out["gate"]).amax(dim=1).sort().values
    return float(top[:2].mean())


def test_off_hands_out_one_span_and_records_nothing(monkeypatch):
    monkeypatch.setattr(TM, "SYNC_EVERY", SYNC)
    assert trace.span("a") is trace.span("b") is trace.OFF
    with trace.span("a"):
        trace.count("c", 3)
    k1, k2, k3 = (quant.launches, softdtw.grad_launches,
                  softdtw.fwd_launches)
    _serve(_model(1), 0.5)
    assert trace.take() == trace.Trace([], {})
    # the launch counters are read, never written
    assert (quant.launches, softdtw.grad_launches,
            softdtw.fwd_launches) == (k1, k2, k3)


def test_nesting_parents_and_clock():
    trace.enable()
    t0 = time.time_ns()
    with trace.span("a"):
        with trace.span("b"):
            trace.count("n")
        with trace.span("c"):
            with trace.span("d"):
                with pytest.raises(RuntimeError, match="'d'"):
                    trace.take()
    with trace.span("e"):
        trace.count("n", 4)
    t1 = time.time_ns()
    rec = trace.take()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("a", None), ("b", 0), ("c", 0), ("d", 2), ("e", None)]
    a, b, c, d, e = rec.spans
    assert t0 <= a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns
    assert c.start_ns <= d.start_ns <= d.end_ns <= c.end_ns <= a.end_ns
    assert a.end_ns <= e.start_ns <= e.end_ns <= t1
    assert rec.counters["n"] == 5
    assert trace.take().spans == []


def test_launch_counters_are_read_while_on(monkeypatch):
    monkeypatch.setattr(quant, "launches", 10)
    monkeypatch.setattr(softdtw, "grad_launches", 0)
    monkeypatch.setattr(softdtw, "fwd_launches", 5)
    quant.launches += 1                     # before tracing: not counted
    trace.enable()
    quant.launches += 2
    softdtw.fwd_launches += 1
    assert {k: v for k, v in trace.take().counters.items()
            if k.endswith("launches")} == {
        "k1.launches": 2, "k2.launches": 0, "k3.launches": 1}
    quant.launches = 0                      # a caller's reset
    quant.launches += 3
    trace.disable()
    quant.launches += 7                     # after tracing: not counted
    assert trace.take().counters["k1.launches"] == 3
    assert trace.take() == trace.Trace([], {})


@pytest.mark.parametrize("r", [1, 2])
def test_synthesize_records_spans_and_counts(monkeypatch, r):
    monkeypatch.setattr(TM, "SYNC_EVERY", SYNC)
    model = _model(r)
    thr = _threshold(model)
    off = _serve(model, thr)
    trace.enable()
    on = _serve(model, thr)
    rec = trace.take()
    trace.disable()

    # outputs bit-equal with tracing on and off
    for k in ("mel", "mel_postnet", "gate", "mel_lengths", "infer_ok"):
        assert torch.equal(on[k], off[k]), k
    assert on["steps_run"] == off["steps_run"]
    assert all(torch.equal(a, b) for a, b in zip(on["wavs"], off["wavs"]))

    steps = on["steps_run"]
    lengths = on["mel_lengths"].tolist()
    assert len(set(lengths)) > 1 and max(lengths) == steps * r
    names = [(s.name, rec.spans[s.parent].name if s.parent is not None
              else None) for s in rec.spans]
    syncs = [n for n in names if n[0] == "decode.sync"]
    assert syncs == [("decode.sync", "decode.loop")] * (steps // SYNC)
    assert [n for n in names if n[0] != "decode.sync"] == SERVE_SPANS
    for s in rec.spans:
        assert s.start_ns <= s.end_ns

    B = len(lengths)
    n = [max(v, TI.MIN_FRAMES) for v in lengths]
    pad = -(-max(n) // TI.BUCKET) * TI.BUCKET
    assert rec.counters == {
        "decode.steps": steps, "decode.syncs": steps // SYNC,
        # the CPU decode is the eager loop: no CUDA graph
        "decode.graph_captures": 0, "decode.graph_replays": 0,
        "decode.eager_steps": steps,
        "serve.batches": 1, "serve.sentences": B,
        "decode.row_steps": B * steps,
        "decode.live_row_steps": sum(v // r for v in lengths),
        "vocoder.frames_run": B * pad, "vocoder.frames_live": sum(n),
        "k1.launches": 0, "k2.launches": 0, "k3.launches": 0}
    assert rec.counters["decode.live_row_steps"] < B * steps
