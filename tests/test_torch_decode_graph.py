"""The free-running decode as CUDA graph replays (``models/tacotron2.
_DecodeGraph``) against the eager loop, and the prenet masks' scaling.

On the CPU the graph is stood in for by its own body run eagerly (the
capture records nothing; a replay runs the body).  That checks everything
but CUDA's capture itself: the buffers refilled for each batch, the
staging of each chunk's outputs, the device step counter, the generator's
state handed in and back, the steps past the last whole chunk.  The tests
marked ``cuda`` capture and replay on the card:

    python -m pytest --noconftest tests/test_torch_decode_graph.py -q
"""

import math
import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.ops import quant as Q
from tacotron2_subword_tpu_torch.utils import trace
from tacotron2_subword_tpu_torch.utils.tree import to_device
# by its own directory, which pytest puts on the path: an installed
# package named "tests" would shadow "tests.torch_threads"
from torch_threads import one_torch_thread  # noqa: F401

TINY = TacotronConfig(
    n_symbols=23, sub_n_symbols=31, symbols_embedding_dim=16,
    encoder_embedding_dim=16, bert_embedding_dim=12, attention_rnn_dim=20,
    attention_dim=8, decoder_rnn_dim=24, prenet_dim=10, n_mel_channels=5,
    postnet_embedding_dim=16, attention_location_n_filters=4,
    attention_location_kernel_size=7)
VARIANTS = ("StepwiseMonotonicAttention", "LocationSensitiveAttention",
            "ForwardAttentionV2", "ContentAttention",
            "DynamicConvolutionAttention", "GMMAttention")
OUTPUTS = ("mel", "gate", "alignments", "alignments_bert", "mel_lengths",
           "infer_ok")
CPU_SYNC, CPU_STEPS, CPU_STOP = 4, 22, 10   # 5 chunks and 2 steps
CARD_STEPS, CARD_STOP = 40, 40              # 2 chunks and 8 steps; 48
TALLY = ("decode.steps", "decode.graph_captures", "decode.graph_replays",
         "decode.eager_steps")


def timer_gate(dp, stop_at: int) -> None:
    """Rig random decoder params so that every row's gate fires near step
    ``stop_at`` at threshold 0.5 (random weights keep the gate near 0.5 at
    every step): unit 0 of the decoder LSTM counts steps (gates held open,
    cell input atanh(1 / stop_at), its other weights scaled by 1e-4), and
    the gate layer reads its output tanh(t / stop_at) with weight 8 and
    bias -8 tanh(1).  In place."""
    r, g = dp["decoder_rnn"], dp["gate_layer"]
    H = r["w_hh"].shape[1]
    rows = [0, H, 2 * H, 3 * H]
    with torch.no_grad():
        for k in ("w_ih", "w_hh"):
            r[k][rows] *= 1e-4
        r["b_hh"][rows] = 0.0
        r["b_ih"][rows] = torch.tensor(
            [12.0, 12.0, math.atanh(1.0 / stop_at), 12.0])
        g["w"][0, 0] = 8.0
        g["b"][0] = -8.0 * math.tanh(1.0)


def _batch(cfg, seed: int, stop_at: int, B: int, device):
    """(decoder params, memory, memory_b, text_lengths, sub_lengths)."""
    params, _ = TM.init_tacotron2(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
    timer_gate(params["decoder"], stop_at)
    g = torch.Generator().manual_seed(seed + 1)
    E = cfg.encoder_embedding_dim
    mem = torch.randn((B, 9, E), generator=g)
    mem_b = torch.randn((B, 6, E), generator=g)
    t_len = torch.randint(3, 10, (B,), generator=g)
    s_len = torch.randint(2, 7, (B,), generator=g)
    move = lambda t: t.to(device)
    return (to_device(params["decoder"], device), move(mem), move(mem_b),
            move(t_len), move(s_len))


def _decode(monkeypatch, graph: bool, batch, cfg, steps, thresh, seed):
    """decoder_infer on ``batch`` as the graph (or the eager loop): (its
    outputs, the generator's state after, its decode counters, K1
    launches)."""
    dp, mem, mem_b, t_len, s_len = batch
    monkeypatch.setattr(TM, "_graphable", lambda device: graph)
    gen = torch.Generator(device=mem.device).manual_seed(seed)
    k1 = Q.launches
    trace.enable()
    try:
        with torch.inference_mode():
            out = TM.decoder_infer(dp, cfg, mem, mem_b, generator=gen,
                                   max_steps=steps, gate_threshold=thresh,
                                   text_lengths=t_len, sub_lengths=s_len)
    finally:
        trace.disable()
    counters = trace.take().counters
    return (out, gen.get_state(), {k: counters[k] for k in TALLY},
            Q.launches - k1)


def _assert_same(a, b):
    for k in OUTPUTS:
        assert torch.equal(a[k], b[k]), k
    assert a["steps_run"] == b["steps_run"]


def _graph_against_eager(monkeypatch, cfg, steps, ending, stop_at, B,
                         device):
    """Two batches of one shape (other weights, inputs and seeds) through
    the graph and the eager loop; returns the rows of (steps run, K1
    launches of the eager and of the graph run)."""
    thresh = 0.5 if ending == "check" else 1.1
    sync, rows, tallies = TM.SYNC_EVERY, [], []
    for k in range(2):
        batch = _batch(cfg, 10 * k, stop_at, B, device)
        eager, st_e, c_e, k1_e = _decode(monkeypatch, False, batch, cfg,
                                         steps, thresh, 5 + k)
        graph, st_g, c_g, k1_g = _decode(monkeypatch, True, batch, cfg,
                                         steps, thresh, 5 + k)
        _assert_same(graph, eager)
        assert torch.equal(st_g, st_e)
        n = eager["steps_run"]
        if ending == "check":      # stopped at a check, after replays
            assert 2 * sync <= n < steps and n % sync == 0
            assert bool(eager["infer_ok"].all())
        else:                      # ran into the step limit
            assert n == steps and steps % sync and not eager["infer_ok"].any()
        assert c_e == {"decode.steps": n, "decode.graph_captures": 0,
                       "decode.graph_replays": 0, "decode.eager_steps": n}
        assert c_g["decode.steps"] == n
        assert (c_g["decode.graph_replays"] * sync
                + c_g["decode.eager_steps"] == n)
        rows.append((n, k1_e, k1_g))
        tallies.append(c_g)
    # the first batch warms up and captures, the second only replays
    assert [c["decode.graph_captures"] for c in tallies] == [1, 0]
    assert tallies[0]["decode.eager_steps"] == sync + rows[0][0] % sync
    assert tallies[1]["decode.eager_steps"] == rows[1][0] % sync
    assert len(TM._graphs) == 1
    return rows


@pytest.fixture
def body_as_graph(monkeypatch):
    """The graph stood in for by its body: warm-up and replay run it, the
    capture records nothing."""
    def capture(self):
        self.graph = types.SimpleNamespace(replay=self._body)
    monkeypatch.setattr(TM._DecodeGraph, "warm_up", TM._DecodeGraph._body)
    monkeypatch.setattr(TM._DecodeGraph, "capture", capture)
    monkeypatch.setattr(TM, "_graphs", {})
    monkeypatch.setattr(TM, "SYNC_EVERY", CPU_SYNC)
    trace.take()
    yield
    trace.take()


@pytest.mark.parametrize("ending", ["check", "limit"])
@pytest.mark.parametrize("variant,quant",
                         [(v, "") for v in VARIANTS]
                         + [("StepwiseMonotonicAttention", "int8")])
def test_graph_loop_matches_eager_on_cpu(body_as_graph, monkeypatch, variant,
                                         quant, ending):
    """Bit-equal outputs, generator state and step counts, batch after
    batch, for every attention variant (int8 for SMA too)."""
    cfg = TINY.replace(attention=variant, decode_quant=quant)
    _graph_against_eager(monkeypatch, cfg, CPU_STEPS, ending, CPU_STOP, 3,
                         torch.device("cpu"))


def test_graph_cache_keeps_the_latest_shapes(body_as_graph, monkeypatch):
    """One graph a shape, at most GRAPH_CACHE, the least recent dropped."""
    monkeypatch.setattr(TM, "GRAPH_CACHE", 2)
    for B in (1, 2, 3, 2):
        _decode(monkeypatch, True, _batch(TINY, 0, CPU_STOP, B, "cpu"), TINY,
                3 * CPU_SYNC, 1.1, 0)
    # the last tensor of a key's signature is the state's finished [B]
    assert [k[-1][-1][0] for k in TM._graphs] == [(3,), (2,)]


def test_cpu_decode_stays_eager(monkeypatch):
    """No monkeypatching: the CPU runs the eager loop and makes no graph."""
    monkeypatch.setattr(TM, "_graphs", {})
    batch = _batch(TINY, 0, CPU_STOP, 3, "cpu")
    dp, mem, mem_b, t_len, s_len = batch
    trace.enable()
    try:
        with torch.inference_mode():
            out = TM.decoder_infer(dp, TINY, mem, mem_b,
                                   generator=torch.Generator(), max_steps=40,
                                   gate_threshold=1.1, text_lengths=t_len,
                                   sub_lengths=s_len)
    finally:
        trace.disable()
    c = trace.take().counters
    assert out["steps_run"] == c["decode.steps"] == 40 and TM._graphs == {}
    assert (c["decode.graph_captures"], c["decode.graph_replays"],
            c["decode.eager_steps"]) == (0, 0, 40)


def _old_scaled(mask, rate, dtype):
    """The division as the decode made it before: by a 0-d tensor on the
    mask's device (a copy to the device, which a CUDA graph cannot hold)."""
    return mask.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype,
                                         device=mask.device)


SCALED = [(dt, rate) for dt in (torch.bfloat16, torch.float16, torch.float32)
          for rate in (0.5, 0.1)]


@pytest.mark.parametrize("dtype,rate", SCALED)
def test_scaled_is_the_old_division(dtype, rate):
    mask = torch.rand((7, 300), generator=torch.Generator().manual_seed(0)) \
        < 1.0 - rate
    new, old = TM._scaled(mask, rate, dtype), _old_scaled(mask, rate, dtype)
    assert new.dtype == dtype and torch.equal(new, old)
    assert set(new.unique().tolist()) == {0.0, old.max().item()}


class _Ops(TorchDispatchMode):
    """Records each op with the devices of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append((func.__name__, [(a.device.type, a.dim()) for a in
                                         args if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


def test_scaled_divides_by_a_host_scalar():
    """The divisor stays on the host, 0-d: the device kernel takes it as a
    scalar, and nothing is made on the mask's device (here "meta") but the
    cast mask and the quotient."""
    mask = torch.ones((4, 3), dtype=torch.bool, device="meta")
    with _Ops() as rec:
        y = TM._scaled(mask, 0.5, torch.bfloat16)
    assert y.device.type == "meta" and y.dtype == torch.bfloat16
    div = [args for name, args in rec.ops if name.startswith("div")]
    assert div == [[("meta", 2), ("cpu", 0)]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rate", SCALED)
def test_scaled_is_the_old_division_on_card(cuda_device, dtype, rate):
    mask = torch.rand((4, 256, 256), device=cuda_device) < 1.0 - rate
    assert torch.equal(TM._scaled(mask, rate, dtype),
                       _old_scaled(mask, rate, dtype))


# the two served configurations, then the other variants in bf16: each
# captures and replays
CARD_CONFIGS = {
    "sma-int8": TacotronConfig(decode_quant="int8"),
    "lsa-bf16": TacotronConfig(attention="LocationSensitiveAttention"),
    **{f"{v}-bf16": TacotronConfig(attention=v) for v in VARIANTS[2:]},
}


@pytest.mark.cuda
@pytest.mark.parametrize("ending", ["check", "limit"])
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_graph_decode_bit_equal_on_card(cuda_device, monkeypatch, name,
                                        ending):
    """At B=8, full width, prenet dropout on (SMA int8, LSA bf16, the
    other variants bf16): the replayed decode and the eager loop give the
    same bits, generator state and step counts, for
    a batch that stops at a check and one that runs into the step limit
    with a partial last chunk, and for a second batch of the same shape
    (the graph's buffers refilled).  K1: 2 launches a step both ways."""
    monkeypatch.setattr(TM, "_graphs", {})
    trace.take()
    cfg = CARD_CONFIGS[name]
    rows = _graph_against_eager(monkeypatch, cfg,
                                1000 if ending == "check" else CARD_STEPS,
                                ending, CARD_STOP, 8, cuda_device)
    per_step = 2 if cfg.decode_quant == "int8" else 0
    assert all(k1_e == k1_g == per_step * n for n, k1_e, k1_g in rows)
    trace.take()
    TM._graphs.clear()
