"""HiFi-GAN's right context (``models/hifigan.right_context_frames``) and
the serving entry's length-sorted vocoder groups (``apps/inference.
vocode_bucketed`` with ``context``) against the one padded call.

On the CPU in f64, with tiny generators at torch's default weight scale
U(+-1/sqrt(fan_in)) (the benchmark's; at init_generator's N(0, 0.01) the
last frame's pull on the kept samples falls below f64's rounding).  The
test marked ``cuda`` serves a B=256 batch of the synth-b256 lengths at
V1's widths on the card:

    python -m pytest --noconftest tests/test_torch_vocode_groups.py -q -m cuda
"""

import json
import math
import os
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.apps import inference as TI
from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as TM
from tacotron2_subword_tpu_torch.utils import trace
# by its own directory, which pytest puts on the path: an installed
# package named "tests" would shadow "tests.torch_threads"
from torch_threads import one_torch_thread  # noqa: F401

V3_KERNELS = dict(resblock="2", upsample_rates=(8, 8, 4),
                  upsample_kernel_sizes=(16, 16, 8),
                  resblock_kernel_sizes=(3, 5, 7),
                  resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
# V1's and V2's kernels (the default config) and V3's, at 32 channels;
# V1's first and last stages alone (hop 16), which the groups' tests serve
SETTINGS = {"v1-v2": HG.HifiganConfig(upsample_initial_channel=32),
            "v3": HG.HifiganConfig(upsample_initial_channel=32,
                                   **V3_KERNELS),
            "v1-two-stages": HG.HifiganConfig(
                upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                upsample_initial_channel=16, num_mels=8)}
CONTEXT = {"v1-v2": 13, "v3": 11, "v1-two-stages": 15}
BIG = 1e6          # a perturbation far above the mel's scale
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def default_scale_generator(h: HG.HifiganConfig, seed: int,
                            dtype=torch.float64, device="cpu"):
    """A fused generator with every weight and bias U(+-1/sqrt(fan_in)),
    torch's default (for a transposed convolution [in, out, k] torch takes
    fan_in = out * k)."""
    g = torch.Generator().manual_seed(seed)
    tree = HG.fuse_generator(HG.init_generator(g, h, device="cpu"))

    def draw(p):
        fan_in = p["w"].shape[1] * p["w"].shape[2]
        b = 1.0 / math.sqrt(fan_in)
        u = lambda t: ((torch.rand(t.shape, generator=g, dtype=torch.float64)
                        * 2 - 1) * b).to(dtype=dtype, device=device)
        return {"w": u(p["w"]), "b": u(p["b"])}

    return {"conv_pre": draw(tree["conv_pre"]),
            "conv_post": draw(tree["conv_post"]),
            "ups": [draw(p) for p in tree["ups"]],
            "resblocks": [{k: [draw(c) for c in v] for k, v in rb.items()}
                          for rb in tree["resblocks"]]}


def _kept(params, h, mel, n):
    return HG.generator_apply(params, h, mel)[0, 0, :n * h.total_upsample]


@pytest.mark.parametrize("name", list(SETTINGS))
def test_right_context_is_the_smallest_that_keeps_the_samples(name):
    """Perturbing every mel frame from n - 1 + c + 1 on leaves the kept
    samples of an n-frame row bit-equal at c = right_context_frames(h) and
    moves them at c - 1; a mel cut at n + c frames gives them again."""
    h = SETTINGS[name]
    c = HG.right_context_frames(h)
    assert c == CONTEXT[name]
    params = default_scale_generator(h, seed=3)
    g = torch.Generator().manual_seed(4)
    n = 20
    mel = torch.randn((1, h.num_mels, n + c + 8), generator=g,
                      dtype=torch.float64) - 4.0
    with torch.no_grad():
        base = _kept(params, h, mel, n)

        def perturbed_from(f):
            m = mel.clone()
            m[:, :, f:] += BIG
            return _kept(params, h, m, n)

        assert torch.equal(perturbed_from(n + c), base)
        assert not torch.equal(perturbed_from(n + c - 1), base)
        # a cut changes the convolutions' lengths, and with them the order
        # the CPU's kernels add in: equal to f64's rounding, not bit-equal;
        # frame n + c - 1 set far off the scale shows when it is cut away
        tail = mel.clone()
        tail[:, :, n + c - 1:] = BIG
        full = _kept(params, h, tail, n)
        cut = _kept(params, h, tail[:, :, :n + c], n)
        assert (cut - full).abs().max() <= 1e-13
        short = _kept(params, h, tail[:, :, :n + c - 1], n)
        assert (short - full).abs().max() > 1e-10


# lengths that the sort cuts into 3 groups of 32 rows (B=96), served by
# "v1-two-stages" (15 frames of context); "edge": the longest of each group
# plus the context lands on a 16-frame edge (97 + 15 = 112, 193 + 15 =
# 208), the last group's on the one call's pad (305 + 15 = 320); "cap": the
# longest (315) would pass the one call's pad of 320, and a row shorter
# than MIN_FRAMES
RUN_LENGTHS = {
    "edge": (np.linspace(9, 97, 32), np.linspace(98, 193, 32),
             np.linspace(194, 305, 32)),
    "cap": (np.r_[3, np.linspace(9, 90, 31)], np.linspace(91, 200, 32),
            np.linspace(201, 315, 32)),
}


def _lengths(case: str):
    n = np.concatenate([np.rint(r) for r in RUN_LENGTHS[case]]).astype(int)
    return [int(v) for v in np.random.RandomState(5).permutation(n)]


def _recording(vocode):
    calls = []

    def voc(m):
        calls.append(m)
        return vocode(m)
    return voc, calls


def _traced(fn):
    trace.enable()
    out = fn()
    counters = {k: v for k, v in trace.take().counters.items()
                if k.startswith("vocoder.")}
    trace.disable()
    return out, counters


@pytest.mark.parametrize("case", list(RUN_LENGTHS))
def test_groups_serve_the_one_calls_samples(case):
    """B=96 rows in a shuffled order: 3 groups, each padded to its longest
    row plus the context (at most the one call's pad), serve every row the
    one call's samples in request order, and the counters say so."""
    h = SETTINGS["v1-two-stages"]
    hop, c = h.total_upsample, HG.right_context_frames(h)
    params = default_scale_generator(h, seed=6)
    lengths = _lengths(case)
    B = len(lengths)
    n = [max(v, TI.MIN_FRAMES) for v in lengths]
    g = torch.Generator().manual_seed(7)
    mel = torch.randn((B, h.num_mels, max(lengths) + 5), generator=g,
                      dtype=torch.float64) - 4.0
    vocode = lambda m: HG.generator_apply(params, h, m)[:, 0, :]
    with torch.no_grad():
        one = TI.vocode_bucketed(vocode, mel, lengths, hop)
        voc, calls = _recording(vocode)
        groups, counters = _traced(
            lambda: TI.vocode_bucketed(voc, mel, lengths, hop, context=c))

    assert [w.shape[0] for w in groups] == [v * hop for v in n]
    for a, b in zip(groups, one):
        assert (a - b).abs().max() <= 1e-12
    pad_f = -(-max(n) // TI.BUCKET) * TI.BUCKET
    longest = sorted(n)[31::32]
    pads = [min(-(-(v + c) // 16) * 16, pad_f) for v in longest]
    assert [tuple(m.shape) for m in calls] == [(32, h.num_mels, p)
                                               for p in pads]
    if case == "edge":
        assert pads == [112, 208, 320]
    else:
        assert pads[-1] == pad_f == 320
    assert counters["vocoder.calls"] == 3
    assert counters["vocoder.frames_run"] == 32 * sum(pads)
    assert counters["vocoder.frames_live"] == sum(n)


def _today(mel, lengths):
    """The one call's input as vocode_bucketed made it before the groups."""
    n = [max(int(v), TI.MIN_FRAMES) for v in lengths]
    pad_f = -(-max(n) // TI.BUCKET) * TI.BUCKET
    m = mel[:, :, :max(n)]
    m = F.pad(m, (0, pad_f - m.shape[-1]), value=TI.MEL_FLOOR)
    keep = (torch.arange(pad_f)[None, :] < torch.tensor(n)[:, None])
    return torch.where(keep[:, None, :], m, torch.full_like(m, TI.MEL_FLOOR))


@pytest.mark.parametrize("rows, context", [(96, None), (63, 13)])
def test_no_context_or_few_rows_make_the_one_call(rows, context):
    """Without a context, or below GROUP_FROM rows, the vocoder gets the
    one input it always got and each row its slice of the output."""
    hop = 4
    lengths = _lengths("cap")[:rows]
    mel = torch.randn((rows, 8, max(lengths) + 3),
                      generator=torch.Generator().manual_seed(8))
    voc, calls = _recording(
        lambda m: torch.cumsum(m.sum(1), -1).repeat_interleave(hop, -1))
    wavs, counters = _traced(
        lambda: TI.vocode_bucketed(voc, mel, lengths, hop, context=context))
    want = _today(mel, lengths)
    assert len(calls) == 1 and torch.equal(calls[0], want)
    ref = voc(want)
    n = [max(v, TI.MIN_FRAMES) for v in lengths]
    assert all(torch.equal(w, ref[i, :v * hop])
               for i, (w, v) in enumerate(zip(wavs, n)))
    assert counters == {"vocoder.calls": 1,
                        "vocoder.frames_run": rows * want.shape[-1],
                        "vocoder.frames_live": sum(n)}


def test_synthesize_passes_the_generators_context(monkeypatch):
    seen = []
    real = TI.vocode_bucketed

    def spy(vocode, mel, n_frames, hop, context=None):
        seen.append(context)
        return real(vocode, mel, n_frames, hop, context=context)

    monkeypatch.setattr(TI, "vocode_bucketed", spy)
    cfg = TacotronConfig(
        n_symbols=23, sub_n_symbols=31, symbols_embedding_dim=16,
        encoder_embedding_dim=16, bert_embedding_dim=12,
        attention_rnn_dim=20, attention_dim=8, decoder_rnn_dim=24,
        prenet_dim=10, n_mel_channels=5, postnet_embedding_dim=16,
        max_decoder_steps=6, attention_location_n_filters=4,
        attention_location_kernel_size=7, hop_length=16)
    h = HG.HifiganConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                         upsample_initial_channel=8, num_mels=5,
                         resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),))
    gen = torch.Generator().manual_seed(0)
    params, bn = TM.init_tacotron2(gen, cfg, device="cpu")
    gp = HG.fuse_generator(HG.init_generator(gen, h, device="cpu"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(1, 23, 5), rng.randint(1, 31, 3), rng.randn(12),
             rng.randn(12)) for _ in range(2)]
    out = TI.synthesize(params, bn, gp, cfg, h, reqs,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu", max_steps=6)
    assert seen == [HG.right_context_frames(h)] and len(out["wavs"]) == 2


def _wav_gap(a, b, hop):
    """The benchmark's ``wav_gap``: the largest RMS over a hop of the
    difference of int16-scaled wavs, over full scale."""
    worst = 0.0
    for x, y in zip(a, b):
        x = torch.clamp(x.double() * TI.MAX_WAV_VALUE, -32768.0, 32767.0)
        y = torch.clamp(y.double() * TI.MAX_WAV_VALUE, -32768.0, 32767.0)
        d = (x - y).reshape(-1, hop)
        worst = max(worst, float(d.pow(2).mean(1).sqrt().max()))
    return worst / 32768.0


@pytest.mark.cuda
def test_groups_on_the_card_at_v1_widths():
    """B=256 rows of the synth-b256 stop frames at V1's widths in f32 (TF32
    as cuDNN picks it): the groups serve the one call's samples within the
    sma cell's wav_gap limit (7e-5 of full scale), with no more waits on
    the device, all before the first group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from t2s_bench.traffic import synth_batches
    with open(os.path.join(ROOT, "t2s_bench", "traffic",
                           "synth-b256.json")) as f:
        mix = json.load(f)
    hop = 256
    _, _, stops = synth_batches.sizes(mix, {"sampling_rate": 22050,
                                            "hop_length": hop})
    lengths = [int(v) for v in np.random.RandomState(9).permutation(stops)]
    h = HG.HifiganConfig()
    dev = torch.device("cuda")
    params = default_scale_generator(h, seed=10, dtype=torch.float32,
                                     device=dev)
    mel = (torch.randn((len(lengths), 80, max(lengths) + 8),
                       generator=torch.Generator().manual_seed(11)) * 2.0
           - 5.0).to(dev)
    first = []

    def waits_so_far():       # not the mode's own notice on first use
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    def vocode(m):
        if not first:
            first.append(waits_so_far())
        return HG.generator_apply(params, h, m)[:, 0, :]

    c = HG.right_context_frames(h)
    waits = {}
    with torch.no_grad():
        for key, ctx in (("one", None), ("groups", c)):
            first.clear()
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    wavs = TI.vocode_bucketed(vocode, mel, lengths, hop,
                                              context=ctx)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                waits[key] = (waits_so_far(), first[0])
            torch.cuda.synchronize()
            waits[key + "_wavs"] = [w.cpu() for w in wavs]
            del wavs
    gap = _wav_gap(waits["groups_wavs"], waits["one_wavs"], hop)
    print(f"wav_gap groups vs one call: {gap:.4g}; sync warnings "
          f"(all, before the first vocoder call): one {waits['one']}, "
          f"groups {waits['groups']}")
    assert gap <= 7e-5
    assert waits["groups"][0] <= waits["one"][0]
    assert waits["groups"][0] == waits["groups"][1]
