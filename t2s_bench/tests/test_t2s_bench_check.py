"""The output check at a size a test run holds, on the CPU: a sound run is
correct; the control (the reference at the configuration's control
precision in the program's place) fails one of the cell's limits; and each
fault that a served batch can have, planted in the timed path, makes the
run incorrect.  The limits are the full cell's (``sma-v1.synth-b256`` for
"tiny", ``lsa-v2.synth-b1024`` for "tiny-lsa")."""

from __future__ import annotations

import pytest
import torch

from t2s_bench import layout, run as R
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as M

SEED = 2 ** 31 + 99


def _run(root, name="tiny", **kw):
    return R.run(layout.cell(name, root), SEED, 0.0, False, device="cpu",
                 root=root, **kw)


@pytest.mark.parametrize("name", ["tiny", "tiny-lsa"])
def test_sound_run_is_correct_and_control_is_not(bench_copy, name):
    res = _run(bench_copy, name, control=True)
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, (
        res["control"], layout.workload(name, bench_copy)["limits"])


def _patch_out(monkeypatch, mod, name, edit):
    real = getattr(mod, name)

    def broken(*a, **k):
        out = real(*a, **k)
        edit(out)
        return out
    monkeypatch.setattr(mod, name, broken)


def _frame(out):          # one served decoder frame altered
    out["mel"][:, :, 3] += 1.0


def _rows_swapped(out):   # answers handed to the wrong requests
    for k in ("mel", "mel_postnet", "gate"):
        out[k] = out[k].roll(1, dims=0)


def _stop_moved(out):     # one sentence cut a frame short
    out["mel_lengths"][0] -= 1


def _wav(out):            # one stretch of every wav altered
    out[:, :, 2000:2256] *= 0.5


@pytest.mark.parametrize("where, edit", [
    ("decoder_infer", _frame), ("infer", _rows_swapped),
    ("decoder_infer", _stop_moved), ("generator_apply", _wav)])
def test_a_planted_fault_is_caught(bench_copy, monkeypatch, where, edit):
    mod = HG if where == "generator_apply" else M
    _patch_out(monkeypatch, mod, where, edit)
    res = _run(bench_copy)
    assert not res["correct"], res["checks"]


def test_prenet_masks_not_redrawn_is_caught(bench_copy, monkeypatch):
    """A serving generator that is not the one whose state the check
    reads: the masks differ, the decoder's frames do not follow (shown on
    the LSA cell, whose mel limit is the tighter)."""
    real = M.decoder_infer

    def other_masks(*a, generator=None, **k):
        g = torch.Generator(device="cpu")
        g.manual_seed(7)
        return real(*a, generator=g, **k)
    monkeypatch.setattr(M, "decoder_infer", other_masks)
    res = _run(bench_copy, "tiny-lsa")
    assert not res["correct"], res["checks"]


def test_a_traced_run_reports_its_cells_metrics(bench_copy):
    """The metrics BENCHMARK.json lists for the cell, where their readers
    find something: on the CPU, no device trace, so only the spans, the
    clock and the program's spans and counters over the window."""
    res = R.run(layout.cell("tiny-lsa", bench_copy), SEED, 0.0, True,
                device="cpu", root=bench_copy)
    assert set(res["metrics"]) == {"decode_us_per_step.synth",
                                   "vocoder_ms_per_audio_s.synth",
                                   "mfu.synth",
                                   "decode_host_us_per_step.synth",
                                   "decode_live_share.synth",
                                   "vocoder_live_share.synth"}


@pytest.mark.cuda
def test_tiny_cell_on_card(bench_copy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = R.run(layout.cell("tiny", bench_copy), SEED, 0.5, True,
                root=bench_copy, control=True)
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, res["control"]
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
