"""Benchmark of the port on one CUDA card: batched inference throughput and
train-step throughput, the counterpart of the root ``bench.py`` with its
pinned workload and its one-line JSON.

    python -m tacotron2_subword_tpu_torch.bench

Workloads (PINNED, as in the root bench.py: changing a constant changes
the headline):
 1. Inference: batched free-running decode of the full-size dual-stream
    BERT-Tacotron 2, B=128, 200 steps, 6 calls back to back, bf16
    decoder, gate threshold 1.1 so no sample stops early.  audio-seconds
    = B * steps * hop / sr.
 2. Training: the full bf16 train step (forward, backward, Adam) at B=8
    and B=64, T_out=128, and at B=8 with the soft-DTW loss on (K2).
 3. Mel extraction (B=64 x 3 s), HiFi-GAN and WaveGlow synthesis (B=4 x
    256 frames, f32 and bf16).

Timing.  Calls are enqueued back to back and the window ends in
``torch.cuda.synchronize``.  The decode reads the host every
``models.tacotron2.SYNC_EVERY`` = 16 steps (has every sample stopped?),
so a call cannot run ahead of the host the way a jitted JAX call does:
the calls of a window do not overlap, and the host's launch cost is in
the wall time.

HEADLINE ``value``: audio-seconds per second of device BUSY time in one
traced window of the 6-call workload, busy being the union of the CUDA
kernel, memcpy and memset intervals (``utils.xprof``), the counterpart of
the JAX bench's 'XLA Modules' rate.  Each call of the window lies
between two marker kernels, and a trace whose calls hold unequal numbers of
device records lost some and is taken again (``_traced``).  The decode
is host-bound, so this rate is many times the wall rate; the wall rate
(median of WALL_WINDOWS windows, with their spread) and the busy share
(busy time per call over the median wall time per call; the profiler
slows the host, so the traced window's own wall is not used) are in
``extra``.  The TF32 settings in force are named in ``metric``; the
bench sets none (PyTorch's defaults).

``vs_baseline`` divides the headline by the port's own host-CPU rate on
the same machine, slope-calibrated as the root bench's: interleaved (8,
72)-step window pairs of the same B=128 decode on the CPU, in a
subprocess, the rate from each pair's (t72 - t8) slope, the median over
the pairs of a probe, and the max over three probes spread across the
bench.  Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra"}; ``extra`` holds every key of the root bench's line, plus
``infer_device_busy_share`` and ``gpu`` (the card's name and power
limit).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

INFER_BATCH = 128
INFER_STEPS = 200
INFER_REPEATS = 6
WALL_WINDOWS = 3
CPU_PROBE_STEPS = (8, 72)  # slope calibration (see --cpu-probe)
TRAIN_T_OUT = 128
TRAIN_REPEATS = 6
TRACE_ATTEMPTS = 3         # traces of a window before a loss of records fails
T_TEXT, T_SUB = 64, 32
REPO = Path(__file__).resolve().parent.parent


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(calls, dev: torch.device):
    """Enqueue every call, then wait for the device: wall s per call.  The
    outputs (device scalars) must be finite."""
    t0 = time.perf_counter()
    outs = [c() for c in calls]
    _sync(dev)
    dt = (time.perf_counter() - t0) / len(calls)
    vals = [float(o) for o in outs]
    if not np.isfinite(vals).all():
        raise FloatingPointError(f"non-finite bench output {vals}")
    return dt


def _traced(calls, dev: torch.device):
    """One window of identical calls under torch.profiler's CUDA activity,
    a marker kernel before the first call and after each: {wall_s (the
    whole window), busy_ms, span_ms, kernel_launches (the window's device
    records, markers apart), launches_per_call, attempts, parse_s (the
    trace read, outside the window)}.  A trace whose calls do not all
    hold the same number of device records lost some (``utils.xprof``):
    it is taken again, up to TRACE_ATTEMPTS times, and then the bench
    fails."""
    from tacotron2_subword_tpu_torch.utils import xprof
    if dev.type != "cuda":
        raise RuntimeError("device time needs a CUDA device")
    marked = [(lambda c=c, i=i: (i or xprof.mark(), c(), xprof.mark())[1])
              for i, c in enumerate(calls)]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with xprof.device_profile() as prof:
            t0 = time.perf_counter()
            _window(marked, dev)
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        per_call, rows = xprof.marked_window(
            xprof.device_rows(prof, markers=True), len(calls))
        s = xprof.summarize_rows(rows)
        parse_s = time.perf_counter() - t0
        if len(per_call) == len(calls) and min(per_call) == max(per_call):
            return {"wall_s": wall, "busy_ms": s.busy_ms,
                    "span_ms": s.span_ms, "kernel_launches": s.n_events,
                    "launches_per_call": per_call[0], "attempts": attempt,
                    "parse_s": parse_s}
    raise RuntimeError(f"{TRACE_ATTEMPTS} traces of {len(calls)} identical "
                       f"calls lost device records: the last one's "
                       f"records per call {per_call}")


def _build_infer(device, batch: int, cfg: Optional[TacotronConfig] = None):
    """Full-size model (weights from seed 0) and the pinned inputs on
    ``device``; returns (cfg, make_fn) where make_fn(steps)(seed) runs the
    gate-rigged decode with prenet masks from a generator seeded ``seed``
    and returns the mean of mel_postnet (a device scalar: it depends on
    every synthesized value)."""
    from tacotron2_subword_tpu_torch.models import tacotron2 as M
    dev = resolve_device(device)
    cfg = cfg or TacotronConfig()
    params, bn = M.init_tacotron2(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
    rng = np.random.RandomState(0)
    as_t = lambda a: torch.from_numpy(a).to(dev)
    text = as_t(rng.randint(0, cfg.n_symbols, (batch, T_TEXT)).astype(np.int64))
    sub = as_t(rng.randint(0, cfg.sub_n_symbols, (batch, T_SUB)
                           ).astype(np.int64))
    cls_p = as_t(rng.randn(batch, cfg.bert_embedding_dim).astype(np.float32))
    cls_s = as_t(rng.randn(batch, cfg.bert_embedding_dim).astype(np.float32))

    def make_fn(steps: int):
        @torch.inference_mode()
        def fn(seed: int):
            out = M.infer(params, bn, cfg, text, sub, cls_p, cls_s,
                          generator=torch.Generator(device=dev).manual_seed(
                              seed),
                          max_steps=steps, gate_threshold=1.1)
            return out["mel_postnet"].float().mean()
        return fn

    return cfg, make_fn


def run_infer(device=None, batch: int = INFER_BATCH,
              steps: int = INFER_STEPS, repeats: int = INFER_REPEATS,
              profile: bool = False, cfg: Optional[TacotronConfig] = None,
              wall_windows: int = WALL_WINDOWS):
    dev = resolve_device(device)
    cfg, make_fn = _build_infer(dev, batch, cfg)
    fn = make_fn(steps)
    _window([lambda: fn(1)], dev)  # warm-up: cuBLAS/cuDNN handles, plans
    audio_sec = batch * steps * cfg.hop_length / cfg.sampling_rate

    def calls(seed0):
        return [(lambda i=i: fn(seed0 + i)) for i in range(repeats)]

    if not profile:
        dt = _window(calls(2), dev)
        return {"audio_per_s_wall": audio_sec / dt,
                "us_per_step_wall": dt / steps * 1e6, "dt_wall": dt}

    # wall: median over wall_windows windows; device: ONE traced window
    walls = sorted(_window(calls(2 + 100 * w), dev)
                   for w in range(wall_windows))
    dt_med = walls[len(walls) // 2]
    tr = _traced(calls(1000), dev)
    dt_dev = tr["busy_ms"] / 1e3 / repeats
    return {
        "audio_per_s_device": audio_sec / dt_dev,
        "us_per_step_device": dt_dev / steps * 1e6,
        "audio_per_s_wall": audio_sec / dt_med,
        "us_per_step_wall": dt_med / steps * 1e6,
        "wall_window_min_s": walls[0], "wall_window_max_s": walls[-1],
        # busy per call over the median untraced wall per call: the
        # profiler slows the host, so the traced window's wall is longer
        "device_busy_share": dt_dev / dt_med,
        "traced": tr,
    }


def train_batch(cfg: TacotronConfig, device, B: int, t_out: int,
                T_text: int = T_TEXT, T_sub: int = T_SUB, seed: int = 0):
    """The root bench's train batch (its run_train): the same draws from
    RandomState(seed) in the same order; IDs and lengths int64 on
    ``device``."""
    from tacotron2_subword_tpu_torch.train_lib import make_gate_target
    rng = np.random.RandomState(seed)
    lengths = lambda T: np.clip(rng.randint(T // 2, T + 1, B), 2, T)
    b = {"text": rng.randint(0, cfg.n_symbols, (B, T_text)),
         "text_lengths": lengths(T_text),
         "sub": rng.randint(0, cfg.sub_n_symbols, (B, T_sub)),
         "sub_lengths": lengths(T_sub),
         "mels": rng.randn(B, cfg.n_mel_channels, t_out).astype(np.float32),
         "output_lengths": lengths(t_out),
         "cls_phone": rng.randn(B, cfg.bert_embedding_dim).astype(np.float32),
         "cls_sub": rng.randn(B, cfg.bert_embedding_dim).astype(np.float32)}
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    for k in ("text", "sub", "text_lengths", "sub_lengths", "output_lengths"):
        b[k] = b[k].long()
    b["gate_target"] = make_gate_target(b["output_lengths"], t_out)
    return b


def train_setup(batch: int, t_out: int, device, **cfg_overrides):
    """(cfg, state, optimizer, batch) of the pinned train workload: fresh
    params from seed 0 and ``train_batch``."""
    from tacotron2_subword_tpu_torch import train_lib as T
    dev = resolve_device(device)
    cfg = TacotronConfig(**cfg_overrides)
    state, tx = T.create_train_state(torch.Generator().manual_seed(0), cfg,
                                     device=dev)
    return cfg, state, tx, train_batch(cfg, dev, batch, t_out)


def run_train(batch: int, t_out: int = TRAIN_T_OUT,
              repeats: int = TRAIN_REPEATS, device=None, **cfg_overrides):
    """bf16 train-step throughput: (ms/step, mel frames/s).  One warm-up
    step (dropout drawn from a generator seeded 1), then ``repeats`` steps
    chained through the state, step i's dropout seeded 2 + i, ended by one
    synchronize.  ``cfg_overrides`` lets the soft-DTW variant reuse the
    pinned workload."""
    from tacotron2_subword_tpu_torch import train_lib as T
    dev = resolve_device(device)
    cfg, state, tx, batch_d = train_setup(batch, t_out, dev, **cfg_overrides)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    state, m = T.train_step(state, batch_d, cfg, tx, generator=gen(1))
    _window([lambda: m["total"]], dev)  # warm-up

    t0 = time.perf_counter()
    for i in range(repeats):
        state, m = T.train_step(state, batch_d, cfg, tx, generator=gen(2 + i))
    _sync(dev)
    dt = (time.perf_counter() - t0) / repeats
    if not np.isfinite(float(m["total"])):
        raise FloatingPointError("non-finite train loss")
    return dt * 1e3, batch * t_out / dt


def run_vocoders(batch: int = 4, frames: int = 256, repeats: int = 6,
                 device=None):
    """HiFi-GAN and WaveGlow synthesis rates in kHz of audio samples per
    second of wall time, f32 and bf16 (bf16 params and activations):
    {hifi_f32, hifi_bf16, wg_f32, wg_bf16}."""
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import waveglow as WG
    from tacotron2_subword_tpu_torch.utils.tree import cast_floats
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.randn(batch, 80, frames).astype(np.float32)
                           ).to(dev)
    khz = lambda dt: batch * frames * 256 / dt / 1e3

    h = HG.HifiganConfig()
    gen = HG.fuse_generator(HG.init_generator(torch.Generator().manual_seed(0),
                                              h, device=dev))
    rates = {}
    with torch.inference_mode():
        for name, (g, m) in {"f32": (gen, mel),
                             "bf16": (cast_floats(gen, torch.bfloat16),
                                      mel.bfloat16())}.items():
            hifi = lambda: HG.generator_apply(g, h, m).float().mean()
            _window([hifi], dev)  # warm-up
            rates[f"hifi_{name}"] = khz(_window([hifi] * repeats, dev))

        wcfg = WG.WaveGlowConfig()
        wg = WG.init_waveglow(torch.Generator().manual_seed(1), wcfg,
                              device=dev)
        for name, (g, m) in {"f32": (wg, mel),
                             "bf16": (cast_floats(wg, torch.bfloat16),
                                      mel.bfloat16())}.items():
            wg_call = lambda seed: WG.infer(
                g, wcfg, m, sigma=0.6, generator=torch.Generator(
                    device=dev).manual_seed(seed)).float().mean()
            _window([lambda: wg_call(2)], dev)  # warm-up
            rates[f"wg_{name}"] = khz(_window(
                [(lambda i=i: wg_call(3 + i)) for i in range(repeats)], dev))
    return rates


def run_mel_extraction(batch: int = 64, seconds: float = 3.0,
                       repeats: int = 6, device=None):
    """Batch mel extraction: [B, T] waveform -> log-mel by the framed-matmul
    STFT (``ops/stft.mel_spectrogram``).  The device-busy rate of one
    traced window beside the wall rate, in audio-seconds per second and us
    per mel frame."""
    from tacotron2_subword_tpu_torch.ops import stft as S
    dev = resolve_device(device)
    T = int(seconds * 22050) // 256 * 256
    rng = np.random.RandomState(0)
    wav = torch.from_numpy((rng.randn(batch, T) * 0.1).astype(np.float32)
                           ).to(dev)
    fn = torch.inference_mode()(lambda: S.mel_spectrogram(wav).mean())
    _window([fn], dev)  # warm-up
    audio_sec = batch * T / 22050.0
    n_frames = batch * (T // 256 + 1)
    wall = _window([fn] * repeats, dev)
    tr = _traced([fn] * repeats, dev)
    dt_dev = tr["busy_ms"] / 1e3 / repeats
    return {
        "audio_per_s_device": audio_sec / dt_dev,
        "us_per_frame_device": dt_dev * 1e6 / n_frames,
        "audio_per_s_wall": audio_sec / wall,
        "batch": batch, "samples": T, "traced": tr,
    }


def run_cpu_probe(batch: int = INFER_BATCH, pairs: int = 5):
    """Slope-calibrated host-CPU baseline of the port: INTERLEAVED (t_lo,
    t_hi) window pairs of the B=``batch`` decode on the CPU, the rate from
    each pair's time difference, the median over pairs (the slope cancels
    the per-call fixed cost of the encoders; interleaving puts both
    windows of a pair under the same host speed).  Prints one JSON line."""
    cpu = torch.device("cpu")
    cfg, make_fn = _build_infer(cpu, batch)
    s1, s2 = CPU_PROBE_STEPS
    fn_lo, fn_hi = make_fn(s1), make_fn(s2)
    fn_lo(1), fn_hi(1)  # warm-up
    audio_per_step = batch * cfg.hop_length / cfg.sampling_rate
    slopes, pair_times = [], []
    for k in range(pairs):
        t_lo = _window([lambda: fn_lo(2 + k)], cpu)
        t_hi = _window([lambda: fn_hi(2 + k)], cpu)
        slopes.append((s2 - s1) * audio_per_step / (t_hi - t_lo))
        pair_times.append((round(t_lo, 4), round(t_hi, 4)))
    slopes.sort()
    print(json.dumps({
        "cpu_audio_per_s_slope": slopes[len(slopes) // 2],
        "slope_spread": [round(slopes[0], 2), round(slopes[-1], 2)],
        "t_probe_s": pair_times,
        "cpu_audio_per_s_window8": s1 * audio_per_step / pair_times[0][0],
        "threads": torch.get_num_threads(),
    }))


def gpu_name_and_power() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def tf32_settings() -> str:
    return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"TF32 cuDNN {torch.backends.cudnn.allow_tf32}")


def main():
    # the CPU baseline runs in subprocesses (the CPU is asked for
    # explicitly there), three probes spread across the bench, the
    # baseline the max of their medians: the host's best sustained speed
    probe_rates, cpu = [], {}

    def probe(timeout):
        nonlocal cpu
        try:
            out = subprocess.run(
                [sys.executable, "-m", "tacotron2_subword_tpu_torch.bench",
                 "--cpu-probe"],
                capture_output=True, text=True, timeout=timeout, cwd=REPO)
            cpu = json.loads(out.stdout.strip().splitlines()[-1])
            probe_rates.append(float(cpu["cpu_audio_per_s_slope"]))
        except (subprocess.TimeoutExpired, ValueError, IndexError, KeyError):
            # a lost probe must not lose the card's numbers: the
            # max-of-medians baseline tolerates a missing sample
            print("bench: a CPU probe was lost", file=sys.stderr)

    gpu = gpu_name_and_power()
    probe(3600)
    infer = run_infer(None, INFER_BATCH, INFER_STEPS, INFER_REPEATS,
                      profile=True)
    train8 = run_train(8)
    train64 = run_train(64)
    # the soft-DTW mel loss on (K2): the delta against train8's ms is the
    # cost of the loss term
    sdtw8 = run_train(8, softdtw_loss_weight=1.0)
    melx = run_mel_extraction()
    probe(900)
    voc = run_vocoders()
    probe(900)
    print(json.dumps(bench_line(infer, train8, train64, sdtw8, melx, voc,
                                probe_rates, cpu, gpu)))


def bench_line(infer, train8, train64, sdtw8, melx, voc, probe_rates, cpu,
               gpu) -> dict:
    """The bench's JSON line from the run_* results: ``train*`` are
    (ms/step, frames/s), ``probe_rates`` the CPU probes' slope medians,
    ``cpu`` the last probe's line."""
    rate = infer["audio_per_s_device"]
    cpu_rate = float(max(probe_rates)) if probe_rates else float("nan")
    vs = rate / cpu_rate if np.isfinite(cpu_rate) else float("nan")
    return {
        "metric": ("mel audio-seconds synthesized/sec/card, CUDA busy time "
                   "(union of kernel intervals) "
                   f"(B={INFER_BATCH} steps={INFER_STEPS} x{INFER_REPEATS} "
                   f"batched inference, bf16 decoder; {tf32_settings()})"),
        "value": round(rate, 3),
        "unit": "audio_sec/s",
        "vs_baseline": round(vs, 3) if np.isfinite(vs) else None,
        "extra": {
            "infer_us_per_step_device": round(
                infer["us_per_step_device"], 2),
            "infer_audio_per_s_wall_median": round(
                infer["audio_per_s_wall"], 1),
            "infer_us_per_step_wall_median": round(
                infer["us_per_step_wall"], 2),
            "infer_wall_window_spread_s": [
                round(infer["wall_window_min_s"], 3),
                round(infer["wall_window_max_s"], 3)],
            "infer_device_busy_share": round(
                infer["device_busy_share"], 4),
            "cpu_baseline_audio_per_s_slope": round(cpu_rate, 2)
                if np.isfinite(cpu_rate) else None,
            "cpu_probe_medians": [round(r, 2) for r in probe_rates],
            "cpu_probe_windows_s": cpu.get("t_probe_s"),
            "train_ms_per_step_B8": round(train8[0], 2),
            "train_frames_per_s_B8": round(train8[1], 1),
            "train_ms_per_step_B64": round(train64[0], 2),
            "train_frames_per_s_B64": round(train64[1], 1),
            "train_ms_per_step_B8_softdtw": round(sdtw8[0], 2),
            "train_workload": f"bf16 fwd+bwd+Adam, T_out={TRAIN_T_OUT}, "
                              f"x{TRAIN_REPEATS} chained steps",
            "mel_extract_audio_per_s_device": round(
                melx["audio_per_s_device"], 1),
            "mel_extract_us_per_frame_device": round(
                melx["us_per_frame_device"], 3),
            "mel_extract_audio_per_s_wall": round(
                melx["audio_per_s_wall"], 1),
            "mel_extract_workload": (
                f"B={melx['batch']} x {melx['samples']} samples, "
                "mel_spectrogram (framed-matmul STFT)"),
            "hifigan_synthesis_khz": round(voc["hifi_f32"], 1),
            "hifigan_synthesis_khz_bf16": round(voc["hifi_bf16"], 1),
            "waveglow_synthesis_khz": round(voc["wg_f32"], 1),
            "waveglow_synthesis_khz_bf16": round(voc["wg_bf16"], 1),
            "waveglow_vs_v100_1200khz": round(voc["wg_bf16"] / 1200.0, 2),
            "gpu": gpu,
        },
    }


if __name__ == "__main__":
    if "--cpu-probe" in sys.argv:
        # the same batch as the card's run, short step counts: the
        # (8, 72)-step slope is the per-step decode rate with the per-call
        # fixed cost cancelled
        run_cpu_probe()
    else:
        main()
