#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (tacotron2_subword_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  It builds every kernel of
the port from ``tacotron2_subword_tpu_torch/csrc``, holds each kernel against
its plain torch version on the card, serves a few requests through the
port's main path (int8 decode -> postnet -> HiFi-GAN) at full width, checks
the kernel's launch count, and compares the whole decode on the card with
the same decode on the CPU.  Any failure raises, so the exit code is not 0.
The last line is one JSON object naming the device.  Without a card it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BF16_PEAK = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
F32_PEAK = 67e12     # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12     # bytes/s


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed between CUDA events, so the host's launch cost is
    not in the time.  Back to back, so inputs that fit stay in L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound_ms(S, B, K, N, x_dtype):
    """Least time for one K1 call: each input read once and the output
    written once at the HBM rate, or its FLOPs at the peak of x's type."""
    xb = 2 if x_dtype == torch.bfloat16 else 4
    nbytes = S * B * K * xb + S * K * N + S * N * 4 + S * B * N * 4
    flops = 2 * S * B * K * N
    peak = BF16_PEAK if x_dtype == torch.bfloat16 else F32_PEAK
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_k1(Q, dev):
    """K1 against its plain version at the main path's shapes and at ragged
    ones, with times.  Tolerance: both versions sum the same products in
    f32 (bf16 x int8 products are exact in f32), so only the order of the
    sum differs: max|d| <= 1e-4 * max|ref| (f32 x), 2e-3 * max|ref| (bf16 x).
    """
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    cases = [(S, K, N, B, dt)
             for (S, K, N) in ((2, 1792, 4096), (1, 4096, 4096))
             for B in (1, 4, 8, 128)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 46, 80, 3, torch.float32), (2, 46, 80, 3, torch.bfloat16),
              (1, 37, 83, 5, torch.bfloat16), (3, 300, 130, 9, torch.float32)]
    for S, K, N, B, dt in cases:
        x = torch.randn((S, B, K), generator=gen, device=dev).to(dt)
        w = torch.randn((S, K, N), generator=gen, device=dev)
        w_q, scale = Q.quantize_int8(w, axis=1)
        y = Q.matmul_dequant_int8(x, w_q, scale)
        ref = Q.matmul_dequant_int8_plain(x, w_q, scale)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        tol = (1e-4 if dt == torch.float32 else 2e-3) * ref_max
        if not (y.shape == ref.shape and err <= tol):
            raise AssertionError(
                f"K1 disagrees at S={S} B={B} K={K} N={N} {dt}: "
                f"max|d|={err} > tol {tol}")
        row = {"S": S, "B": B, "K": K, "N": N,
               "x": "bf16" if dt == torch.bfloat16 else "f32",
               "max_abs_err": err, "tol": tol}
        if K >= 1792:
            iters = 20 if B >= 128 else 50
            row["ms"] = device_ms(lambda: Q.matmul_dequant_int8(x, w_q, scale),
                                iters)
            row["plain_ms"] = device_ms(
                lambda: Q.matmul_dequant_int8_plain(x, w_q, scale), iters)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(S, B, K, N, dt)
            lib_fn, row["library"] = library_call(x, w_q, scale)
            row["library_ms"] = (device_ms(lib_fn, iters)
                                 if lib_fn is not None else None)
            # a dense cuBLAS matmul on a weight dequantized in advance
            # (twice the weight bytes in bf16), for scale
            w_deq = (w_q.to(torch.float32) * scale[:, None, :]).to(dt)
            row["dense_bmm_ms"] = device_ms(lambda: torch.bmm(x, w_deq),
                                            iters)
        rows.append(row)
        print("K1", json.dumps(row))
    return rows


def library_call(x, w_q, scale):
    """PyTorch's own int8 weight-only matmul, for timing only (the port
    never calls it): torch._weight_int8pack_mm, one call per stack entry
    (it is 2-D), where this PyTorch has it on CUDA for x's dtype.  Returns
    (fn, name) or (None, reason)."""
    if not hasattr(torch, "_weight_int8pack_mm"):
        return None, "no torch._weight_int8pack_mm"
    w_nk = [w_q[s].t().contiguous() for s in range(x.shape[0])]
    sc = [scale[s].to(x.dtype) for s in range(x.shape[0])]
    fn = lambda: [torch._weight_int8pack_mm(x[s], w_nk[s], sc[s])
                  for s in range(x.shape[0])]
    try:
        fn()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch._weight_int8pack_mm refused: {str(e)[:80]}"
    return fn, "torch._weight_int8pack_mm x S"


REQUESTS = ((64, 32), (48, 24), (33, 17), (17, 9))  # phone / subword ids


def make_requests(cfg, lengths, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.n_symbols, n), rng.randint(0, cfg.sub_n_symbols, m),
             rng.randn(cfg.bert_embedding_dim).astype(np.float32),
             rng.randn(cfg.bert_embedding_dim).astype(np.float32))
            for n, m in lengths]


def phase_serve(Q, TM, TI, params, bn, gen_params, cfg, h, dev, gpu):
    """The main path at full width: 4 requests served end to end (int8
    decode -> postnet -> HiFi-GAN), with K1's launches counted; then the
    bench-shaped batch, B=128 x 200 steps, decode only."""
    reqs = make_requests(cfg, REQUESTS, seed=1)
    serve = lambda seed, steps: TI.synthesize(
        params, bn, gen_params, cfg, h, reqs,
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev,
        max_steps=steps, gate_threshold=1.1)
    serve(0, 16)  # warm-up: cuBLAS/cuDNN handles and plans
    torch.cuda.synchronize()

    Q.launches = 0
    t0 = time.perf_counter()
    out = serve(1, 200)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = Q.launches

    steps = out["steps_run"]
    if launches != 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             f"decoder steps; want 2 per step")
    frames = out["mel_lengths"].tolist()
    if not torch.isfinite(out["mel_postnet"]).all():
        raise AssertionError("non-finite mel")
    for f, w in zip(frames, out["wavs"]):
        if w.shape != (max(f, 8) * cfg.hop_length,) or not torch.isfinite(w).all():
            raise AssertionError(f"bad waveform {tuple(w.shape)} for {f} frames")
    audio_s = sum(w.numel() for w in out["wavs"]) / cfg.sampling_rate
    print(f"serve: {len(reqs)} requests, {steps} decoder steps, frames "
          f"{frames}, K1 launches {launches}; {serve_s:.4f} s wall for "
          f"{audio_s:.3f} s of audio = {audio_s / serve_s:.3f} audio-s/s "
          f"({gpu})")

    # decode alone at the served batch, then the bench-shaped batch
    def decode(batch_reqs, seed):
        args = TI.pad_requests(batch_reqs, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = TM.infer(params, bn, cfg, *args[:4], text_lengths=args[4],
                     sub_lengths=args[5], max_steps=200, gate_threshold=1.1,
                     generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(o["mel_postnet"]).all():
            raise AssertionError("non-finite mel")
        B = len(batch_reqs)
        return {"B": B, "steps": o["steps_run"], "s": dt,
                "us_per_step": dt / o["steps_run"] * 1e6,
                "audio_s_per_s": B * o["steps_run"] * cfg.hop_length
                / cfg.sampling_rate / dt, "gpu": gpu}
    for row in (decode(reqs, 2),
                decode(make_requests(cfg, [(64, 32)] * 128, seed=3), 4)):
        print("decode", json.dumps(row))
    return launches


PROFILE_STEPS = 32


def phase_profile(TM, TI, params, bn, cfg, dev):
    """Where a decode step's time goes (torch.profiler, CUDA activity): the
    decoder loop alone at B=4 and B=128, its wall time per step, the
    device-busy share of that wall time, and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for lengths in (REQUESTS, [(64, 32)] * 128):
        text, sub, cls_p, cls_s, t_len, s_len = TI.pad_requests(
            make_requests(cfg, lengths, seed=7), dev)
        dtype = TM._compute_dtype(cfg)
        with torch.inference_mode():
            mem = TM._encode_stream(params["encoder"], bn["encoder"],
                                    params["embedding"], text, t_len, cls_p,
                                    params["linear_converter"], dtype)
            mem_b = TM._encode_stream(
                params["encoder_sub"], bn["encoder_sub"],
                params["embedding_sub"], sub, s_len, cls_s,
                params["linear_converter_sub"], dtype)

        def run():
            with torch.inference_mode():
                TM.decoder_infer(
                    params["decoder"], cfg, mem, mem_b, max_steps=PROFILE_STEPS,
                    gate_threshold=1.1, text_lengths=t_len,
                    sub_lengths=s_len,
                    generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
        run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kern)
        top = sorted(kern, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        print("profile", json.dumps({
            "B": len(lengths), "steps": PROFILE_STEPS,
            "wall_us_per_step": wall / PROFILE_STEPS * 1e6,
            "device_us_per_step": dev_us / PROFILE_STEPS,
            "device_busy_share": dev_us / (wall * 1e6),
            "kernel_launches_per_step": sum(e.count for e in kern) / PROFILE_STEPS,
            "top_kernels_us_per_step": [
                [e.key[:70], e.self_device_time_total / PROFILE_STEPS] for e in top],
        }))


def phase_whole_path(TM, TI, params_cpu, bn_cpu, cfg, dev):
    """The same weights in f32 (prenet dropout off), 50 decoder steps at
    B=2: the card (K1) against the CPU (the plain version).  Both sides are
    f32; they sum in other orders and the recurrence carries the
    difference, so: max|d| <= 1e-3 * max|ref| on mel_postnet, <= 1e-3 on
    the alignments (which lie in [0, 1])."""
    from tacotron2_subword_tpu_torch.utils.tree import to_device
    cfg32 = cfg.replace(compute_dtype="float32", prenet_dropout_always_on=False)
    reqs = make_requests(cfg32, REQUESTS[:2], seed=5)
    outs = {}
    for name, d, p, b in (("cuda", dev, to_device(params_cpu, dev),
                           to_device(bn_cpu, dev)),
                          ("cpu", torch.device("cpu"), params_cpu, bn_cpu)):
        args = TI.pad_requests(reqs, d)
        outs[name] = TM.infer(p, b, cfg32, *args[:4], text_lengths=args[4],
                              sub_lengths=args[5], max_steps=50,
                              gate_threshold=1.1)
    errs = {}
    for k, rel in (("mel_postnet", True), ("alignments", False),
                   ("alignments_bert", False)):
        a, ref = outs["cuda"][k].cpu(), outs["cpu"][k]
        err = (a - ref).abs().max().item()
        tol = 1e-3 * (ref.abs().max().item() if rel else 1.0)
        errs[k] = err
        if not (a.shape == ref.shape and err <= tol):
            raise AssertionError(f"whole path: {k} max|d|={err} > {tol}")
    if not torch.equal(outs["cuda"]["mel_lengths"].cpu(),
                       outs["cpu"]["mel_lengths"]):
        raise AssertionError("whole path: mel_lengths differ")
    print("whole path (f32, B=2, 50 steps, card vs CPU):", json.dumps(errs))
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.ops import _build
    from tacotron2_subword_tpu_torch.ops import quant as Q
    from tacotron2_subword_tpu_torch.utils.tree import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power()

    # 1. build every kernel from csrc/
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, rep in reports.items():
        used = [l.split("info    :")[-1].strip() for l in rep.splitlines()
                if "Used" in l]
        print(f"build {name}: {len(used)} kernels; ptxas: {sorted(set(used))}")
    print(f"build: {build_s:.2f} s; torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}); gpu: {gpu}")

    # 2. each kernel against its plain version
    k1_rows = phase_k1(Q, dev)

    # 3. the main path at full width, launches counted
    cfg = TacotronConfig(decode_quant="int8")
    h = HG.HifiganConfig()
    gen = torch.Generator().manual_seed(0)
    params_cpu, bn_cpu = TM.init_tacotron2(gen, cfg, device="cpu")
    gen_params = HG.fuse_generator(HG.init_generator(gen, h, device=dev))
    params, bn = to_device(params_cpu, dev), to_device(bn_cpu, dev)
    launches = phase_serve(Q, TM, TI, params, bn, gen_params, cfg, h, dev,
                           gpu)
    phase_profile(TM, TI, params, bn, cfg, dev)

    # 4. the whole decode on the card against the CPU
    phase_whole_path(TM, TI, params_cpu, bn_cpu, cfg, dev)

    # 5. the kernels line: K1 per decoder step of the served batch (B=4,
    #    bf16 x): the attention-LSTM call plus the decoder-LSTM call
    step = [r for r in k1_rows if r["B"] == len(REQUESTS) and r["x"] == "bf16"
            and "ms" in r]
    k1 = {"name": "dequant_int8_matmul", "route": "cuda",
          "source": "tacotron2_subword_tpu_torch/csrc/dequant_int8_matmul.cu",
          "replaces": "tacotron2_subword_tpu/ops/quant.py:74",
          "launches": launches,
          "max_abs_err": max(r["max_abs_err"] for r in step)}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [r[key] for r in step]
        k1[key] = None if None in vals else sum(vals)
    k1["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in step) \
        else "operations"
    k1["per"] = ("decoder step at B=4, bf16 x: (S=2,K=1792,N=4096) + "
                 "(S=1,K=4096,N=4096)")
    print(json.dumps({"kernels": [k1]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
