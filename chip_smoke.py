#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (tacotron2_subword_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc).  It builds every kernel of
the port from ``tacotron2_subword_tpu_torch/csrc`` and drives every path of
the port at full width:

 - serving: K1 against its plain version (two runs bit-equal, its PTX
   holding mma.sync, warm and cold-L2 times), K4 (HiFi-GAN's convolution
   epilogue) bit-equal to its plain version and timed, 4 requests served (int8
   decode -> postnet -> HiFi-GAN) with K1's launches counted, one served
   V1 group (32 x 880 frames, TF32 allowed) on the channels-last path
   against the generator path with K4's launches counted, a profile of
   the decode loop (no split-K reduce kernel), the served decode as CUDA
   graph replays bit-equal to the eager loop (``phase_decode_graph``,
   K1 counted), the f32 decode on the card
   against the CPU, and the cost of the f32 LSTM gates on the
   non-quantized bf16 decode;
 - training: K2 (both variants: shared memory, and the global one forced)
   and K3 against their plain versions (bit-equal across two runs; K3
   bit-equal to its plain version at every shape), K3's plan, registers and
   spills, K3 against the plain version at the small shapes (device and
   host wall time: the crossover for softdtw_impl="auto"), the
   soft-DTW train step (B=8, T_out=128, bench.py's batch) with K2's and
   K3's launches counted, a profile of one step, one f32 train step on the
   card against the CPU, and the training CLI up to validation;
 - training on a reference-format corpus on disk (``phase_train_real``):
   the training CLI at full width with soft-DTW, SSIM and the alignment
   loss, validation, checkpoints and checkpoint_best, a profiler trace,
   resume (the loaded state bit-equal to the checkpoint), warm start,
   K2's and K3's launches counted, prefetch on and off timed, and SSIM
   on the card against the CPU;
 - the text -> wav CLI (``apps/inference.run_inference``): 4 script lines
   through the G2P front end, the int8 decode (200 steps each, K1's
   launches counted), HiFi-GAN v1 and bias removal, with each line's time
   split by stage; one line through Griffin-Lim with its spectral
   convergence; one f32 line on the card against the CPU;
 - the after-training pipeline (``phase_after_training``): GTA mels of a
   seeded corpus at B=16 (one f32 batch card vs CPU), HiFi-GAN v1 with MPD
   + MSD trained on them at B=16 (checkpoints, resume bit for bit,
   --mel-only, D / G step times, one f32 step card vs CPU), the inference
   CLI with that generator, remove_silence, the MCD / soft-DTW evaluation
   (K3 once per file, up to 19 s wavs, held to its plain version) and the
   int8 checkpoint sweep (K1 counted);
 - the five attention variants other than SMA
   (``phase_attention_variants``): each served (K1 counted), profiled,
   decoded in f32 and differentiated in f32 on the card against the CPU,
   and trained one soft-DTW step (K2, K3 counted); one inference CLI line
   from a DCA checkpoint;
 - the other vocoders and the tool CLIs (``phase_vocoders_and_tools``):
   WaveGlow at the published widths (synthesis in f32 and bf16 at B=1 and
   4 against its FLOP bound, card vs CPU, the three reference layouts,
   train_waveglow with checkpoints and resume), the ONNX HiFi-GAN (the
   port's exporter, its executor on the card against the native generator,
   one int8 CLI line with K1 counted), and preprocess, dump_phone_id_map,
   check_bert_emb and the demo (int8, K1 counted);
 - multi-rank training (``phase_multi_rank``): the training CLI under
   torch.distributed.run on one NCCL rank against the plain CLI, then
   meshes (2, 1), (1, 2) and (2, 2) of ranks sharing the card over one gloo
   group, each held to the single-process step (loss, gradients, BN
   statistics), with K2 and K3 counted on every rank, per-rank peak memory
   and the stored bytes of the model-axis slices;
 - the synthetic-corpus tools (``phase_synthetic_tools``):
   make_synthetic_dataset (its mel against ops/stft on the card), the
   training CLI on that corpus (K2 per step, K3 per validation batch),
   eval_synthetic's int8 sweep of its checkpoints (K1 counted, the resumed
   sweep skipping every row, one f32 row card vs CPU) and
   gan_batch_scaling at B = 4, 16, 32;
 - the measurement layer (``phase_measurement``): the port's bench at
   its pinned workload (busy <= span <= wall, up to the clocks'
   disagreement, in every traced window; equal records per call; K2
   counted in its soft-DTW train run, its JSON keys against bench.py's),
   train_step_profile (K2 per step in its table; the decode's launches
   per step against the profile above), serving_latency on a timer-gated
   checkpoint (int8, K1 counted), kernel_evidence (exit code 0),
   gta_vocoder_smoke and infer_wav_demo on the synthetic corpus, and K1,
   K2, K3 named in a trace of a CUDA-graph replay.

``python3 chip_smoke.py --bench`` runs the port's whole bench (``python -m
tacotron2_subword_tpu_torch.bench``, its three CPU probes included) and
prints its line; ``--k1-splits`` builds the kernels and times K1 at
every number of K splits instead (the table behind ``ops/quant.k1_plan``);
``--cli-nondeterminism`` runs the training CLI of ``phase_multi_rank``
twice with PyTorch's default algorithms and prints how far its losses
move run to run; ``--gan-grad-trace`` splits the f32 GAN step's generator
gradient, card against CPU, by loss term, with cuDNN on and off
(``gan_grad_trace``).

Any failure raises, so the exit code is not 0.  The line before the last
names the card and its power limit; the last is one JSON object naming the
device.  Without a card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tacotron2_subword_tpu_torch.bench import train_batch

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


def cold_ms(fn, iters: int = 20) -> float:
    """Median device ms of one call of ``fn`` with a cold L2: 256 MB (five
    times the 50 MB L2) are written before each call, and CUDA events
    bracket the call alone.  A 0.5 ms spin after the memset keeps the card
    busy while the host queues the events and the call behind it, so no
    host time falls between the events."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)   # ~0.5 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return float(np.median(times))


def phase_k1(Q, dev):
    """K1 against its plain version at the main path's shapes and at ragged
    ones, with times.  Tolerance: both versions sum the same products in
    f32 (bf16 x int8 products are exact in f32), so only the order of the
    sum differs: max|d| <= 1e-4 * max|ref| (f32 x), 2e-3 * max|ref| (bf16 x:
    tensor-core sums).  Each case runs twice and must be bit-equal.  The
    bf16 kernel's PTX must hold mma.sync (or wgmma).  Warm times are CUDA-
    graph replays (the weights stay in L2), cold ones flush L2 first."""
    from tacotron2_subword_tpu_torch.ops import _build
    ptx = _build.ptx(Q.KERNEL)
    mma = {"mma.sync": ptx.count("mma.sync"), "wgmma": ptx.count("wgmma")}
    if not (mma["mma.sync"] or mma["wgmma"]):
        raise AssertionError("K1's PTX holds no mma.sync / wgmma")
    print("K1 ptx", json.dumps(mma))
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    cases = [(S, K, N, B, dt)
             for (S, K, N) in ((2, 1792, 4096), (1, 4096, 4096))
             for B in (1, 4, 8, 128)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 46, 80, 3, torch.float32), (2, 46, 80, 3, torch.bfloat16),
              (1, 37, 83, 5, torch.bfloat16), (3, 300, 130, 9, torch.float32),
              (3, 300, 130, 9, torch.bfloat16),
              (2, 1792, 4096, 129, torch.bfloat16)]
    for S, K, N, B, dt in cases:
        x = torch.randn((S, B, K), generator=gen, device=dev).to(dt)
        w = torch.randn((S, K, N), generator=gen, device=dev)
        w_q, scale = Q.quantize_int8(w, axis=1)
        y = Q.matmul_dequant_int8(x, w_q, scale)
        y_again = Q.matmul_dequant_int8(x, w_q, scale)
        ref = Q.matmul_dequant_int8_plain(x, w_q, scale)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        tol = (1e-4 if dt == torch.float32 else 2e-3) * ref_max
        if not (y.shape == ref.shape and err <= tol):
            raise AssertionError(
                f"K1 disagrees at S={S} B={B} K={K} N={N} {dt}: "
                f"max|d|={err} > tol {tol}")
        if not torch.equal(y, y_again):
            raise AssertionError(f"K1 not deterministic at S={S} B={B} "
                                 f"K={K} N={N} {dt}")
        row = {"S": S, "B": B, "K": K, "N": N,
               "x": "bf16" if dt == torch.bfloat16 else "f32",
               "max_abs_err": err, "tol": tol}
        if K >= 1792 and B <= 128:
            iters = 20 if B >= 128 else 50
            row["ms"] = device_ms(lambda: Q.matmul_dequant_int8(x, w_q, scale),
                                iters)
            row["cold_ms"] = cold_ms(
                lambda: Q.matmul_dequant_int8(x, w_q, scale))
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


# V1's largest stage in a served group: the last stage of 32 rows x 880
# frames (x 256 samples a frame), 32 channels
K4_STAGE = (32 * 880 * 256, 32)


def phase_conv_epilogue(EP, dev):
    """K4 (HiFi-GAN's channels-last convolution epilogue) against its plain
    version in each mode the generator uses, at 16-byte (C % 4 == 0) and
    4-byte (ragged C) accesses: bit-equal (the same f32 operations in the
    same order), one launch a call.  Then, at V1's largest stage shape
    (``K4_STAGE``, where the grid-stride loop makes about 54 turns), in
    the resblocks' two commonest modes: bit-equal again, and its time
    beside its HBM-byte bound (each tensor it reads or writes once) and
    the plain version's time.  The operands (0.9 GB each) do not fit in
    L2."""
    gen = torch.Generator(device=dev).manual_seed(4)
    # mode -> (the operands it reads besides y, the outputs it writes,
    # further arguments)
    modes = {"residual": (("residual",), ("out_pre", "out_act"), {}),
             "mrf_add": (("residual", "mrf_sum"), ("out_pre",), {}),
             "mrf_average": (("residual", "mrf_sum"), ("out_act",),
                             {"mrf_div": 3}),
             "lrelu_0.01": ((), ("out_act",), {"slope": 0.01}),
             "tanh": ((), ("out_act",), {"act": "tanh"})}

    def args(mode, y, r, s):
        reads, writes, extra = modes[mode]
        given = {"residual": r, "mrf_sum": s}
        return {**{k: given[k] for k in reads},
                **{k: torch.empty_like(y) for k in writes}, **extra}
    for R, C in ((4096, 32), (999, 13), (7, 1)):
        y, r, s = (torch.randn((R, C), generator=gen, device=dev) * 3
                   for _ in range(3))
        b = torch.randn((C,), generator=gen, device=dev)
        for mode, (_, writes, _) in modes.items():
            kw, kw_plain = args(mode, y, r, s), args(mode, y, r, s)
            before = EP.launches
            EP.conv_epilogue(y, b, **kw)
            EP.conv_epilogue_plain(y, b, **kw_plain)
            torch.cuda.synchronize()
            if EP.launches != before + 1 or not all(
                    torch.equal(kw[k], kw_plain[k]) for k in writes):
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at R={R} C={C} {mode}")
    R, C = K4_STAGE
    y, r, s = (torch.randn((R, C), generator=gen, device=dev)
               for _ in range(3))
    b = torch.randn((C,), generator=gen, device=dev)
    rows = []
    for mode in ("residual", "mrf_average"):
        kw, kw_plain = args(mode, y, r, s), args(mode, y, r, s)
        EP.conv_epilogue(y, b, **kw)
        EP.conv_epilogue_plain(y, b, **kw_plain)
        torch.cuda.synchronize()
        if not all(torch.equal(kw[k], kw_plain[k]) for k in modes[mode][1]):
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"R={R} C={C} {mode}")
        del kw_plain
        tensors = 1 + len(modes[mode][0]) + len(modes[mode][1])
        row = {"R": R, "C": C, "mode": mode, "tensors": tensors,
               "ms": device_ms(lambda: EP.conv_epilogue(y, b, **kw), 10),
               "plain_ms": device_ms(
                   lambda: EP.conv_epilogue_plain(y, b, **kw), 10),
               "bound_ms": (tensors * R * C + C) * 4 / HBM_BW * 1e3,
               "bound_by": "bytes"}
        row["roofline"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print("K4", json.dumps(row))
        del kw
    return rows


# a served group of the sma cell: 32 rows x 880 frames at V1's widths
SERVED_GROUP = (32, 880)


def phase_served_vocoder(EP, HG, dev):
    """The vocoder as ``synthesize`` serves it, and as the benchmark runs
    it: V1 at its published widths and torch's default weight scale, one
    ``SERVED_GROUP`` mel, under ``inference_mode`` with cuDNN's TF32
    allowed (torch's default; the rest of the smoke runs strict f32), so
    ``generator_apply`` takes the channels-last path.  K4's launches are
    counted from 0 over that one call (after a warm-up call): one a
    convolution.  Held against the generator path (autograd on, no
    parameter asks for a gradient; TF32 allowed too): the benchmark's
    wav_gap (the largest RMS over 256-sample windows, of full scale) <=
    7e-5, the sma cell's limit, and max|d| <= 5e-3 * max|ref| (an H100
    read 1.7e-5 and 6.0e-4); a wrong slope or MRF divisor in an epilogue
    reads well above either.  Returns {launches,
    n_convs, wav_gap, max_rel, served_ms, generator_ms}."""
    import math
    from tacotron2_subword_tpu_torch.apps.inference import MAX_WAV_VALUE
    h = HG.HifiganConfig()
    g = torch.Generator().manual_seed(21)

    def draw(p):
        bound = 1.0 / math.sqrt(p["w"].shape[1] * p["w"].shape[2])
        u = lambda t: ((torch.rand(t.shape, generator=g) * 2 - 1)
                       * bound).to(dev)
        return {"w": u(p["w"]), "b": u(p["b"])}
    tree = HG.fuse_generator(HG.init_generator(g, h, device="cpu"))
    params = {"conv_pre": draw(tree["conv_pre"]),
              "conv_post": draw(tree["conv_post"]),
              "ups": [draw(p) for p in tree["ups"]],
              "resblocks": [{k: [draw(c) for c in v] for k, v in rb.items()}
                            for rb in tree["resblocks"]]}
    B, T = SERVED_GROUP
    mel = (torch.randn((B, h.num_mels, T), generator=g) * 2.0 - 5.0).to(dev)
    n_convs = 2 + len(h.upsample_rates) * (1 + 2 * sum(
        len(d) for d in h.resblock_dilation_sizes))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.enable_grad():
            HG.generator_apply(params, h, mel)      # warm-up: cuDNN plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = HG.generator_apply(params, h, mel)
            torch.cuda.synchronize()
            generator_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            HG.generator_apply(params, h, mel)
            torch.cuda.synchronize()
            EP.launches = 0
            t0 = time.perf_counter()
            got = HG.generator_apply(params, h, mel)
            torch.cuda.synchronize()
            served_ms = (time.perf_counter() - t0) * 1e3
            launches = EP.launches
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if launches != n_convs:
        raise AssertionError(f"served V1 group: K4 launched {launches} "
                             f"times for {n_convs} convolutions")
    if got.shape != ref.shape:
        raise AssertionError(f"served V1 group: {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}")
    d = (got - ref).double()
    wav_gap = (d.reshape(B, -1, 256).pow(2).mean(-1).sqrt().max().item()
               * MAX_WAV_VALUE / 32768.0)
    max_rel = d.abs().max().item() / ref.abs().max().item()
    row = {"launches": launches, "n_convs": n_convs, "wav_gap": wav_gap,
           "max_rel": max_rel, "served_ms": served_ms,
           "generator_ms": generator_ms}
    print("served vocoder", json.dumps(row), flush=True)
    if not (wav_gap <= 7e-5 and max_rel <= 5e-3):
        raise AssertionError(f"served V1 group against the generator path: "
                             f"wav_gap {wav_gap} (limit 7e-5), max|d| / "
                             f"max|ref| {max_rel} (limit 5e-3)")
    return row


def k1_split_sweep(Q, dev):
    """K1 (bf16 x) at the decode's two shapes, B=4 and B=128, at every
    number of K splits that leaves no split empty (1-8, the plan's and the
    ones it skips): device ms per call, CUDA-graph replay, warm L2, each
    result checked against the plain version.  ``python3 chip_smoke.py
    --k1-splits`` prints it; the plain run does not."""
    import ctypes
    lib = Q._lib()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for S, K, N in ((2, 1792, 4096), (1, 4096, 4096)):
        for B in (4, 128):
            x = torch.randn((S, B, K), generator=gen, device=dev).bfloat16()
            w_q, scale = Q.quantize_int8(
                torch.randn((S, K, N), generator=gen, device=dev), axis=1)
            y = torch.empty((S, B, N), device=dev)
            ref = Q.matmul_dequant_int8_plain(x, w_q, scale)
            plan = Q.k1_plan(S, B, K, N, True,
                             torch.cuda.get_device_properties(dev)
                             .multi_processor_count,
                             lambda bt, s: Q._max_clusters(lib, dev, bt, s))
            units = -(-K // Q.TC_TILE_K)
            for s in range(1, Q.MAX_CLUSTER + 1):
                per = -(-units // s)
                if -(-units // per) != s:
                    continue
                call = lambda: lib.t2s_dequant_int8_matmul(
                    x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), S, B, K, N, 1, plan.bt, s,
                    per * Q.TC_TILE_K, ctypes.c_void_p(stream()))
                if call() != 0:
                    raise AssertionError(f"K1 split sweep: launch failed at "
                                         f"S={S} B={B} splits={s}")
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                if err > 2e-3 * ref.abs().max().item():
                    raise AssertionError(f"K1 split sweep: S={S} B={B} "
                                         f"splits={s}: max|d| {err}")
                row = {"S": S, "B": B, "K": K, "N": N, "splits": s,
                       "blocks": S * (-(-N // Q.TC_TILE_N))
                       * (-(-B // plan.bt)) * s,
                       "ms": device_ms(call, 50),
                       "chosen": s == plan.splits}
                rows.append(row)
                print("k1 split", json.dumps(row))
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


# Transcendental rate of an H100 SXM: 132 SMs x 16 SFU results per clock
# (4 per SM sub-partition) x 1.98 GHz boost clock.
SFU_RATE = 132 * 16 * 1.98e9

# (B, N, M), bandwidth: the slice's shapes (8 x 128 x 128 from bench.py's
# train workload, 8 x 256 x 256 from the CLI's 256-frame bucket), ragged
# N != M, bands, N > 1024 (threads loop over rows) and degenerate edges
SDTW_CASES = [((8, 128, 128), 0.0), ((8, 256, 256), 0.0),
              ((3, 17, 15), 0.0), ((2, 20, 30), 0.0), ((2, 20, 30), 12.0),
              ((2, 24, 24), 5.0), ((2, 9, 9), 2.0), ((5, 33, 47), 0.0),
              ((1, 1100, 900), 0.0), ((1, 1, 1), 0.0), ((2, 1, 7), 0.0),
              ((2, 7, 1), 0.0)]


def sdtw_bound_ms(B, N, M, bandwidth, grad: bool):
    """Least time for one K2 (grad) or K3 call: D read once (and E written
    once for K2) at the HBM rate, or the transcendentals of the live cells
    (3 exp + 1 log forward, 3 exp backward) at the SFU rate."""
    from tacotron2_subword_tpu_torch.ops.softdtw import band_mask
    live = B * int(band_mask(N, M, bandwidth).sum())
    nbytes = B * N * M * 4 * (2 if grad else 1) + B * 4
    t_bytes, t_ops = nbytes / HBM_BW, live * (7 if grad else 4) / SFU_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_entries(report: str, needle: str):
    """Registers and spill bytes of each compiled entry function whose
    (mangled) name holds ``needle``, from an ``nvcc -Xptxas -v`` report."""
    import re
    regs, spills, cur = {}, {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    return [{"entry": k, "registers": regs[k],
             "spill_stores": spills.get(k, (None, None))[0],
             "spill_loads": spills.get(k, (None, None))[1]}
            for k in sorted(regs) if needle in k]


def wall_ms(fn, iters: int) -> float:
    """Host ms per call of ``fn``, launches included, over ``iters`` calls
    ended by a synchronize: what an eager caller pays."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# the small shapes of SDTW_CASES at which the plain version is timed
# against K3 (does softdtw_impl="auto" rightly take the kernel at every
# size on CUDA?)
SDTW_SMALL = [(2, 9, 9), (3, 17, 15), (2, 24, 24)]


def k3_cell_cycles(SD, dev, iters: int = 20000):
    """Clock cycles of one dependent K3 cell (a shuffle, softmin3 and an
    add: the chain's link) on one warp, and the SM clock in GHz that the
    same launch ran at (its clock64 cycles over its CUDA-event time)."""
    import ctypes
    lib = SD._lib()
    lib.t2s_softdtw_chain_cycles.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros(32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda: lib.t2s_softdtw_chain_cycles(cyc.data_ptr(), out.data_ptr(),
                                               iters, stream)
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    code = run()
    end.record()
    end.synchronize()
    if code != 0:
        raise AssertionError(f"chain_cycles launch failed: {code}")
    cycles = cyc.item()
    return cycles / iters, cycles / (start.elapsed_time(end) * 1e6)


def phase_softdtw(SD, dev, k3_ptxas):
    """K2 (both variants: shared memory where it fits, and the global one
    forced at every shape) and K3 against their plain versions, each kernel
    run twice and required bit-equal (a missing barrier shows as run-to-run
    drift).  Tolerances: both sides do the same f32 operations in the same
    order, so only the exp/log of the two builds may differ: |d value| <=
    1e-5 * max(1, |value|), |d E| <= 1e-5; E is exactly 0 outside the band.
    K3 must be bit-equal to its plain version at every shape.  Times per
    call and per serial diagonal (2 (N+M-1) for K2, N+M-1 for K3), with
    K3's plan and registers; at the small shapes K3 and the plain version
    also by host wall time per call (the crossover for "auto")."""
    rows = []
    cell_cycles, clock_ghz = k3_cell_cycles(SD, dev)
    print("k3 cell", json.dumps({"cycles_per_cell": cell_cycles,
                                 "sm_clock_ghz": clock_ghz}))
    for (B, N, M), bw in SDTW_CASES:
        gen = torch.Generator(device=dev).manual_seed(B * 1000 + N + M)
        dim = 80 if N >= 128 else 2   # mel frames at the slice's shapes
        x = torch.randn((B, N, dim), generator=gen, device=dev)
        y = torch.randn((B, M, dim), generator=gen, device=dev)
        D = SD.euclidean_dist_matrix(x, y).contiguous()
        pv, pE = SD.softdtw_grad_plain(D, 1.0, bw)
        pv3 = SD.softdtw_value_plain(D, 1.0, bw)
        banned = ~SD.band_mask(N, M, bw, dev)
        vtol = 1e-5 * torch.clamp_min(pv.abs(), 1.0)
        chosen = SD.k2_plan(B, N, M).variant
        row = {"B": B, "N": N, "M": M, "bandwidth": bw,
               "k2_variant": chosen, "value_max": pv.abs().max().item()}
        for variant in ("shared", "global"):
            if variant == "shared" and chosen != "shared":
                continue
            v2, E2 = SD.softdtw_grad(D, 1.0, bw, variant=variant)
            v2b, E2b = SD.softdtw_grad(D, 1.0, bw, variant=variant)
            torch.cuda.synchronize()
            if not (torch.equal(v2, v2b) and torch.equal(E2, E2b)):
                raise AssertionError(f"K2 ({variant}) not deterministic at "
                                     f"{(B, N, M)} bw={bw}")
            ev, eE = (v2 - pv).abs().max().item(), (E2 - pE).abs().max().item()
            if not (((v2 - pv).abs() <= vtol).all() and eE <= 1e-5
                    and torch.isfinite(E2).all()
                    and bool((E2[:, banned] == 0).all())):
                raise AssertionError(f"K2 ({variant}) disagrees at "
                                     f"{(B, N, M)} bw={bw}: {ev}, {eE}")
            key = "k2" if variant == chosen else f"k2_{variant}"
            row[f"{key}_value"], row[f"{key}_E"] = ev, eE
            row[f"{key}_bit_equal"] = bool(torch.equal(v2, pv)
                                           and torch.equal(E2, pE))
        v3 = SD.softdtw_value(D, 1.0, bw)
        v3b = SD.softdtw_value(D, 1.0, bw)
        torch.cuda.synchronize()
        if not torch.equal(v3, v3b):
            raise AssertionError(f"K3 not deterministic at {(B, N, M)}")
        row["k3_value"] = (v3 - pv3).abs().max().item()
        row["k3_plan"] = SD.k3_plan(B, N, M)._asdict()
        if not torch.equal(v3, pv3):
            raise AssertionError(f"K3 not bit-equal to its plain version at "
                                 f"{(B, N, M)} bw={bw}: {row['k3_value']}")
        if (B, N, M) in SDTW_SMALL:
            row["k3_ms"] = device_ms(lambda: SD.softdtw_value(D, 1.0, bw), 20)
            row["k3_plain_ms"] = device_ms(
                lambda: SD.softdtw_value_plain(D, 1.0, bw), 2)
            row["k3_wall_ms"] = wall_ms(lambda: SD.softdtw_value(D, 1.0, bw),
                                        50)
            row["k3_plain_wall_ms"] = wall_ms(
                lambda: SD.softdtw_value_plain(D, 1.0, bw), 5)
        if N >= 128 and N == M and B == 8:
            P = N + M - 1
            for variant in ("shared", "global"):
                if variant == "shared" and chosen != "shared":
                    continue
                key = "k2" if variant == chosen else f"k2_{variant}"
                row[f"{key}_ms"] = device_ms(
                    lambda: SD.softdtw_grad(D, 1.0, bw, variant=variant), 20)
                row[f"{key}_us_per_diagonal"] = row[f"{key}_ms"] * 1e3 / (2 * P)
            row["k2_plain_ms"] = device_ms(
                lambda: SD.softdtw_grad_plain(D, 1.0, bw), 2)
            row["k2_bound_ms"], row["k2_bound_by"] = sdtw_bound_ms(
                B, N, M, bw, True)
            row["k2_serial_diagonals"] = 2 * P
            row["k3_ms"] = device_ms(lambda: SD.softdtw_value(D, 1.0, bw), 20)
            row["k3_us_per_diagonal"] = row["k3_ms"] * 1e3 / P
            row["k3_plain_ms"] = device_ms(
                lambda: SD.softdtw_value_plain(D, 1.0, bw), 2)
            row["k3_bound_ms"], row["k3_bound_by"] = sdtw_bound_ms(
                B, N, M, bw, False)
            row["k3_serial_diagonals"] = P
            # the least a wavefront can take: one dependent cell per diagonal
            row["k3_serial_floor_ms"] = P * cell_cycles / (clock_ghz * 1e6)
            row["k3_cycles_per_diagonal"] = row["k3_ms"] * 1e6 * clock_ghz / P
            row["k3_ptxas"] = k3_ptxas
        rows.append(row)
        print("softdtw", json.dumps(row))
    return rows


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


def phase_decode_graph(Q, TM, TI, params, bn, gen_params, cfg, h, dev, gpu,
                       B=128, steps=200):
    """The served int8 decode both ways: as CUDA graph replays (the
    default on the card) and as the eager loop (``TM._graphable`` patched
    off), B requests of 64 / 32 IDs, ``steps`` steps that no gate stops (a
    partial last chunk).  Every output, the wavs and the generator's state
    after are bit-equal; K1 launches 2 x steps both ways.  With the graph
    cache emptied first, the first graphed batch warms up and captures,
    the second only replays: the host's time in each decode loop
    (``decode.loop`` spans) is reported beside the eager loop's."""
    from tacotron2_subword_tpu_torch.utils import trace
    reqs = make_requests(cfg, [(64, 32)] * B, seed=11)
    real = TM._graphable
    TM._graphs.clear()   # phase_profile's decodes left graphs of this shape
    rows = {}
    for name, graph in (("graph_first", True), ("graph", True),
                        ("eager", False)):
        TM._graphable = lambda device, g=graph: g
        gen = torch.Generator(device=dev).manual_seed(3)
        try:
            Q.launches = 0
            trace.enable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = TI.synthesize(params, bn, gen_params, cfg, h, reqs,
                                generator=gen, device=dev, max_steps=steps,
                                gate_threshold=1.1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            trace.disable()
            TM._graphable = real
        rec = trace.take()
        loop_s = sum(sp.end_ns - sp.start_ns for sp in rec.spans
                     if sp.name == "decode.loop") / 1e9
        rows[name] = (out, gen.get_state(), Q.launches, wall, loop_s,
                      rec.counters)
    eager = rows["eager"][0]
    if eager["steps_run"] != steps:
        raise AssertionError(f"decode graph: {eager['steps_run']} steps")
    report = {"B": B, "steps": steps, "gpu": gpu}
    for name, (out, state, k1, wall, loop_s, c) in rows.items():
        same = [k for k in ("mel_postnet", "gate", "alignments",
                            "alignments_bert", "mel_lengths", "infer_ok")
                if torch.equal(out[k], eager[k])]
        if not (len(same) == 6 and out["steps_run"] == steps
                and all(torch.equal(a, b) for a, b in
                        zip(out["wavs"], eager["wavs"]))
                and torch.equal(state, rows["eager"][1])
                and k1 == 2 * steps
                and c["decode.graph_replays"] * TM.SYNC_EVERY
                + c["decode.eager_steps"] == steps):
            raise AssertionError(f"decode graph: {name} differs from the "
                                 f"eager loop (equal: {same}), K1 {k1}, "
                                 f"counters {c}")
        report[name] = {"serve_wall_s": wall,
                        "decode_loop_us_per_step": loop_s / steps * 1e6,
                        "k1_launches": k1,
                        **{k.split(".")[1]: c[k] for k in (
                            "decode.graph_captures", "decode.graph_replays",
                            "decode.eager_steps")}}
    if (report["graph_first"]["graph_captures"], report["graph"][
            "graph_captures"]) != (1, 0):
        raise AssertionError(f"decode graph: captures {report}")
    print("decode graph", json.dumps(report))
    return report


PROFILE_STEPS = 32


def profile_decode(TM, TI, params, bn, cfg, dev, lengths,
                   steps=PROFILE_STEPS):
    """The decoder loop alone (``steps`` steps, the encoders run
    before) under ``utils.xprof.device_profile`` (CUDA activity only): (its
    row of wall and device-busy us per step (the union of the device
    intervals), device-busy share, kernel launches per step, K1's us and
    launches per step and the kernels with the most device time; the
    device activities' (name, ms, count) rows)."""
    from tacotron2_subword_tpu_torch.utils import xprof
    text, sub, cls_p, cls_s, t_len, s_len = TI.pad_requests(
        make_requests(cfg, lengths, seed=7), dev)
    dtype = TM._compute_dtype(cfg)
    with torch.inference_mode():
        mem, _ = TM._encode_stream(params["encoder"], bn["encoder"],
                                   params["embedding"], text, t_len,
                                   cls_p, params["linear_converter"],
                                   dtype)
        mem_b, _ = TM._encode_stream(
            params["encoder_sub"], bn["encoder_sub"],
            params["embedding_sub"], sub, s_len, cls_s,
            params["linear_converter_sub"], dtype)

    def run():
        with torch.inference_mode():
            TM.decoder_infer(
                params["decoder"], cfg, mem, mem_b, max_steps=steps,
                gate_threshold=1.1, text_lengths=t_len,
                sub_lengths=s_len,
                generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    run()
    with xprof.device_profile() as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    s = xprof.profile_summary(prof)
    k1 = [o for o in s.ops if "dequant_int8_matmul" in o[0]]
    row = {
        "B": len(lengths), "steps": steps,
        "wall_us_per_step": wall / steps * 1e6,
        "device_us_per_step": s.busy_ms * 1e3 / steps,
        "device_busy_share": s.busy_ms / (wall * 1e3),
        "kernel_launches_per_step": s.n_events / steps,
        "k1_us_per_step": sum(ms for _, ms, _ in k1) * 1e3 / steps,
        "k1_launches_per_step": sum(n for _, _, n in k1) / steps,
        "top_kernels_us_per_step": [
            [name[:70], ms * 1e3 / steps] for name, ms, _ in s.ops[:6]],
    }
    return row, s.ops


def phase_profile(TM, TI, params, bn, cfg, dev):
    """Where a decode step's time goes (``profile_decode``): the decoder
    loop alone at B=4 and B=128, its wall time per step, the device-busy
    share of that wall time, K1's device time and launches per step, and
    the kernels with the most device time; at B=128 also the launches per
    step as the slope of a PROFILE_STEPS- and a 2 x PROFILE_STEPS-step
    loop (the per-call launches cancel).  Fails if a split-K reduce
    kernel ran (K1 is one launch per call)."""
    rows = []
    for lengths in (REQUESTS, [(64, 32)] * 128):
        row, ops = profile_decode(TM, TI, params, bn, cfg, dev, lengths)
        if any("splitk_reduce" in name for name, _, _ in ops):
            raise AssertionError("profile: a split-K reduce kernel ran; K1 "
                                 "must be one launch per call")
        if len(lengths) == 128:
            long, _ = profile_decode(TM, TI, params, bn, cfg, dev, lengths,
                                     2 * PROFILE_STEPS)
            row["kernel_launches_per_step_slope"] = (
                2 * long["kernel_launches_per_step"]
                - row["kernel_launches_per_step"])
        rows.append(row)
        print("profile", json.dumps(row))
    return rows


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


TRAIN_B, TRAIN_T_OUT, TRAIN_T_TEXT, TRAIN_T_SUB = 8, 128, 64, 32
TRAIN_STEPS = 3


def phase_train(TT, SD, cfg, dev, gpu):
    """The training path at full width with the soft-DTW loss on: one
    warm-up train step, then TRAIN_STEPS timed steps and one eval step with
    K2's and K3's launches counted from 0; then one more step under
    torch.profiler.  Every loss and grad_norm must be finite, K2 launch
    once per train step and K3 once per eval step."""
    from tacotron2_subword_tpu_torch.utils import xprof
    state, tx = TT.create_train_state(torch.Generator().manual_seed(0), cfg,
                                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = train_batch(cfg, dev, TRAIN_B, TRAIN_T_OUT)
    torch.cuda.reset_peak_memory_stats()
    state, m = TT.train_step(state, batch, cfg, tx, generator=gen)  # warm-up
    torch.cuda.synchronize()

    SD.grad_launches = SD.fwd_launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = TT.train_step(state, batch, cfg, tx, generator=gen)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    t0 = time.perf_counter()
    losses, outputs = TT.eval_step(state, batch, cfg, generator=gen)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    k2, k3 = SD.grad_launches, SD.fwd_launches
    peak = torch.cuda.max_memory_allocated()

    vals = {k: v.item() for k, v in m.items()}
    evals = {k: v.item() for k, v in losses.items()}
    if not all(np.isfinite(list(vals.values()) + list(evals.values()))) \
            or vals["skipped"] != 0.0:
        raise AssertionError(f"train: non-finite or skipped step {vals} "
                             f"eval {evals}")
    if not torch.isfinite(outputs["mel_postnet"]).all():
        raise AssertionError("train: non-finite eval outputs")
    if k2 != TRAIN_STEPS or k3 != 1:
        raise AssertionError(f"train: K2 launched {k2} times in "
                             f"{TRAIN_STEPS} train steps, K3 {k3} times in "
                             f"1 eval step")
    row = {"B": TRAIN_B, "T_out": TRAIN_T_OUT, "ms_per_step": step_s * 1e3,
           "mel_frames_per_s": TRAIN_B * TRAIN_T_OUT / step_s,
           "eval_ms": eval_s * 1e3, "peak_mem_bytes": peak,
           "k2_launches": k2, "k3_launches": k3, "train_metrics": vals,
           "eval_losses": evals, "gpu": gpu}
    print("train", json.dumps(row))

    with xprof.device_profile() as prof:
        t0 = time.perf_counter()
        state, m = TT.train_step(state, batch, cfg, tx, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = xprof.profile_summary(prof)
    print("train profile", json.dumps({
        "wall_ms": wall * 1e3, "device_ms": s.busy_ms,
        "device_busy_share": s.busy_ms / (wall * 1e3),
        "kernel_launches": s.n_events,
        "top_kernels_ms": [[name[:70], n, ms] for name, ms, n in
                           s.ops[:10]]}))
    return k2, k3


def phase_train_parity(TT, TM, cfg, dev):
    """One f32 train step (parity_mode) on the card against the CPU, at
    full width with B=2, T_out=32, T_text=16, T_sub=8: the same params,
    batch and injected randomness.  Both sides are f32 and sum in other
    orders.  Tolerances: losses and grad_norm to 1e-4 relative.  The
    gradients, through Adam's first moment (mu = 0.1 * the clipped
    gradient), leaf by leaf to 1e-3 * max|mu| of the leaf, floored at 1e-3
    of the tree's (a conv bias feeding a training-mode BatchNorm has a true
    gradient of 0: noise on both sides).  The updated params to 2 * lr:
    Adam's first step is -lr * g / (|g| + eps), which turns the rounding
    noise of a near-zero gradient element into up to lr of difference."""
    from tacotron2_subword_tpu_torch.utils.tree import to_device, tree_leaves
    cfg32 = cfg.replace(parity_mode=True)
    cpu = torch.device("cpu")
    state, tx = TT.create_train_state(torch.Generator().manual_seed(2),
                                      cfg32, device=cpu)
    batch = train_batch(cfg32, cpu, B=2, t_out=32, T_text=16, T_sub=8,
                        seed=3)
    rnd = TM.make_randomness(cfg32, 2, 16, 8, 32, training=True,
                             generator=torch.Generator().manual_seed(4))
    new_c, m_c = TT.train_step(state, batch, cfg32, tx, randomness=rnd)
    new_d, m_d = TT.train_step(to_device(state, dev), to_device(batch, dev),
                               cfg32, tx, randomness=to_device(rnd, dev))
    torch.cuda.synchronize()
    errs = {}
    for k, v in m_c.items():
        errs[k] = abs(m_d[k].item() - v.item())
        if not errs[k] <= 1e-4 * max(abs(v.item()), 1e-6):
            raise AssertionError(f"train parity: {k} card {m_d[k].item()} "
                                 f"cpu {v.item()}")
    lr = cfg32.learning_rate
    mu_c, mu_d = tree_leaves(new_c.opt_state.mu), tree_leaves(
        new_d.opt_state.mu)
    floor = 1e-3 * max(m.abs().max().item() for m in mu_c)
    leaves = []
    for path, mc, md, pc, pd in zip(_tree_paths(state.params), mu_c, mu_d,
                                    tree_leaves(new_c.params),
                                    tree_leaves(new_d.params)):
        rel = ((md.cpu() - mc).abs().max().item()
               / max(mc.abs().max().item(), floor))
        dp = (pd.cpu() - pc).abs().max().item()
        leaves.append((rel, path, mc.abs().max().item(), dp))
        if rel > 5e-3 or dp > 2 * lr:
            raise AssertionError(f"train parity: {path} mu rel {rel}, "
                                 f"param max|d| {dp}")
    leaves.sort(reverse=True)
    print("train parity (f32, B=2, T_out=32, card vs CPU):",
          json.dumps({"losses_and_grad_norm": errs,
                      "param_max_abs": max(l[3] for l in leaves),
                      "worst_mu_rel [rel, leaf, max|mu|, param max|d|]":
                          leaves[:5]}))
    return errs


def _tree_paths(tree, prefix=""):
    """Dotted paths of the leaves, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _tree_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _tree_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def phase_train_cli(SD):
    """The port's training CLI in-process: 16 synthetic utterances (mel
    buckets 128 and 256), 2 iterations, validation after the second: K3
    runs through the real entry point."""
    import contextlib
    import io
    import shutil
    from pathlib import Path
    from tacotron2_subword_tpu_torch.apps import train as TAPP
    out_dir = Path(__file__).resolve().parent / "_runs" / "train_cli"
    shutil.rmtree(out_dir, ignore_errors=True)  # or it would resume
    buf = io.StringIO()
    SD.grad_launches = SD.fwd_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = TAPP.main(["-o", str(out_dir), "--synthetic", "16",
                         "--max-iters", "2", "--batch-size", "8",
                         "--hparams",
                         "[softdtw_loss_weight:1.0-iters_per_checkpoint:2]"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    print(log, end="")
    if "validation loss" not in log or not np.isfinite(res["val_loss"]) \
            or not np.isfinite(res["loss"]) or res["iterations"] != 2:
        raise AssertionError(f"train CLI: no validation or a non-finite "
                             f"loss: {res}")
    if SD.grad_launches != 2 or SD.fwd_launches < 1:
        raise AssertionError(f"train CLI: K2 {SD.grad_launches}, K3 "
                             f"{SD.fwd_launches} launches")
    print("train cli", json.dumps({**res, "wall_s": wall,
                                   "k2_launches": SD.grad_launches,
                                   "k3_launches": SD.fwd_launches}))
    shutil.rmtree(out_dir, ignore_errors=True)


REAL_TRAIN, REAL_VAL = 32, 8
REAL_HPARAMS = ("[softdtw_loss_weight:1.0-ssim_loss_weight:1.0-"
                "align_loss:KL-iters_per_checkpoint:4]")


def write_real_corpus(root, seed=0):
    """A reference-format corpus from RandomState(seed): a train split of
    REAL_TRAIN and a val split of REAL_VAL utterances, each in its own
    ``durs/`` (phone ID, duration), ``mels/ljspeech-mel-%05d.npy`` [80, T]
    f32, ``subs/`` (8-24 subword IDs) and ``cls/`` (768 f32), with a
    ``train.txt`` / ``val.txt`` list of ``wav|durs`` rows.  20-60 phones of
    1-6 frames each; the durations are moved by one frame at a time until
    their sum, the mel length, lies in 80-240."""
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    cfg = TacotronConfig()
    rng = np.random.RandomState(seed)
    for split, n in (("train", REAL_TRAIN), ("val", REAL_VAL)):
        d = root / split
        for sub in ("durs", "mels", "subs", "cls"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        rows = []
        for i in range(n):
            n_ph = rng.randint(20, 61)
            durs = rng.randint(1, 7, n_ph)
            while durs.sum() > 240:
                durs[rng.choice(np.flatnonzero(durs > 1))] -= 1
            while durs.sum() < 80:
                durs[rng.choice(np.flatnonzero(durs < 6))] += 1
            np.save(d / "durs" / f"{i}.npy", np.stack(
                [rng.randint(0, cfg.n_symbols, n_ph), durs], axis=1))
            np.save(d / "mels" / f"ljspeech-mel-{i + 1:05d}.npy",
                    rng.randn(cfg.n_mel_channels, int(durs.sum())
                              ).astype(np.float32))
            np.save(d / "subs" / f"{i}.npy",
                    rng.randint(0, cfg.sub_n_symbols, rng.randint(8, 25)))
            np.save(d / "cls" / f"{i}.npy",
                    rng.randn(cfg.bert_embedding_dim).astype(np.float32))
            rows.append(f"wav/{i}.wav|{d / 'durs' / f'{i}.npy'}\n")
        (root / f"{split}.txt").write_text("".join(rows))


def real_argv(data, out, *extra):
    tr, va = data / "train", data / "val"
    return ["-o", str(out), "--train-list", str(data / "train.txt"),
            "--val-list", str(data / "val.txt"),
            "--mel-dir", str(tr / "mels"), "--sub-dir", str(tr / "subs"),
            "--cls-dir", str(tr / "cls"), "--val-mel-dir", str(va / "mels"),
            "--val-sub-dir", str(va / "subs"),
            "--val-cls-dir", str(va / "cls"), "--batch-size", "8",
            "--hparams", REAL_HPARAMS, *extra]


def _run_cli(TAPP, argv):
    """The training CLI in-process; (its result, its log)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = TAPP.main(argv)
    torch.cuda.synchronize()
    log = buf.getvalue()
    print(log, end="")
    return res, log


def _state_leaves(state):
    from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
    return tree_leaves((state.params, state.bn_state,
                        list(state.opt_state)))


def check_trace(trace, steps):
    """The CLI's Chrome trace holds a ProfilerStep span per step, kernels
    on the card and K2 among them; returns its size in MB.  Searched as
    text: a full-width step writes ~10^5 events."""
    text = trace.read_text() if trace.is_file() else ""
    marks = [f'"ProfilerStep#{i}"' in text for i in steps]
    if not (all(marks) and '"cat": "kernel"' in text
            and "softdtw_grad_kernel" in text):
        raise AssertionError(f"train real: trace {trace} steps {marks}")
    return len(text) / 1e6


def phase_ssim(dev, gpu):
    """SSIM (ops/ssim.py) on the card against the CPU at the mel image of
    a 256-frame bucket, [8, 1, 80, 256] f32: value and gradient w.r.t. the
    first image, atol 1e-5 / rtol 1e-4 (the same five f32 convolutions in
    cuDNN's order, TF32 off).  Its device time: the forward as a CUDA
    graph, forward + backward of ssim_mel_loss from the profiler's busy
    time (``utils.xprof``)."""
    from tacotron2_subword_tpu_torch.utils import xprof
    from tacotron2_subword_tpu_torch.ops.ssim import ssim
    from tacotron2_subword_tpu_torch.train_lib import ssim_mel_loss
    rng = np.random.RandomState(5)
    a = rng.randn(8, 1, 80, 256).astype(np.float32)
    b = (0.7 * a + 0.5 * rng.randn(*a.shape)).astype(np.float32)
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        x = torch.from_numpy(a).to(d).requires_grad_(True)
        v = ssim(x, torch.from_numpy(b).to(d))
        (g,) = torch.autograd.grad(v, x)
        if v.device != d:
            raise AssertionError(f"ssim ran on {v.device}, not {d}")
        out[name] = (v.detach().cpu(), g.cpu())
    err_v = (out["cuda"][0] - out["cpu"][0]).abs().item()
    err_g = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    for got, ref in zip(out["cuda"], out["cpu"]):
        if not torch.allclose(got, ref, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"ssim: card vs CPU value {err_v}, "
                                 f"grad {err_g}")
    x = torch.from_numpy(a[:, 0]).to(dev)
    y = torch.from_numpy(b[:, 0]).to(dev)
    fwd_ms = device_ms(lambda: ssim_mel_loss(x, y), 20)
    xg = x.clone().requires_grad_(True)
    for _ in range(3):
        torch.autograd.grad(ssim_mel_loss(xg, y), xg)
    torch.cuda.synchronize()
    with xprof.device_profile() as prof:
        for _ in range(10):
            torch.autograd.grad(ssim_mel_loss(xg, y), xg)
        torch.cuda.synchronize()
    prof_s = xprof.profile_summary(prof)
    row = {"shape": [8, 1, 80, 256], "value": out["cpu"][0].item(),
           "bit_equal": all(torch.equal(a, b) for a, b in zip(out["cuda"],
                                                              out["cpu"])),
           "max_abs_err_value": err_v, "max_abs_err_grad": err_g,
           "fwd_device_ms": fwd_ms,
           "fwd_bwd_device_ms": prof_s.busy_ms / 10,
           "fwd_bwd_kernel_launches": prof_s.n_events / 10,
           "gpu": gpu}
    print("ssim", json.dumps(row))
    return row


def phase_train_real(SD, dev, gpu):
    """The training CLI on a reference-format corpus on disk at full
    width (TacotronConfig defaults, soft-DTW + SSIM + KL alignment, B=8,
    prefetch 2, mel buckets 128 and 256):
     A. 8 iterations with validation every 4, a profile of steps 5-7 and,
        where tensorboardX and matplotlib import, TensorBoard logs:
        checkpoint_4, checkpoint_8 and checkpoint_best; finite losses with
        the "ssim" and "softdtw" terms; K2 == 8 launches, K3 == 2 x the
        validation batches;
     B. the same command to 10: it resumes from checkpoint_8 with the
        saved state bit for bit, K2 == 2, K3 == 0;
     C. a warm start from checkpoint_4: every param but the embedding is
        the checkpoint's, the embedding a fresh init's, step 0;
     D. 3 iterations with --prefetch 0 and with --prefetch 2: the same
        first loss, and each one's s/it (iterations 2 and 3).
    Returns (K2, K3) launches of run A."""
    import importlib.util
    import shutil
    from pathlib import Path
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.apps import train as TAPP
    from tacotron2_subword_tpu_torch.config import create_config
    from tacotron2_subword_tpu_torch.data import dataset as TD
    from tacotron2_subword_tpu_torch.utils import checkpoint as CK
    from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
    root = Path(__file__).resolve().parent / "_runs" / "train_real"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    write_real_corpus(data)
    cfg = create_config(REAL_HPARAMS).replace(batch_size=8)
    val_batches = len(list(TD.BucketedLoader(
        TD.BertTacotron2Dataset(TD.load_filepaths(str(data / "val.txt")),
                                *(str(data / "val" / d) for d in
                                  ("mels", "subs", "cls")),
                                load_alignment=True),
        batch_size=8, with_alignment=True)))
    logs = all(importlib.util.find_spec(m) for m in ("tensorboardX",
                                                      "matplotlib"))
    out, prof = root / "out", root / "prof"

    # A
    torch.cuda.reset_peak_memory_stats()
    SD.grad_launches = SD.fwd_launches = 0
    t0 = time.perf_counter()
    res_a, _ = _run_cli(TAPP, real_argv(
        data, out, "--max-iters", "8", "--profile-dir", str(prof),
        *(["-l", str(root / "logs")] if logs else [])))
    wall_a = time.perf_counter() - t0
    k2, k3 = SD.grad_launches, SD.fwd_launches
    peak = torch.cuda.max_memory_allocated()
    for name in ("checkpoint_4", "checkpoint_8", "checkpoint_best"):
        for f in ("state.pt", "meta.json"):
            if not (out / name / f).is_file():
                raise AssertionError(f"train real: no {name}/{f}")
    if not (res_a["iterations"] == 8 and np.isfinite(res_a["losses"]).all()
            and np.isfinite(res_a["val_loss"])
            and {"ssim", "softdtw"} <= set(res_a["metrics"])
            and np.isfinite(list(res_a["metrics"].values())).all()):
        raise AssertionError(f"train real: run A {res_a}")
    if k2 != 8 or k3 != 2 * val_batches:
        raise AssertionError(f"train real: K2 {k2} launches in 8 steps, K3 "
                             f"{k3} in 2 x {val_batches} validation batches")
    trace_mb = check_trace(prof / "trace_steps_5-7.json", (5, 6, 7))
    if logs and not any(p.name.startswith("events.out.tfevents")
                        for p in (root / "logs").iterdir()):
        raise AssertionError("train real: no TensorBoard event file")

    # B: resume, the loaded state spied on
    loaded = []
    real_load = CK.load_checkpoint
    CK.load_checkpoint = lambda *a, **k: (loaded.append(real_load(*a, **k))
                                          or loaded[-1])
    try:
        SD.grad_launches = SD.fwd_launches = 0
        res_b, log = _run_cli(TAPP, real_argv(data, out, "--max-iters", "10"))
        k2_b, k3_b = SD.grad_launches, SD.fwd_launches
    finally:
        CK.load_checkpoint = real_load
    want = torch.load(out / "checkpoint_8" / "state.pt", map_location="cpu",
                      weights_only=True)
    want = TT.TrainState(want["step"], want["params"], want["bn_state"],
                         TT.AdamState(**want["opt_state"]))
    got = loaded[0][0]
    same = [torch.equal(a.cpu(), b) for a, b in zip(_state_leaves(got),
                                                     _state_leaves(want))]
    if not (f"resumed from {out / 'checkpoint_8'} at iteration 8" in log
            and got.step == 8 and len(same) > 100 and all(same)):
        raise AssertionError(f"train real: resume: step {got.step}, "
                             f"{sum(same)}/{len(same)} leaves equal")
    if res_b["iterations"] != 10 or k2_b != 2 or k3_b != 0:
        raise AssertionError(f"train real: run B to {res_b['iterations']}, "
                             f"K2 {k2_b}, K3 {k3_b}")

    # C: warm start, its result spied on
    warmed = []
    real_warm = CK.warm_start
    CK.warm_start = lambda *a, **k: (warmed.append(real_warm(*a, **k))
                                     or warmed[-1])
    try:
        res_c, log = _run_cli(TAPP, real_argv(
            data, root / "warm", "-c", str(out / "checkpoint_4"),
            "--warm_start", "--max-iters", "1"))
    finally:
        CK.warm_start = real_warm
    ck, _ = real_load(str(out / "checkpoint_4"), "cpu")
    fresh, _ = TT.create_train_state(torch.Generator().manual_seed(cfg.seed),
                                     cfg, device="cpu")
    w = warmed[0]
    kept = all(torch.equal(a.cpu(), b) for k in ck.params if k != "embedding"
               for a, b in zip(tree_leaves(w.params[k]),
                               tree_leaves(ck.params[k])))
    if not (kept and w.step == 0 and res_c["start_iteration"] == 0
            and torch.equal(w.params["embedding"].cpu(),
                            fresh.params["embedding"])
            and not torch.equal(fresh.params["embedding"],
                                ck.params["embedding"])):
        raise AssertionError("train real: warm start")
    shutil.rmtree(root / "warm")

    # D: prefetch off and on, the same command and seed
    sit = {}
    first = {}
    for depth in (0, 2):
        d = root / f"prefetch{depth}"
        res, _ = _run_cli(TAPP, real_argv(data, d, "--max-iters", "3",
                                          "--prefetch", str(depth)))
        sit[depth] = float(np.mean(res["iter_s"][1:]))
        first[depth] = res["losses"][0]
        shutil.rmtree(d)
    d_first = abs(first[0] - first[2])
    if d_first > 1e-6 * abs(first[0]):
        raise AssertionError(f"train real: first loss with prefetch 0 "
                             f"{first[0]}, with 2 {first[2]}")

    ssim_row = phase_ssim(dev, gpu)
    row = {"B": 8, "train": REAL_TRAIN, "val": REAL_VAL,
           "s_per_it": float(np.mean(res_a["iter_s"][1:])),
           "s_per_it_untraced": float(np.mean(res_a["iter_s"][1:5])),
           "iter_s": res_a["iter_s"], "wall_s_run_a": wall_a,
           "peak_mem_bytes": peak, "k2_launches": k2, "k3_launches": k3,
           "val_batches": val_batches, "trace_mb": trace_mb,
           "tensorboard": bool(logs),
           "s_per_it_prefetch0": sit[0], "s_per_it_prefetch2": sit[2],
           "first_loss_prefetch0_minus_2": first[0] - first[2],
           "ssim_max_abs_err": max(ssim_row["max_abs_err_value"],
                                   ssim_row["max_abs_err_grad"]),
           "ssim_fwd_bwd_device_ms": ssim_row["fwd_bwd_device_ms"],
           "metrics": res_a["metrics"], "gpu": gpu}
    print("train real", json.dumps(row))
    shutil.rmtree(root, ignore_errors=True)
    return k2, k3


CLI_LEXICON = ("an a_1 n\nanh a_1 J\nba b a_1\nbanh b a_1 J\n"
               "em E_1 m\nme m E_1\nnam n a_1 m\n")
CLI_SCRIPT = ("u0|ba me em nam\nu1|Anh banh an me ba, em nam!\n"
              "u2|em nam ba me\nu3|nam anh em ba banh me an nhanh\n")
CLI_STEPS = 200
CLI_PARITY_STEPS = 20


def write_resources(root):
    """The small lexicon under the three reference names, with a
    phone_id_list.txt, in ``root/res``; returns that dir."""
    import os
    from tacotron2_subword_tpu_torch.text import lexicon as TL
    res = os.path.join(root, "res")
    os.makedirs(res, exist_ok=True)
    for name in ("small.lex",
                 "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt",
                 "03_all_foreign_words.10600woreds.30102020.lex",
                 "cmudict-0.7b.vi.mergeEng-xsampa.forE2E.KA.txt"):
        with open(os.path.join(res, name), "w", encoding="utf-8") as f:
            f.write(CLI_LEXICON)
    p2i, _ = TL.build_phone_id_map(
        [TL.load_lexicon(os.path.join(res, "small.lex"))],
        ["_", "-", "~", "+", " ", "!", ",", ".", "?"])
    with open(os.path.join(res, "phone_id_list.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(f"{p}\t{i}\n" for p, i in p2i.items())
    return res


def unit_norm_generator(HG, h, seed):
    """A random weight-normed HiFi-GAN generator (CPU) with g = 1, so each
    row keeps the signal's scale, and 0.1 on conv_post, so that tanh and
    the int16 clip are not saturated (an untouched init is so soft that
    remove_silence trims it away)."""
    g = HG.init_generator(torch.Generator().manual_seed(seed), h,
                          device="cpu")
    unit = lambda t: (
        {k: torch.ones_like(v) if k == "g" else unit(v) for k, v in t.items()}
        if isinstance(t, dict) else [unit(v) for v in t]
        if isinstance(t, list) else t)
    g = unit(g)
    g["conv_post"]["g"] = g["conv_post"]["g"] * 0.1
    return g


def write_hifigan_config(path, h):
    with open(path, "w") as f:
        json.dump({"resblock": h.resblock,
                   "upsample_rates": list(h.upsample_rates),
                   "upsample_kernel_sizes": list(h.upsample_kernel_sizes),
                   "upsample_initial_channel": h.upsample_initial_channel,
                   "resblock_kernel_sizes": list(h.resblock_kernel_sizes),
                   "resblock_dilation_sizes": [
                       list(d) for d in h.resblock_dilation_sizes],
                   "num_mels": h.num_mels,
                   "sampling_rate": h.sampling_rate}, f)


def cli_assets(root, cfg=None, script_text=CLI_SCRIPT):
    """The CLI's inputs under ``root``: the resources, a full-width
    acoustic model of ``cfg`` (the default config when None) with random
    weights (seed 0) saved by the port's save_checkpoint, a HiFi-GAN v1
    generator (``unit_norm_generator``, seed 1) as a reference-format
    {'generator': state_dict} file written by ``HG.export_torch_generator``,
    with its JSON config, and the script (4 lines by default)."""
    import os
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.utils import checkpoint as CK
    res = write_resources(root)
    gen = torch.Generator().manual_seed(0)
    state, _ = TT.create_train_state(gen, cfg or TacotronConfig(),
                                     device="cpu")
    ckpt = CK.save_checkpoint(state._replace(step=1), os.path.join(root, "ck"))
    h = HG.HifiganConfig()
    gpath = os.path.join(root, "g_00000001")
    torch.save({"generator": HG.export_torch_generator(
        unit_norm_generator(HG, h, 1))}, gpath)
    cpath = os.path.join(root, "config_v1.json")
    write_hifigan_config(cpath, h)
    script = os.path.join(root, "script.txt")
    with open(script, "w", encoding="utf-8") as f:
        f.write(script_text)
    return {"res": res, "lexicon": os.path.join(res, "small.lex"),
            "ckpt_dir": os.path.dirname(ckpt), "hifigan": gpath,
            "config": cpath, "script": script}


def cli_argv(a, out_dir, hparams, steps, device, hifigan=True):
    argv = ["--script", a["script"], "--checkpoint-dir", a["ckpt_dir"],
            "--out-dir", out_dir, "--g2p-lexicon", a["lexicon"],
            "--max-decoder-steps", str(steps), "--hparams", hparams,
            "--device", device, "--overwrite"]
    if hifigan:
        argv += ["--hifigan-checkpoint", a["hifigan"],
                 "--hifigan-config", a["config"]]
    return argv


def phase_cli(Q, dev, gpu):
    """The text -> wav CLI (``apps/inference.run_inference``) in-process
    at full width: 4 script lines, int8 decode of 200 steps each (the gate
    never fires), HiFi-GAN v1 and bias removal.  Checks the wavs (22050 Hz
    int16, 200 x 256 samples), that bias removal ran on every line, and
    K1's launches (2 per decoder step); prints each line's wall time split
    into front end, acoustic model, HiFi-GAN, denoiser and wav write, the
    first line apart.  Then one line through Griffin-Lim (wall time,
    spectral convergence falling from iteration 1 to 30) and one f32 line
    of 20 steps on the card against the CPU, through the same per-line
    function: mel within 1e-5 and the pre-int16 wav within 1e-4 of their
    scale."""
    import importlib.util
    import os
    import shutil
    from pathlib import Path
    from scipy.io.wavfile import read
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.ops import stft as S
    from tacotron2_subword_tpu_torch.text.fst_g2p import FstG2PModel
    from tacotron2_subword_tpu_torch.utils.tree import cast_floats

    root = Path(__file__).resolve().parent / "_runs" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    a = cli_assets(str(root))
    os.environ["T2S_RESOURCES_DIR"] = a["res"]
    print(f"cli: assets in {time.perf_counter() - t0:.2f} s; G2P engine: "
          f"{'native' if FstG2PModel.native_available() else 'python'}")
    if importlib.util.find_spec("matplotlib") is None:
        TI.save_plots = lambda *args: None
        print("cli: matplotlib is not installed; the plot step is a no-op")

    results = []
    synth = TI.synthesize_text

    def spy(syn, text):
        results.append(synth(syn, text))
        return results[-1]
    TI.synthesize_text = spy
    args = TI.build_argparser().parse_args(cli_argv(
        a, str(root / "out"), "[decode_quant:int8-gate_threshold:1.1]",
        CLI_STEPS, str(dev)))
    try:
        Q.launches = 0
        t0 = time.perf_counter()
        n_done = TI.run_inference(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = Q.launches
    finally:
        TI.synthesize_text = synth
    steps = sum(r["steps_run"] for r in results)
    if n_done != 4 or len(results) != 4:
        raise AssertionError(f"cli rendered {n_done} lines, want 4")
    if launches != 2 * steps or steps != 4 * CLI_STEPS:
        raise AssertionError(f"cli: K1 launched {launches} times in {steps} "
                             f"decoder steps; want 2 per step, 4 x "
                             f"{CLI_STEPS} steps")
    for i, r in enumerate(results):
        sr, wav = read(str(root / "out" / "audio" / f"u{i}.wav"))
        if sr != 22050 or wav.dtype != np.int16 \
                or wav.shape != (CLI_STEPS * 256,):
            raise AssertionError(f"cli: u{i}.wav is {sr} Hz {wav.dtype} "
                                 f"{wav.shape}")
        if "denoiser" not in r["times"]:
            raise AssertionError(f"cli: no bias removal on u{i}")
        if not np.isfinite(r["wav"]).all() or np.abs(r["wav"]).max() < 1:
            raise AssertionError(f"cli: u{i} is silent or not finite")
    keys = ("front_end", "acoustic", "vocoder", "denoiser", "wav_write")
    audio_s = CLI_STEPS * 256 / 22050

    def split(rs):
        row = {k: float(np.mean([r["times"][k] for r in rs])) * 1e3
               for k in keys}
        row["line_ms"] = sum(row[k] for k in keys)
        row["audio_s_per_s"] = audio_s / row["line_ms"] * 1e3
        return row
    # what decoder_infer's quantisation of the LSTM weights costs per line
    params, _ = TI.load_acoustic_model(
        os.path.join(a["ckpt_dir"], "checkpoint_1"), TacotronConfig(), dev)
    dp = cast_floats(params["decoder"], torch.bfloat16)
    del params
    q_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        tq = time.perf_counter()
        TM._stack_stream_params(dp, "int8")
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - tq) * 1e3)
    report = {"lines": 4, "steps_per_line": CLI_STEPS, "k1_launches": launches,
              "wall_s": wall, "first_line": split(results[:1]),
              "later_lines": split(results[1:]),
              "quantize_ms": q_ms,
              "wav_peak": float(max(np.abs(r["wav"]).max() for r in results)),
              "wav_clipped_share": float(np.mean(np.concatenate([
                  np.abs(r["wav"]) >= 32767 for r in results]))),
              "gpu": gpu}
    print("cli", json.dumps(report))

    # Griffin-Lim: the same CLI without a vocoder checkpoint, one line
    gl_args = TI.build_argparser().parse_args(cli_argv(
        a, str(root / "out_gl"), "[decode_quant:int8-gate_threshold:1.1]",
        CLI_STEPS, str(dev), hifigan=False))
    syn = TI.load_synthesizer(gl_args)
    synth(syn, "ba me em")     # warm-up: the STFT constants on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = synth(syn, "nam anh em ba banh me an")
    gl_wall = time.perf_counter() - t0
    spec = S.mel_to_linear(torch.from_numpy(r["mel"])[None].to(dev)) * 1000.0
    angles = (torch.rand(spec.shape, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 2 - 1) * np.pi
    conv = {}
    for k in (1, 2, 5, 10, 20, 30):
        x = S.griffin_lim(spec, 1024, 256, 1024, n_iters=k, angles=angles)
        est = S.stft_magnitude(x, 1024, 256, 1024)
        conv[k] = ((spec - est).norm() / spec.norm()).item()
    if not conv[30] < conv[1]:
        raise AssertionError(f"Griffin-Lim: spectral convergence {conv}")
    x1 = S.inverse_stft(spec, angles, 1024, 256, 1024)
    if not torch.equal(x1, S.inverse_stft(spec, angles, 1024, 256, 1024)):
        raise AssertionError("inverse_stft differs between two runs")
    gl = {"frames": r["n_frames"], "wall_ms": gl_wall * 1e3,
          "vocoder_ms": r["times"]["vocoder"] * 1e3,
          "acoustic_ms": r["times"]["acoustic"] * 1e3,
          "spectral_convergence": conv, "gpu": gpu}
    print("cli griffin-lim", json.dumps(gl))
    del syn

    # one f32 line, card against CPU, through the same per-line function
    outs = {}
    for device in (str(dev), "cpu"):
        p_args = TI.build_argparser().parse_args(cli_argv(
            a, str(root / "out_f32"),
            "[parity_mode:true-prenet_dropout_always_on:false-"
            "gate_threshold:1.1]", CLI_PARITY_STEPS, device))
        outs[device] = synth(TI.load_synthesizer(p_args), "ba me em nam")
    c, h = outs[str(dev)], outs["cpu"]
    errs = {k: float(np.abs(c[k] - h[k]).max() / np.abs(h[k]).max())
            for k in ("mel", "wav")}
    if c["n_frames"] != h["n_frames"] or c["wav"].shape != h["wav"].shape \
            or errs["mel"] > 1e-5 or errs["wav"] > 1e-4:
        raise AssertionError(f"cli f32 line, card vs CPU: {errs}, frames "
                             f"{c['n_frames']} / {h['n_frames']}")
    print("cli f32 line (card vs CPU, 20 steps):", json.dumps(errs))
    return launches


AT_TRAIN = 16        # utterances of the after-training corpus, 1-4 s
AT_GAN_ITERS = 4     # GAN iterations before the resume
AT_STEPS = 200       # decoder steps of the inference CLI and the sweep
AT_INT8 = "[decode_quant:int8]"
# the frame near which the seeded checkpoints' lines stop (timer_gate), at
# the sweep's gate threshold 0.5 (the CLI's default); the sweep asserts
# every line ran AT_MIN_FRAMES frames or more and stopped by AT_STEPS
AT_STOP = 130
AT_MIN_FRAMES = 100
# one f32 GAN step at B=2, card vs CPU: each leaf's gradient within
# GAN_GRAD_RTOL of its largest element and GAN_GRAD_NORM_RTOL of its norm,
# the params after it within GAN_PARAM_ATOL
# (the readings on an H100: G's gradients 2.3e-3 / 3.5e-3 of the max and
# 7.8e-4 of the norm, D's 7.2e-6; params 8.7e-7 to 1.07e-5: PERF.md)
GAN_GRAD_RTOL = 2e-2
GAN_GRAD_NORM_RTOL = 5e-3
GAN_PARAM_ATOL = 5e-5
# seconds of the (synthesized, ground-truth) benchmark pairs: the long one
# gives K3 N, M >= 1520 frames (16 warps, 4 strips, boundary rows in the
# scratch: ops/softdtw._k3_smem_bytes)
AT_PAIRS = ((3.1, 2.9), (18.5, 19.0))


def at_tone(rng, seconds, sr=22050):
    """A seeded voiced-like wav in [-1, 1]: an F0 glide in 100-250 Hz with
    4 harmonics under a syllable-rate envelope, plus noise."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 250) * (1 + 0.2 * np.sin(
        2 * np.pi * rng.uniform(0.2, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    w = sum(rng.uniform(0.05, 0.25) / k * np.sin(k * phase)
            for k in range(1, 5))
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * rng.uniform(1, 3) * t))
    return (w * env + 0.01 * rng.randn(n)).astype(np.float32)


def write_wav16(path, wav, sr=22050):
    from scipy.io.wavfile import write
    write(str(path), sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def write_at_corpus(root, rng):
    """AT_TRAIN utterances of 1-4 s in the reference layout: ``wav/`` (22050
    Hz int16), ``durs/`` (phone ID, frames; the frames sum to the mel
    length len // 256 + 1, 4 per phone), ``subs/``, ``cls/`` (768 f32) and
    a ``train.txt`` of ``wav|durs`` rows.  Returns the wav lengths."""
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    cfg = TacotronConfig()
    for sub in ("wav", "durs", "subs", "cls"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rows, lens = [], []
    for i in range(AT_TRAIN):
        wav = at_tone(rng, rng.uniform(1.0, 4.0))
        write_wav16(root / "wav" / f"utt{i}.wav", wav)
        lens.append(len(wav))
        T = len(wav) // 256 + 1
        n_ph = T // 4
        durs = np.full(n_ph, T // n_ph)
        durs[:T % n_ph] += 1
        np.save(root / "durs" / f"{i}.npy", np.stack(
            [rng.randint(1, cfg.n_symbols, n_ph), durs], axis=1
        ).astype(np.int32))
        np.save(root / "subs" / f"{i}.npy",
                rng.randint(0, cfg.sub_n_symbols, n_ph // 3))
        np.save(root / "cls" / f"{i}.npy",
                rng.randn(cfg.bert_embedding_dim).astype(np.float32))
        rows.append(f"{root / 'wav' / f'utt{i}.wav'}|"
                    f"{root / 'durs' / f'{i}.npy'}\n")
    (root / "train.txt").write_text("".join(rows))
    return lens


def timer_gate(dp, stop_at: int):
    """Give the random decoder params ``dp`` a stop token that fires near
    frame ``stop_at`` at gate threshold 0.5, as a trained decoder's fires
    at the end of its text (random weights hold the gate's probability
    near 0.5 at every frame, so a line stops at its first frame or runs to
    the step limit).  Unit 0 of the decoder LSTM becomes a counter: its
    input, forget and output gates are held open (bias 12), its cell input
    is atanh(1 / stop_at) with every weight into its four gates scaled by
    1e-4, so its cell is ~t / stop_at and its output tanh(t / stop_at) at
    frame t.  The gate layer reads that output with weight 8 and bias
    -8 tanh(1): its logit crosses 0 near t = stop_at, rising 3.4 /
    stop_at per frame there; the rest of the gate layer stays random.
    In place."""
    import math
    r, g = dp["decoder_rnn"], dp["gate_layer"]
    H = r["w_hh"].shape[1]
    rows = [0, H, 2 * H, 3 * H]   # unit 0's i, f, g, o rows
    with torch.no_grad():
        for k in ("w_ih", "w_hh"):
            r[k][rows] *= 1e-4
        r["b_hh"][rows] = 0.0
        r["b_ih"][rows] = torch.tensor(
            [12.0, 12.0, math.atanh(1.0 / stop_at), 12.0])
        g["w"][0, 0] = 8.0
        g["b"][0] = -8.0 * math.tanh(1.0)


def _spy(module, name, calls):
    """Replace ``module.name`` by a wrapper that appends (args, result) to
    ``calls``; returns a function that puts the original back."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        calls.append((a, out))
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def _timed(fn, reps=3):
    """Mean wall s of ``fn`` over ``reps`` calls after one warm-up, each
    ended by a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_after_training(Q, SD, dev, gpu):
    """The after-training pipeline at full width (TacotronConfig, HiFi-GAN
    v1 with MPD + MSD), every CLI in-process through its main(argv):
     1. a seeded corpus: AT_TRAIN wavs of 1-4 s with durations, subword IDs
        and [CLS]; two full-width acoustic checkpoints (seeds 0 and 1, steps
        100 and 200, a ``timer_gate`` stopping their lines near frame
        AT_STOP) by save_checkpoint;
     2. GTA over the train list at B=16: each mel has the target's frames;
        one f32 batch, dropout off, on the card against the CPU;
     3. HiFi-GAN on the GTA mels at B=16, segment 8192: from a seeded state
        file (``unit_norm_generator``, fresh MPD/MSD and Adam) AT_GAN_ITERS
        iterations with a checkpoint, --resume for 2 (the state handed to
        the loop bit-equal to the file; iterations and loss-curve rows go
        on), --mel-only --stft-loss-weight 1 for 2 (discriminators frozen);
        D and G step times and peak memory; one f32 step at B=2 on the card
        against the CPU from the same state and batch;
     4. the inference CLI with the g_ file just written (int8 decode, 4
        lines x AT_STEPS steps, K1 counted), then remove_silence;
     5. evaluation mcd and softdtw against ground-truth wavs (the 4 lines
        against corpus wavs, plus 2 seeded pairs, one of 18-19 s): K3 once
        per file, each value bit-equal to its plain version, its device ms
        at each shape with bound and plain ms;
     6. best_checkpoint over both checkpoints with the int8 decode and the
        port-trained g_ file at the gate threshold 0.5: every line stops
        between AT_MIN_FRAMES and AT_STEPS frames and is scored; K1 == 2 x
        decoder steps; a second sweep skips every row.
    Returns {k1: launches, k3: launches, k3_shapes: rows}."""
    import importlib.util
    import os
    import shutil
    from pathlib import Path
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.apps import best_checkpoint as TBC
    from tacotron2_subword_tpu_torch.apps import evaluation as TE
    from tacotron2_subword_tpu_torch.apps import gta as TG
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.apps import remove_silence as TRS
    from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
    from tacotron2_subword_tpu_torch.config import (TacotronConfig,
                                                    create_config)
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.utils import checkpoint as CK
    from tacotron2_subword_tpu_torch.utils.tree import (to_device,
                                                        tree_leaves)

    root = Path(__file__).resolve().parent / "_runs" / "after_training"
    shutil.rmtree(root, ignore_errors=True)
    data, ck, gt = root / "data", root / "ck", root / "gt"
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    lens = write_at_corpus(data, rng)
    res = write_resources(str(root))
    os.environ["T2S_RESOURCES_DIR"] = res
    for step, seed in ((100, 0), (200, 1)):
        state, _ = TT.create_train_state(torch.Generator().manual_seed(seed),
                                         TacotronConfig(), device="cpu")
        timer_gate(state.params["decoder"], AT_STOP)
        CK.save_checkpoint(state._replace(step=step), str(ck))
        del state
    print(f"after-training: corpus and checkpoints in "
          f"{time.perf_counter() - t0:.2f} s")
    report = {"gpu": gpu}

    # 2. GTA
    gta = root / "gta"
    gta_argv = [str(data / "train.txt"), str(ck / "checkpoint_200"),
                str(gta), "--sub-dir", str(data / "subs"), "--cls-dir",
                str(data / "cls"), "--batch-size", "16", "--device", str(dev)]
    fwd_s = []
    real_forward = TM.forward

    def timed_forward(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_forward(*a, **k)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t)
        return out
    TM.forward = timed_forward
    try:
        t0 = time.perf_counter()
        n_gta = TG.main(gta_argv)
        gta_wall = time.perf_counter() - t0
        n_again = TG.main(gta_argv + ["--overwrite"])
    finally:
        TM.forward = real_forward
    if n_gta != AT_TRAIN or n_again != AT_TRAIN or len(fwd_s) != 2:
        raise AssertionError(f"gta: {n_gta}, {n_again} mels in "
                             f"{len(fwd_s)} batches")
    for i, n in enumerate(lens):
        m = np.load(gta / f"utt{i}.npy")
        if m.shape != (80, n // 256 + 1) or not np.isfinite(m).all():
            raise AssertionError(f"gta: utt{i} {m.shape}, want "
                                 f"(80, {n // 256 + 1})")
    # one f32 batch (the 2 shortest), dropout off, card vs CPU
    cfg32 = create_config("[parity_mode:true-prenet_dropout_always_on:false]")
    args32 = TG.build_argparser().parse_args(gta_argv + ["--overwrite"])
    utts = sorted(TG.read_utterances(args32, cfg32),
                  key=lambda u: u["mel"].shape[1])[:2]
    outs = {}
    with torch.inference_mode():
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p, bn = TI.load_acoustic_model(str(ck / "checkpoint_200"), cfg32,
                                           d)
            o, _ = TM.forward(p, bn, cfg32, TG.make_batch(utts, d),
                              training=False)
            outs[name] = o["mel_postnet"].cpu()
    gta_err = ((outs["card"] - outs["cpu"]).abs().max()
               / outs["cpu"].abs().max()).item()
    if not gta_err <= 1e-4:
        raise AssertionError(f"gta f32 batch, card vs CPU: {gta_err}")
    report["gta"] = {"utts": AT_TRAIN, "B": 16, "wall_s": gta_wall,
                     "batch_ms_first": fwd_s[0] * 1e3,
                     "batch_ms": fwd_s[1] * 1e3,
                     "f32_card_vs_cpu": gta_err}
    print("after-training gta", json.dumps(report["gta"]))

    # 3. HiFi-GAN on the GTA mels
    h = HG.HifiganConfig()
    hifi = root / "hifigan"
    hifi.mkdir()
    g0 = unit_norm_generator(HG, h, 1)
    d0 = HG.init_discriminators(torch.Generator().manual_seed(2), "cpu")
    tx0 = TTH.make_optimizer(2e-4)
    TTH.save_gan_state(str(hifi / "state_00000000"), TTH.GanState(
        g0, d0, tx0.init(g0), tx0.init(d0)), 0)
    base = ["-o", str(hifi), "--wav-dir", str(data / "wav"), "--mel-dir",
            str(gta), "--batch-size", "16", "--log-interval", "2",
            "--device", str(dev)]
    restored = []
    undo = _spy(TTH, "restore_gan_state", restored)
    try:
        torch.cuda.reset_peak_memory_stats()
        r1 = TTH.main(base + ["--resume", str(hifi / "state_00000000"),
                              "--iters", str(AT_GAN_ITERS),
                              "--iters-per-checkpoint", str(AT_GAN_ITERS)])
        peak = torch.cuda.max_memory_allocated()
        s4 = f"state_{AT_GAN_ITERS:08d}"
        saved = torch.load(hifi / s4, map_location="cpu", weights_only=True)
        r2 = TTH.main(base + ["--resume", str(hifi / s4), "--iters", "2",
                              "--iters-per-checkpoint", "2"])
        s6 = f"state_{AT_GAN_ITERS + 2:08d}"
        r3 = TTH.main(base + ["--resume", str(hifi / s6), "--iters", "2",
                              "--iters-per-checkpoint", "2", "--mel-only",
                              "--stft-loss-weight", "1.0"])
    finally:
        undo()
    last = AT_GAN_ITERS + 4
    got = restored[1][1][0]
    same = [torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves([got.gen, got.disc, got.opt_g._asdict(),
                     got.opt_d._asdict()]),
        tree_leaves([saved["gen"], saved["disc"], saved["opt_g"],
                     saved["opt_d"]]))]
    if not (len(same) > 300 and all(same)
            and restored[1][1][1] == AT_GAN_ITERS):
        raise AssertionError(f"hifigan resume: {sum(same)}/{len(same)} "
                             f"leaves equal")
    s8 = torch.load(hifi / f"state_{last:08d}", map_location="cpu",
                    weights_only=True)
    s6d = torch.load(hifi / s6, map_location="cpu", weights_only=True)
    frozen = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(s8["disc"]), tree_leaves(s6d["disc"])))
    curve = (hifi / "loss_curve.csv").read_text().splitlines()
    its = [int(l.split(",")[0]) for l in curve[1:]]
    losses = [l for r in (r1, r2, r3) for l in r["losses"]]
    if not (frozen and its == list(range(2, last + 1, 2))
            and r2["start_iteration"] == AT_GAN_ITERS
            and r3["iterations"] == last
            and np.isfinite(losses).all()
            and [l[0] for l in r3["losses"]] == [0.0]
            and (hifi / f"g_{last:08d}").is_file()):
        raise AssertionError(f"hifigan CLI: frozen {frozen}, iterations "
                             f"{its}, losses {losses}")
    # D and G step times at B=16 from the trained state and a sampled batch
    template = TTH.GanState(g0, d0, tx0.init(g0), tx0.init(d0))
    st, _ = TTH.restore_gan_state(str(hifi / f"state_{last:08d}"), template,
                                  dev)
    ds = TTH.SegmentSampler(sorted(str(p) for p in (data / "wav").glob(
        "*.wav")), str(gta), seed=1)
    mel_np, audio_np = ds.sample_batch(16)
    mel_t = torch.from_numpy(mel_np).to(dev)
    audio_t = torch.from_numpy(audio_np).to(dev)
    tx_g = TTH.make_optimizer(2e-4, 0.999, r1["decay_every"])
    tx_d = TTH.make_optimizer(2e-4, 0.999, r1["decay_every"])
    full_s = _timed(lambda: TTH.gan_step(st, mel_t, audio_t, h, tx_g, tx_d))
    with torch.no_grad():
        y_hat = HG.generator_apply(st.gen, h, mel_t)
    d_s = _timed(lambda: TTH.discriminator_update(
        st.disc, st.opt_d, audio_t[:, None, :], y_hat, tx_d))
    del y_hat
    # one f32 step at B=2, card vs CPU, the same state and batch: the
    # losses, the gradients both optimizers are handed (leaf by leaf,
    # against the leaf's largest CPU gradient) and the params after it
    cpu = torch.device("cpu")
    st_cpu = TTH.GanState(*(to_device(x, cpu) for x in st))
    grads = {"card": [], "cpu": []}

    def recording(tx, store):
        def update(g, state, params=None):
            store.append(g)
            return tx.update(g, state, params)
        return TT.Optimizer(tx.init, update)
    new_c, m_c = TTH.gan_step(
        st_cpu, mel_t[:2].cpu(), audio_t[:2].cpu(), h,
        recording(tx_g, grads["cpu"]), recording(tx_d, grads["cpu"]))
    new_d, m_d = TTH.gan_step(
        st, mel_t[:2], audio_t[:2], h, recording(tx_g, grads["card"]),
        recording(tx_d, grads["card"]))
    loss_err = max(abs(m_d[k].item() - m_c[k].item())
                   / max(abs(m_c[k].item()), 1e-12) for k in m_c)
    # per step (D, G): the largest element error of a leaf over the leaf's
    # largest gradient, and the leaf's error norm over its gradient norm
    grad_err = {}
    for step, a_tree, b_tree in zip("dg", grads["card"], grads["cpu"]):
        pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(a_tree),
                                              tree_leaves(b_tree))]
        grad_err[step] = {
            "max_rel": max((a - b).abs().max().item()
                           / max(b.abs().max().item(), 1e-30)
                           for a, b in pairs),
            "norm_rel": max((a - b).norm().item() / max(b.norm().item(),
                                                        1e-30)
                            for a, b in pairs)}
    p_max = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves((new_d.gen, new_d.disc)),
        tree_leaves((new_c.gen, new_c.disc))))
    if not (loss_err <= 1e-4 and p_max <= GAN_PARAM_ATOL and all(
            e["max_rel"] <= GAN_GRAD_RTOL
            and e["norm_rel"] <= GAN_GRAD_NORM_RTOL
            for e in grad_err.values())):
        raise AssertionError(f"gan step card vs CPU: losses {loss_err}, "
                             f"gradients {grad_err} of their scale, "
                             f"params {p_max}")
    report["gan"] = {
        "B": 16, "segment": TTH.SEGMENT, "clips": r1["clips"],
        "cli_s_per_it_windows": r1["s_per_it"] + r2["s_per_it"],
        "cli_s_per_it": float(np.mean(r1["s_per_it"][1:] + r2["s_per_it"])),
        "mel_only_s_per_it": r3["s_per_it"], "step_s": full_s,
        "d_step_s": d_s,
        "g_step_s": full_s - d_s, "peak_mem_bytes": peak,
        "losses": losses, "f32_b2_card_vs_cpu": {
            "loss_rel": loss_err, "grad_err": grad_err,
            "param_max_abs": p_max}}
    print("after-training gan", json.dumps(report["gan"]))
    del st, st_cpu, new_c, new_d, mel_t, audio_t

    # 4. inference with the port-trained generator, then remove_silence
    g_file = str(hifi / f"g_{last:08d}")
    cpath = str(root / "config_v1.json")
    write_hifigan_config(cpath, h)
    script = root / "script.txt"
    script.write_text(CLI_SCRIPT, encoding="utf-8")
    if importlib.util.find_spec("matplotlib") is None:
        TI.save_plots = lambda *args: None
    lex = os.path.join(res, "small.lex")
    Q.launches = 0
    t0 = time.perf_counter()
    n_inf = TI.main(["--script", str(script), "--checkpoint-dir", str(ck),
                     "--out-dir", str(root / "infer"), "--g2p-lexicon", lex,
                     "--max-decoder-steps", str(AT_STEPS), "--hparams",
                     "[decode_quant:int8-gate_threshold:1.1]",
                     "--hifigan-checkpoint", g_file, "--hifigan-config",
                     cpath, "--device", str(dev), "--overwrite"])
    torch.cuda.synchronize()
    infer_wall = time.perf_counter() - t0
    k1_infer = Q.launches
    if n_inf != 4 or k1_infer != 2 * 4 * AT_STEPS:
        raise AssertionError(f"inference: {n_inf} lines, K1 {k1_infer}")
    bench = root / "bench"
    if TRS.main(["--in-dir", str(root / "infer" / "audio"), "--out-dir",
                 str(bench)]) != 4:
        raise AssertionError("remove_silence: not 4 wavs")
    gt.mkdir()
    for i in range(4):
        shutil.copy(data / "wav" / f"utt{i}.wav", gt / f"u{i}.wav")
    for k, (s_syn, s_gt) in enumerate(AT_PAIRS):
        write_wav16(bench / f"pair{k}.wav", at_tone(rng, s_syn))
        write_wav16(gt / f"pair{k}.wav", at_tone(rng, s_gt))
    from scipy.io.wavfile import read
    kept = {p.name: len(read(str(p))[1]) for p in sorted(bench.glob("*.wav"))}
    report["infer"] = {"lines": 4, "steps": AT_STEPS, "wall_s": infer_wall,
                       "k1_launches": k1_infer, "trimmed_samples": kept}
    print("after-training inference", json.dumps(report["infer"]))

    # 5. evaluation: MCD on the host, soft-DTW through K3
    t0 = time.perf_counter()
    mcd = TE.main(["mcd", "--benchmark", str(bench), "--gt-dir", str(gt)])
    mcd_s = time.perf_counter() - t0
    seen = []
    undo = _spy(SD, "softdtw_value", seen)
    try:
        SD.fwd_launches = 0
        t0 = time.perf_counter()
        sdtw = TE.main(["softdtw", "--benchmark", str(bench), "--gt-dir",
                        str(gt), "--device", str(dev)])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        k3_eval = SD.fwd_launches
    finally:
        undo()
    n_files = sum(1 for n in kept.values() if n)
    if k3_eval != n_files or len(seen) != n_files or not np.isfinite(sdtw):
        raise AssertionError(f"evaluation: K3 {k3_eval} launches for "
                             f"{n_files} files, mean {sdtw}")
    shapes = []
    for (D, *_), v in seen:
        D = D.contiguous()
        B, N, M = D.shape
        pv = SD.softdtw_value_plain(D)
        if not torch.equal(v, pv):
            raise AssertionError(f"evaluation K3 {(N, M)}: {v} vs plain {pv}")
        bound, by = sdtw_bound_ms(B, N, M, 0.0, False)
        shapes.append({"B": B, "N": N, "M": M, "value": v.item(),
                       "max_abs_err": (v - pv).abs().max().item(),
                       "ms": device_ms(lambda: SD.softdtw_value(D), 5),
                       "plain_ms": device_ms(
                           lambda: SD.softdtw_value_plain(D), 1),
                       "bound_ms": bound, "bound_by": by,
                       "plan": SD.k3_plan(B, N, M)._asdict()})
        print("after-training k3", json.dumps(shapes[-1]))
    if not any(r["plan"]["scratch_floats"] and r["N"] >= 512
               for r in shapes):
        raise AssertionError("evaluation: no shape took K3's scratch path")
    k3_ms = sum(r["ms"] for r in shapes)
    report["evaluation"] = {
        "files": n_files, "mcd_mean": mcd, "softdtw_mean": sdtw,
        "mcd_s": mcd_s, "softdtw_s": eval_s,
        "softdtw_ms_per_file": eval_s * 1e3 / n_files,
        "k3_share": k3_ms / (eval_s * 1e3), "k3_launches": k3_eval}
    print("after-training evaluation", json.dumps(report["evaluation"]))

    # 6. the checkpoint sweep, int8 decode, the port-trained vocoder
    sweep_argv = ["--checkpoint-dir", str(ck), "--script", str(script),
                  "--gt-dir", str(gt), "--out-csv", str(root / "sweep.csv"),
                  "--g2p-lexicon", lex, "--hifigan-checkpoint", g_file,
                  "--hifigan-config", cpath, "--max-decoder-steps",
                  str(AT_STEPS), "--hparams", AT_INT8, "--device", str(dev)]
    decodes = []
    undo = _spy(TM, "infer", decodes)
    try:
        Q.launches = 0
        rows = TBC.main(sweep_argv)
        k1_sweep = Q.launches
    finally:
        undo()
    steps = sum(out["steps_run"] for _, out in decodes)
    if len(rows) != 2 or len(decodes) != 2 or k1_sweep != 2 * steps:
        raise AssertionError(f"sweep: {len(rows)} rows, K1 {k1_sweep} in "
                             f"{steps} decoder steps")
    frames = [out["mel_lengths"].tolist() for _, out in decodes]
    if (min(map(min, frames)) < AT_MIN_FRAMES
            or any(r["failed"] or r["mcd_mean"] == "" for r in rows)):
        raise AssertionError(f"sweep: lines of {frames} frames, rows {rows}")
    if TBC.main(sweep_argv) != []:
        raise AssertionError("sweep: the second run did not skip every row")
    report["sweep"] = {
        "rows": [{k: v for k, v in r.items() if k != "seconds"}
                 for r in rows],
        "seconds": [r["seconds"] for r in rows],
        "mel_lengths": frames,
        "steps_run": [out["steps_run"] for _, out in decodes],
        "k1_launches": k1_sweep}
    print("after-training sweep", json.dumps(report["sweep"]))
    shutil.rmtree(root, ignore_errors=True)
    return {"k1": k1_infer + k1_sweep, "k1_infer": k1_infer,
            "k1_sweep": k1_sweep, "k3": k3_eval, "k3_shapes": shapes,
            "gan_step_s": report["gan"]["step_s"]}


def phase_gate_cost(TM, TI, L, params, bn, cfg, dev, gpu):
    """What the f32 LSTM gates cost on the serving path's non-quantized
    bf16 decode: the prepared LSTM weights in f32 (gates f32, as in JAX)
    against bf16 weights (bf16 gates, as the port had them), in turns
    (f32, bf16, bf16, f32).  Device ms of the two gate matmuls of one step
    (CUDA-graph replay) and wall us per decode step over 64 steps."""
    cfg_bf = cfg.replace(decode_quant="")
    f32_prepare = L.lstm_prepare
    bf16_prepare = lambda p: {
        "w": torch.cat([p["w_ih"], p["w_hh"]], dim=1).t().contiguous(),
        "b": p["b_ih"] + p["b_hh"]}
    rows = []
    for variant in ("f32", "bf16", "bf16", "f32"):
        L.lstm_prepare = f32_prepare if variant == "f32" else bf16_prepare
        try:
            for B in (4, 128):
                reqs = make_requests(cfg_bf, [(64, 32)] * B, seed=8)
                args = TI.pad_requests(reqs, dev)
                run = lambda: TM.infer(
                    params, bn, cfg_bf, *args[:4], text_lengths=args[4],
                    sub_lengths=args[5], max_steps=64, gate_threshold=1.1,
                    generator=torch.Generator(device=dev).manual_seed(0))
                run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                dp = {k: {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                      for k, v in params["decoder"].items()
                      if k in ("attention_rnn", "attention_rnn_bert",
                               "decoder_rnn")}
                w_att = torch.stack([L.lstm_prepare(dp["attention_rnn"])["w"],
                                     L.lstm_prepare(
                                         dp["attention_rnn_bert"])["w"]])
                w_dec = L.lstm_prepare(dp["decoder_rnn"])["w"]
                x_att = torch.randn((2, B, w_att.shape[1]), device=dev,
                                    dtype=torch.bfloat16)
                x_dec = torch.randn((B, w_dec.shape[0]), device=dev,
                                    dtype=torch.bfloat16)
                mm = lambda: (torch.bmm(x_att.to(w_att.dtype), w_att),
                              x_dec.to(w_dec.dtype) @ w_dec)
                rows.append({"gates": variant, "B": B,
                             "decode_wall_us_per_step": wall / 64 * 1e6,
                             "gate_matmuls_device_ms": device_ms(mm, 20),
                             "gpu": gpu})
                print("gate cost", json.dumps(rows[-1]))
        finally:
            L.lstm_prepare = f32_prepare
    return rows


ATT_VARIANTS = ("LocationSensitiveAttention", "ForwardAttentionV2",
                "ContentAttention", "DynamicConvolutionAttention",
                "GMMAttention")
# the variants whose loop reads no processed memory: their memory layer's
# gradient is exactly zero, in the JAX package too
ATT_NO_PROCESSED_MEMORY = ("DynamicConvolutionAttention", "GMMAttention")
ATT_PARITY_STEPS = 16   # the f32 decode, card against CPU, at B=2
ATT_DECODE_TOL = 2e-4   # |d| <= tol + tol * |ref|: the inference tests' bound
# |sum of a bf16 alignment row - 1|: the softmax sums to 1 in f32, then
# each weight is rounded to bf16 (unit roundoff 2^-8 of itself, so at most
# 2^-8 of the row); doubled
ATT_ROW_SUM_TOL = 2.0 ** -7
ATT_GRAD_RTOL = 1e-3    # f32 gradient, card vs CPU, of a leaf's max |g|


def attention_grads(TT, TM, params, bn, cfg, batch, rnd):
    """(dotted paths, gradients) of the total loss over the leaves of both
    streams' attention trees; zeros where the loss does not reach."""
    from tacotron2_subword_tpu_torch.utils.tree import tree_leaves, tree_map
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    out, _ = TM.forward(params, bn, cfg, batch, training=True,
                        randomness=rnd)
    total = TT.tacotron2_loss(out, batch, cfg, 0)["total"]
    att = {k: params["decoder"][k] for k in ("attention", "attention_bert")}
    leaves = tree_leaves(att)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return _tree_paths(att), [torch.zeros_like(p) if g is None else g
                              for g, p in zip(grads, leaves)]


def phase_attention_variants(Q, SD, dev, gpu):
    """The five attention variants other than SMA on the main paths at
    full width (seeded random weights, bf16 compute, f32 master params):
    for each, the 4 requests of ``phase_serve`` through ``synthesize``
    (int8 decode, 200 steps, gate 1.1: K1 == 2 x steps; finite mel and
    alignments, each alignment row summing to 1 within ATT_ROW_SUM_TOL),
    the decode's wall us per step at B=4 and its profile
    (``profile_decode``), an f32 decode at B=2 on the card against the CPU
    (ATT_PARITY_STEPS steps, ATT_DECODE_TOL), one bf16 soft-DTW train step
    at B=8, T_out=128 and one eval step (K2 == 1, K3 == 1, finite losses;
    every attention leaf's gradient finite, and non-zero except the memory
    layer of the variants that read no processed memory), and the f32
    gradient of every attention leaf at B=2, T_out=16 on the card against
    the CPU (ATT_GRAD_RTOL of the leaf's max |g|, floored at 1e-3 of the
    tree's).  Then one line of the inference CLI from a DCA checkpoint
    written by save_checkpoint, ``--hparams ...-attention:
    DynamicConvolutionAttention`` (K1 == 2 x steps).  Returns the kernel
    launches of the counted runs."""
    import os
    import importlib.util
    import shutil
    from pathlib import Path
    from scipy.io.wavfile import read
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.utils.tree import to_device
    cpu = torch.device("cpu")
    h = HG.HifiganConfig()
    gen_params = HG.fuse_generator(HG.init_generator(
        torch.Generator().manual_seed(1), h, device=dev))
    reqs = make_requests(TacotronConfig(), REQUESTS, seed=1)
    counts = {"k1": 0, "k2": 0, "k3": 0}
    rows = []
    for variant in ATT_VARIANTS:
        t_phase = time.perf_counter()
        row = {"variant": variant}
        cfg = TacotronConfig(decode_quant="int8", attention=variant)
        params_cpu, bn_cpu = TM.init_tacotron2(
            torch.Generator().manual_seed(0), cfg, device="cpu")
        params, bn = to_device(params_cpu, dev), to_device(bn_cpu, dev)

        # 1. serving: 4 requests, int8 decode, K1 counted
        serve = lambda seed, steps: TI.synthesize(
            params, bn, gen_params, cfg, h, reqs,
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, max_steps=steps, gate_threshold=1.1)
        serve(0, 16)   # warm-up: cuDNN plans of this variant's convs
        torch.cuda.synchronize()
        Q.launches = 0
        t0 = time.perf_counter()
        out = serve(1, 200)
        torch.cuda.synchronize()
        row["serve_s"] = time.perf_counter() - t0
        launches, steps = Q.launches, out["steps_run"]
        if launches != 2 * steps or steps != 200:
            raise AssertionError(f"{variant}: K1 launched {launches} times "
                                 f"in {steps} decoder steps; want 2 per "
                                 f"step, 200 steps")
        counts["k1"] += launches
        for k in ("mel_postnet", "alignments", "alignments_bert"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"{variant}: non-finite {k}")
        row_sum_err = max((out[k].sum(-1) - 1).abs().max().item()
                          for k in ("alignments", "alignments_bert"))
        if row_sum_err > ATT_ROW_SUM_TOL:
            raise AssertionError(f"{variant}: an alignment row sums to 1 "
                                 f"+- {row_sum_err}")
        row.update(k1_launches=launches, steps=steps,
                   align_row_sum_max_err=row_sum_err)

        # 2. the decode alone at B=4: wall per step, then its profile
        args = TI.pad_requests(reqs, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = TM.infer(params, bn, cfg, *args[:4], text_lengths=args[4],
                     sub_lengths=args[5], max_steps=200, gate_threshold=1.1,
                     generator=torch.Generator(device=dev).manual_seed(2))
        torch.cuda.synchronize()
        row["decode_wall_us_per_step"] = ((time.perf_counter() - t0)
                                          / o["steps_run"] * 1e6)
        prof, _ = profile_decode(TM, TI, params, bn, cfg, dev, REQUESTS)
        row["profile"] = {k: prof[k] for k in (
            "wall_us_per_step", "device_us_per_step", "device_busy_share",
            "kernel_launches_per_step", "k1_launches_per_step",
            "top_kernels_us_per_step")}
        del params, bn, out, o

        # 3. f32 decode at B=2, card against CPU
        cfg32 = cfg.replace(compute_dtype="float32",
                            prenet_dropout_always_on=False)
        dec = []      # the card's decode, then the CPU's
        for d, p, b in ((dev, to_device(params_cpu, dev),
                         to_device(bn_cpu, dev)),
                        (cpu, params_cpu, bn_cpu)):
            a2 = TI.pad_requests(reqs[:2], d)
            dec.append(TM.infer(p, b, cfg32, *a2[:4], text_lengths=a2[4],
                                sub_lengths=a2[5], max_steps=ATT_PARITY_STEPS,
                                gate_threshold=1.1))
        errs = {}
        for k in ("mel_postnet", "alignments", "alignments_bert"):
            a, ref = dec[0][k].cpu(), dec[1][k]
            errs[k] = (a - ref).abs().max().item()
            if not (a.shape == ref.shape and ((a - ref).abs() <= ATT_DECODE_TOL
                                              * (1 + ref.abs())).all()):
                raise AssertionError(f"{variant}: f32 decode card vs CPU "
                                     f"{k} max|d| {errs[k]}")
        row["f32_decode_max_abs"] = errs
        del dec, params_cpu, bn_cpu

        # 4. one bf16 soft-DTW train step and one eval step, K2 / K3 counted
        cfg_train = TacotronConfig(softdtw_loss_weight=1.0,
                                   attention=variant)
        state, tx = TT.create_train_state(torch.Generator().manual_seed(0),
                                          cfg_train, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = train_batch(cfg_train, dev, TRAIN_B, TRAIN_T_OUT)
        state, _ = TT.train_step(state, batch, cfg_train, tx,
                                 generator=gen)    # warm-up
        torch.cuda.synchronize()
        SD.grad_launches = SD.fwd_launches = 0
        t0 = time.perf_counter()
        new_state, m = TT.train_step(state, batch, cfg_train, tx,
                                     generator=gen)
        torch.cuda.synchronize()
        row["train_ms_per_step"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        losses, _ = TT.eval_step(new_state, batch, cfg_train, generator=gen)
        torch.cuda.synchronize()
        row["eval_ms"] = (time.perf_counter() - t0) * 1e3
        k2, k3 = SD.grad_launches, SD.fwd_launches
        if k2 != 1 or k3 != 1:
            raise AssertionError(f"{variant}: K2 launched {k2} times in a "
                                 f"train step, K3 {k3} times in an eval "
                                 f"step; want 1 and 1")
        counts["k2"] += k2
        counts["k3"] += k3
        vals = [v.item() for v in (*m.values(), *losses.values())]
        if not np.isfinite(vals).all() or m["skipped"].item() != 0.0:
            raise AssertionError(f"{variant}: train step {m}, eval {losses}")
        row["train_loss"] = m["total"].item()
        rnd = TM.make_randomness(
            cfg_train, TRAIN_B, TRAIN_T_TEXT, TRAIN_T_SUB, TRAIN_T_OUT,
            training=True, generator=gen, device=dev)
        paths, grads = attention_grads(TT, TM, state.params, state.bn_state,
                                       cfg_train, batch, rnd)
        for path, g in zip(paths, grads):
            zero = (variant in ATT_NO_PROCESSED_MEMORY
                    and path.split(".")[1] == "memory")
            if not torch.isfinite(g).all() or (g.abs().max().item() == 0.0) \
                    != zero:
                raise AssertionError(f"{variant}: bf16 gradient of {path}: "
                                     f"max |g| {g.abs().max().item()}")
        del state, new_state, batch, grads

        # 5. the f32 gradient of every attention leaf, card against CPU
        cfg32 = cfg_train.replace(parity_mode=True)
        params_c, bn_c = TM.init_tacotron2(torch.Generator().manual_seed(2),
                                           cfg32, device="cpu")
        batch_c = train_batch(cfg32, cpu, B=2, t_out=16, T_text=16, T_sub=8,
                              seed=3)
        rnd_c = TM.make_randomness(cfg32, 2, 16, 8, 16, training=True,
                                   generator=torch.Generator().manual_seed(4))
        paths, g_c = attention_grads(TT, TM, params_c, bn_c, cfg32, batch_c,
                                     rnd_c)
        _, g_d = attention_grads(TT, TM, to_device(params_c, dev),
                                 to_device(bn_c, dev), cfg32,
                                 to_device(batch_c, dev),
                                 to_device(rnd_c, dev))
        floor = 1e-3 * max(g.abs().max().item() for g in g_c)
        worst = []
        for path, c, d in zip(paths, g_c, g_d):
            rel = ((d.cpu() - c).abs().max().item()
                   / max(c.abs().max().item(), floor))
            worst.append((rel, path))
            if rel > ATT_GRAD_RTOL:
                raise AssertionError(f"{variant}: f32 gradient of {path}, "
                                     f"card vs CPU: {rel} of its max")
        worst.sort(reverse=True)
        row["f32_grad_worst_rel"] = worst[:3]
        row["phase_s"] = time.perf_counter() - t_phase
        row["gpu"] = gpu
        rows.append(row)
        print("attention variant", json.dumps(row))

    # one line of the inference CLI from a DCA checkpoint
    root = Path(__file__).resolve().parent / "_runs" / "attention_cli"
    shutil.rmtree(root, ignore_errors=True)
    dca = "DynamicConvolutionAttention"
    a = cli_assets(str(root), TacotronConfig(attention=dca),
                   "u0|nam anh em ba banh me an nhanh\n")
    os.environ["T2S_RESOURCES_DIR"] = a["res"]
    if importlib.util.find_spec("matplotlib") is None:
        TI.save_plots = lambda *args: None
    argv = cli_argv(a, str(root / "out"), "[decode_quant:int8-"
                    f"gate_threshold:1.1-attention:{dca}]", CLI_STEPS,
                    str(dev))
    Q.launches = 0
    t0 = time.perf_counter()
    n_done = TI.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Q.launches
    sr, wav = read(str(root / "out" / "audio" / "u0.wav"))
    if n_done != 1 or launches != 2 * CLI_STEPS or sr != 22050 \
            or wav.shape != (CLI_STEPS * 256,) or np.abs(wav).max() < 1:
        raise AssertionError(f"{dca} CLI: {n_done} lines, K1 {launches} "
                             f"launches (want {2 * CLI_STEPS}), wav "
                             f"{sr} Hz {wav.shape}")
    counts["k1"] += launches
    print(f"attention variants: {dca} CLI line, {CLI_STEPS} steps, K1 "
          f"{launches} launches, {wall:.4f} s wall (first line of the "
          f"process, model and vocoder load included; {gpu})")
    shutil.rmtree(root, ignore_errors=True)
    return counts, rows


# ---------------------------------------------------------------------------
# Vocoders and tools: WaveGlow, the ONNX vocoder, the remaining tool CLIs
# ---------------------------------------------------------------------------

WG_FRAMES = 200          # 2.32 s of audio at hop 256
WG_PARITY_FRAMES = 16    # the f32 synthesis on the card against the CPU
WG_END_STD = 3e-3        # seeded end convs: each coupling does real work
WG_F32_TOL = 1e-4        # f32 synthesis, card vs CPU, of the wav's max
WG_BF16_TOL = 0.1        # bf16 against f32 synthesis on the card, of max
WG_TRAIN_ITERS = 4       # train_waveglow iterations before the resume
WG_STEP_SAMPLES = 4000   # the f32 train step, card vs CPU, at B=1
WG_GRAD_RTOL = 1e-3      # its gradients, of each leaf's max |g|
ONNX_TOL = 1e-5          # the ONNX executor against generator_apply
# preprocess mels, card vs CPU, of the mels' scale: a log-mel bin of low
# energy turns the f32 STFT's rounding (another sum order on the card) into
# a larger log error; the GTA mels' card-vs-CPU bound
MEL_TOL = 1e-4
DEMO_SENTENCES = "Ba me em nam. Anh banh an me ba! Em nam ba me?"


def waveglow_flops_per_sample(cfg) -> float:
    """FLOPs of one synthesized sample at ``cfg``'s widths: per flow and
    per group step of n_group samples, the WN's start conv, the cond conv,
    the dilated in_layers, the res / skip convs and the end conv, and the
    1x1 mixing; plus the upsampler's share (one transposed conv frame per
    hop)."""
    C, L, k, G = cfg.wn_channels, cfg.wn_layers, cfg.wn_kernel_size, \
        cfg.n_group
    total, n_rem = 0.0, G
    for f in range(cfg.n_flows):
        if f % cfg.n_early_every == 0 and f > 0:
            n_rem -= cfg.n_early_size
        h = n_rem // 2
        macs = (h * C + cfg.n_mel_channels * G * 2 * C * L + L * 2 * C * C * k
                + (L - 1) * 2 * C * C + C * C + C * 2 * h + n_rem * n_rem)
        total += 2 * macs
    M = cfg.n_mel_channels
    return total / G + 2 * M * M * cfg.upsample_kernel / cfg.upsample_stride


def wg_seeded(WG, cfg, seed):
    """Seeded WaveGlow params on the CPU with each end conv drawn from
    N(0, WG_END_STD) (at init it is zero, every coupling the identity)."""
    gen = torch.Generator().manual_seed(seed)
    p = WG.init_waveglow(gen, cfg, device="cpu")
    for wn in p["wn"]:
        wn["end"]["w"] = WG_END_STD * torch.randn(wn["end"]["w"].shape,
                                                  generator=gen)
    return p


def wg_reference_state_dict(params, cfg, layout):
    """The reference state dict of the port's WaveGlow ``params`` in one of
    its three layouts: "fused" (cond_layer, res_skip_layers), "vendored"
    (cond_layers.{i}) and "old" (cond_layers.{i}, res_layers /
    skip_layers; the last layer has no res conv), by splitting rows."""
    C, L = cfg.wn_channels, cfg.wn_layers
    sd = {"upsample.weight": params["upsample"]["w"],
          "upsample.bias": params["upsample"]["b"]}

    def put(prefix, conv, rows=slice(None)):
        for k, name in (("v", "weight_v"), ("g", "weight_g"),
                        ("w", "weight"), ("b", "bias")):
            if k in conv:
                sd[f"{prefix}.{name}"] = conv[k][rows].clone()

    for f in range(cfg.n_flows):
        sd[f"convinv.{f}.conv.weight"] = params["convinv"][f]["w"][:, :, None]
        wn, pre = params["wn"][f], f"WN.{f}"
        for name in ("start", "end"):
            put(f"{pre}.{name}", wn[name])
        for i in range(L):
            put(f"{pre}.in_layers.{i}", wn["in_layers"][i])
            if layout == "fused":
                continue
            put(f"{pre}.cond_layers.{i}", wn["cond"],
                slice(i * 2 * C, (i + 1) * 2 * C))
        if layout == "fused":
            put(f"{pre}.cond_layer", wn["cond"])
        for i in range(L):
            rs = wn["res_skip"][i]
            if layout != "old":
                put(f"{pre}.res_skip_layers.{i}", rs)
            elif i < L - 1:
                put(f"{pre}.res_layers.{i}", rs, slice(0, C))
                put(f"{pre}.skip_layers.{i}", rs, slice(C, 2 * C))
            else:
                put(f"{pre}.skip_layers.{i}", rs)
    return sd


def _median_s(fn, reps=5):
    """Median wall s of ``fn`` over ``reps`` calls after one warm-up, each
    ended by a device sync (a slow call now and then, as the host's other
    work gives, does not move it)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _sync_sites(fn):
    """The host syncs ``fn`` makes, {"file:line": count} of the lines that
    made them (torch's sync debug mode warns at each one)."""
    import collections
    import os
    import traceback
    import warnings
    sites = collections.Counter()
    real = warnings.showwarning

    def record(message, category, filename, lineno, *a, **k):
        if "synchroniz" in str(message):
            here = [f for f in traceback.extract_stack()
                    if "tacotron2_subword_tpu_torch" in f.filename]
            f = here[-1] if here else None
            sites[f"{os.path.basename(f.filename)}:{f.lineno}" if f
                  else f"{filename}:{lineno}"] += 1
    warnings.showwarning = record
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        warnings.showwarning = real
    return dict(sites)


def profile_call(fn, n_top=6):
    """One call of ``fn`` under ``utils.xprof.device_profile``:
    wall ms, device ms (busy: the union of the device intervals),
    device-busy share, kernel launches and the kernels with the most
    device time."""
    from tacotron2_subword_tpu_torch.utils import xprof
    fn()
    torch.cuda.synchronize()
    with xprof.device_profile() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = xprof.profile_summary(prof)
    return {"wall_ms": wall * 1e3, "device_ms": s.busy_ms,
            "device_busy_share": s.busy_ms / (wall * 1e3),
            "kernel_launches": s.n_events,
            "top_kernels_ms": [[name[:70], ms, n]
                               for name, ms, n in s.ops[:n_top]]}


def phase_vocoders_and_tools(Q, dev, gpu):
    """WaveGlow, the ONNX HiFi-GAN and the remaining tool CLIs at full
    width (the published WaveGlow widths, HiFi-GAN v1, the Tacotron 2 of
    ``phase_cli``), every CLI in-process through its main(argv):
     1. WaveGlow synthesis from seeded weights (``wg_seeded``) of a 200-frame
        mel: f32 and bf16 at B=1 and B=4, kHz of audio per second against
        the FLOP bound (``waveglow_flops_per_sample``), the host syncs of
        one synthesis (W's inverse); one f32 synthesis of WG_PARITY_FRAMES
        frames on the card against the CPU with the latents injected
        (WG_F32_TOL), and bf16 against f32 (WG_BF16_TOL);
     2. the reference round trip: one seeded WaveGlow through its three
        state-dict layouts imports to three equal trees, equal to it;
     3. train_waveglow at the published widths on the corpus of
        ``phase_after_training`` (``write_at_corpus``, seed 0): B=4,
        WG_TRAIN_ITERS iterations with checkpoints, then --resume for 2 (the
        loaded params, Adam state and sampler bit-equal to the file, the
        iterations going on); s/it and peak memory; the f32 loss and
        gradients of one step at B=1 on a WG_STEP_SAMPLES segment on the
        card against the CPU (loss 1e-5 relative, each gradient leaf
        WG_GRAD_RTOL of its max);
     4. ONNX: ``phase_cli``'s g_ file exported by the port's exporter, the
        executor on the card against ``generator_apply`` (ONNX_TOL) with
        both timed, one int8 CLI line with the .onnx vocoder (K1 == 2 x
        steps, 32768 scaling, no denoiser) timed by stage;
     4b. TFLite, with tensorflow unimportable: the same g_ file exported by
        the port's exporter at 256 frames (the CLI's bucket for 200 steps),
        the executor on the card against ``generator_apply`` (ONNX_TOL),
        both timed and their kernel launches counted, a 192-frame mel
        refused, and one int8 CLI line with the .tflite vocoder (K1 == 2 x
        steps, 32768 scaling, no denoiser) timed by stage;
     5. the tools: preprocess mels of the 16 corpus wavs on the card
        against the CPU (MEL_TOL of the scale) with ms per wav, phones,
        subwords (crc32), lists and check; dump_phone_id_map on the 7-word
        lexicon; check_bert_emb --fallback-vocabs; the demo on three
        sentences with the int8 decode (K1 == 2 x steps), wall per
        sentence.
    Returns {k1_onnx, k1_tflite, k1_demo}: the K1 launches of the counted
    runs."""
    import importlib.util
    import os
    import shutil
    from pathlib import Path
    from scipy.io.wavfile import read
    from tacotron2_subword_tpu_torch.apps import check_bert_emb as TCB
    from tacotron2_subword_tpu_torch.apps import demo as TD
    from tacotron2_subword_tpu_torch.apps import dump_phone_id_map as TDP
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.apps import preprocess as TP
    from tacotron2_subword_tpu_torch.apps import train_waveglow as TTW
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import waveglow as WG
    from tacotron2_subword_tpu_torch.tools import export_hifigan_onnx as TEX
    from tacotron2_subword_tpu_torch.tools import \
        export_hifigan_tflite as TTX
    from tacotron2_subword_tpu_torch.utils import tflite_lite as TL
    from tacotron2_subword_tpu_torch.utils.import_torch import \
        waveglow_params_from_torch_state_dict
    from tacotron2_subword_tpu_torch.utils.tree import (cast_floats,
                                                        to_device,
                                                        tree_leaves)
    cpu = torch.device("cpu")
    root = Path(__file__).resolve().parent / "_runs" / "vocoders_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    report = {"gpu": gpu}
    t_phase = time.perf_counter()

    # 1. WaveGlow synthesis (the earlier phases' cached blocks released
    # first, so no timed call waits on the allocator)
    torch.cuda.empty_cache()
    cfg = WG.WaveGlowConfig()
    p_cpu = wg_seeded(WG, cfg, 0)
    p32 = to_device(p_cpu, dev)
    p16 = cast_floats(p32, torch.bfloat16)
    flops = waveglow_flops_per_sample(cfg)
    rng = np.random.RandomState(0)
    synth = {}
    for B in (1, 4):
        mel = torch.from_numpy((rng.randn(B, 80, WG_FRAMES) - 5.0).astype(
            np.float32)).to(dev)
        for name, p, m in (("f32", p32, mel),
                           ("bf16", p16, mel.to(torch.bfloat16))):
            gen = torch.Generator(device=dev).manual_seed(1)
            with torch.inference_mode():
                s = _median_s(lambda: WG.infer(p, cfg, m, sigma=0.6,
                                               generator=gen))
                y = WG.infer(p, cfg, m, sigma=0.6, generator=gen)
            n = B * WG_FRAMES * cfg.upsample_stride
            if y.shape != (B, WG_FRAMES * 256) or not torch.isfinite(
                    y.float()).all():
                raise AssertionError(f"waveglow {name} B={B}: {y.shape}")
            peak = BF16_PEAK if name == "bf16" else F32_PEAK
            synth[f"{name}_B{B}"] = {
                "ms": s * 1e3, "khz": n / s / 1e3,
                "bound_ms": n * flops / peak * 1e3,
                "bound_khz": peak / flops / 1e3}
    with torch.inference_mode():
        m1 = torch.from_numpy((rng.randn(1, 80, WG_FRAMES) - 5.0).astype(
            np.float32)).to(dev)
        gen1 = torch.Generator(device=dev).manual_seed(1)
        syncs = _sync_sites(lambda: WG.infer(p32, cfg, m1, sigma=0.6,
                                             generator=gen1))
        prof = {name: profile_call(lambda: WG.infer(
            p, cfg, m1.to(p["upsample"]["w"].dtype), sigma=0.6,
            generator=gen1)) for name, p in (("f32", p32), ("bf16", p16))}
        # f32 card vs CPU, latents injected; bf16 vs f32 on the card
        mp = torch.from_numpy((rng.randn(1, 80, WG_PARITY_FRAMES)
                               - 5.0).astype(np.float32))
        Tg = WG_PARITY_FRAMES * 256 // cfg.n_group
        noise = [torch.randn(s, generator=torch.Generator().manual_seed(2))
                 for s in WG.latent_shapes(cfg, 1, Tg)]
        y_card = WG.infer(p32, cfg, mp.to(dev), sigma=0.6, noise=noise).cpu()
        y_16 = WG.infer(p16, cfg, mp.to(dev, torch.bfloat16), sigma=0.6,
                        noise=noise).float().cpu()
        y_cpu = WG.infer(p_cpu, cfg, mp, sigma=0.6, noise=noise)
    scale = y_cpu.abs().max().item()
    err32 = (y_card - y_cpu).abs().max().item() / scale
    err16 = (y_16 - y_card).abs().max().item() / scale
    if not (err32 <= WG_F32_TOL and err16 <= WG_BF16_TOL):
        raise AssertionError(f"waveglow synthesis: f32 card vs CPU {err32}, "
                             f"bf16 vs f32 {err16} (of the max)")
    report["waveglow_synthesis"] = {
        "frames": WG_FRAMES, "sigma": 0.6, "mflop_per_sample": flops / 1e6,
        **synth, "host_syncs_per_synthesis": syncs, "profile_B1": prof,
        "f32_card_vs_cpu": err32, "bf16_vs_f32": err16}
    print("vocoders waveglow synthesis", json.dumps(
        report["waveglow_synthesis"]))
    del p16, y_card, y_16

    # 2. the reference layouts round trip
    trees = [waveglow_params_from_torch_state_dict(
        wg_reference_state_dict(p_cpu, cfg, layout), cfg, device=cpu)
        for layout in ("fused", "vendored", "old")]
    base = tree_leaves(p_cpu)
    for t in trees:
        leaves = tree_leaves(t)
        if len(leaves) != len(base) or not all(
                torch.equal(a, b) for a, b in zip(leaves, base)):
            raise AssertionError("waveglow reference layouts differ")
    report["waveglow_layouts"] = {"layouts": 3, "leaves": len(base)}
    del trees, p32

    # 3. train_waveglow on the seeded corpus, then one f32 step card vs CPU
    data = root / "data"
    write_at_corpus(data, np.random.RandomState(0))
    out = root / "waveglow"
    argv = ["-o", str(out), "--wav-dir", str(data / "wav"), "--batch-size",
            "4", "--iters-per-checkpoint", "2", "--device", str(dev)]
    loaded = []
    undo = _spy(TTW, "load_waveglow", loaded)
    try:
        torch.cuda.reset_peak_memory_stats()
        r1 = TTW.main(argv + ["--iters", str(WG_TRAIN_ITERS)])
        peak = torch.cuda.max_memory_allocated()
        ck = out / f"waveglow_{WG_TRAIN_ITERS}"
        saved = torch.load(ck, map_location="cpu", weights_only=True)
        r2 = TTW.main(argv + ["--iters", "2", "--resume", str(ck)])
    finally:
        undo()
    params, opt, it, rng_state = loaded[0][1]
    same = [torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves([params, opt._asdict()]),
        tree_leaves([saved["params"], saved["opt_state"]]))]
    if not (all(same) and len(same) == 3 * len(tree_leaves(p_cpu)) + 1
            and it == WG_TRAIN_ITERS
            and torch.equal(rng_state["keys"], saved["data_rng"]["keys"])
            and rng_state["pos"] == saved["data_rng"]["pos"]
            and r2["start_iteration"] == WG_TRAIN_ITERS
            and r2["iterations"] == WG_TRAIN_ITERS + 2
            and r1["checkpoints"] == [str(out / "waveglow_2"), str(ck)]
            and (out / f"waveglow_{WG_TRAIN_ITERS + 2}").exists()
            and np.isfinite(r1["losses"] + r2["losses"]).all()):
        raise AssertionError(f"train_waveglow: resume {sum(same)} / "
                             f"{len(same)} leaves equal, it {it}, runs "
                             f"{r1['checkpoints']} {r2['iterations']}")
    cfg_w, lr, sigma = TTW.load_config(None)
    audio = torch.from_numpy(TTW.SyntheticWavs(
        1, segment=WG_STEP_SAMPLES).sample_batch(1))
    grads = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        grads[name] = TTW.loss_and_grads(to_device(p_cpu, d), audio.to(d),
                                         cfg_w, sigma)
    lc, lh = grads["card"][0].item(), grads["cpu"][0].item()
    g_err = max(((a.cpu() - b).abs().max()
                 / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(tree_leaves(grads["card"][1]),
                                tree_leaves(grads["cpu"][1])))
    if not (abs(lc - lh) <= 1e-5 * abs(lh) and g_err <= WG_GRAD_RTOL):
        raise AssertionError(f"waveglow f32 step, card vs CPU: loss {lc} / "
                             f"{lh}, gradients {g_err} of a leaf's max")
    s_it = r1["s_per_it"][1:] + r2["s_per_it"][1:]
    report["train_waveglow"] = {
        "B": 4, "segment": TTW.SEGMENT, "iters": WG_TRAIN_ITERS + 2,
        "s_per_it": float(np.median(s_it)), "s_per_it_all": r1["s_per_it"]
        + r2["s_per_it"], "peak_gb": peak / 1e9,
        "losses": r1["losses"] + r2["losses"], "resume_leaves": len(same),
        "f32_step_card_vs_cpu": {"loss": abs(lc - lh) / abs(lh),
                                 "grads_of_leaf_max": g_err}}
    print("vocoders train_waveglow", json.dumps(report["train_waveglow"]))

    # 4. ONNX: export the CLI's g_ file, the executor on the card, one line
    a = cli_assets(str(root / "cli"), script_text="u0|ba me em nam\n")
    os.environ["T2S_RESOURCES_DIR"] = a["res"]
    onnx = str(root / "hifigan_v1.onnx")
    n_bytes = TEX.main(["--out", onnx, "--checkpoint", a["hifigan"],
                        "--config", a["config"]])
    from tacotron2_subword_tpu_torch.models.vocoder_runtimes import (
        load_onnx_vocoder, load_tflite_vocoder)
    h = HG.HifiganConfig()
    ck_g = torch.load(a["hifigan"], map_location="cpu", weights_only=True)
    native = HG.fuse_generator(HG.import_torch_generator(
        ck_g["generator"], h, device=dev))
    voc = load_onnx_vocoder(onnx, dev)
    mel = torch.from_numpy((rng.randn(1, 80, 256) - 5.0).astype(
        np.float32)).to(dev)
    with torch.inference_mode():
        t_onnx = _median_s(lambda: voc(mel))
        t_native = _median_s(lambda: HG.generator_apply(native, h, mel))
        yo = voc(mel)
        yn = HG.generator_apply(native, h, mel)[:, 0, :]
    onnx_err = ((yo - yn).abs().max() / yn.abs().max()).item()
    if yo.device != mel.device or not onnx_err <= ONNX_TOL:
        raise AssertionError(f"onnx executor vs generator_apply: {onnx_err} "
                             f"on {yo.device}")
    results = []
    synth_text, plots = TI.synthesize_text, TI.save_plots

    def spy(syn, text):
        results.append(synth_text(syn, text))
        return results[-1]
    TI.synthesize_text = spy
    if importlib.util.find_spec("matplotlib") is None:
        TI.save_plots = lambda *args: None   # as phase_cli: no plots
    args = TI.build_argparser().parse_args(
        cli_argv(a, str(root / "onnx_out"),
                 "[decode_quant:int8-gate_threshold:1.1]", CLI_STEPS,
                 str(dev), hifigan=False)
        + ["--hifigan-checkpoint", onnx])
    try:
        Q.launches = 0
        t0 = time.perf_counter()
        n_done = TI.run_inference(args)
        torch.cuda.synchronize()
        onnx_wall = time.perf_counter() - t0
        k1_onnx = Q.launches
    finally:
        TI.synthesize_text, TI.save_plots = synth_text, plots
    r = results[0]
    sr, wav = read(str(root / "onnx_out" / "audio" / "u0.wav"))
    if not (n_done == 1 and k1_onnx == 2 * r["steps_run"] == 2 * CLI_STEPS
            and sr == 22050 and wav.shape == (CLI_STEPS * 256,)
            and "denoiser" not in r["times"] and np.abs(wav).max() > 0):
        raise AssertionError(f"onnx cli line: {n_done} lines, K1 {k1_onnx} "
                             f"in {r['steps_run']} steps, {wav.shape}, "
                             f"{sorted(r['times'])}")
    report["onnx"] = {
        "file_bytes": n_bytes, "mel_frames": 256,
        "executor_ms": t_onnx * 1e3, "native_ms": t_native * 1e3,
        "executor_vs_native": onnx_err, "cli_line": {
            "steps": r["steps_run"], "k1_launches": k1_onnx,
            "wall_ms": onnx_wall * 1e3,
            **{f"{k}_ms": v * 1e3 for k, v in r["times"].items()}}}
    print("vocoders onnx", json.dumps(report["onnx"]))

    # 4b. TFLite, with tensorflow unimportable throughout: the same g_ file
    #    exported by the port's exporter at the CLI's 256-frame bucket, the
    #    executor on the card against generator_apply, one int8 CLI line
    absent = object()
    saved_tf = sys.modules.get("tensorflow", absent)
    sys.modules["tensorflow"] = None
    try:
        tfl = str(root / "hifigan_v1.tflite")
        tfl_bytes = TTX.main(["--out", tfl, "--checkpoint", a["hifigan"],
                              "--config", a["config"], "--frames", "256"])
        with open(tfl, "rb") as f:
            tfl_ops = len(TL.decode_model(f.read()).ops)
        voc_t = load_tflite_vocoder(tfl, dev)
        with torch.inference_mode():
            t_tfl = _median_s(lambda: voc_t(mel))
            t_nat = _median_s(lambda: HG.generator_apply(native, h, mel))
            yt = voc_t(mel)
            yn = HG.generator_apply(native, h, mel)[:, 0, :]
            prof_t = profile_call(lambda: voc_t(mel))
            prof_n = profile_call(lambda: HG.generator_apply(native, h, mel))
        tfl_err = ((yt - yn).abs().max() / yn.abs().max()).item()
        if yt.device != mel.device or not tfl_err <= ONNX_TOL:
            raise AssertionError(f"tflite executor vs generator_apply: "
                                 f"{tfl_err} on {yt.device}")
        try:
            voc_t(mel[:, :, :192])
            raise AssertionError("the .tflite file ran a 192-frame mel")
        except ValueError:
            pass
        results.clear()
        TI.synthesize_text = spy
        if importlib.util.find_spec("matplotlib") is None:
            TI.save_plots = lambda *args: None
        args = TI.build_argparser().parse_args(
            cli_argv(a, str(root / "tflite_out"),
                     "[decode_quant:int8-gate_threshold:1.1]", CLI_STEPS,
                     str(dev), hifigan=False)
            + ["--hifigan-checkpoint", tfl])
        try:
            Q.launches = 0
            t0 = time.perf_counter()
            n_done = TI.run_inference(args)
            torch.cuda.synchronize()
            tfl_wall = time.perf_counter() - t0
            k1_tflite = Q.launches
        finally:
            TI.synthesize_text, TI.save_plots = synth_text, plots
        r = results[0]
        sr, wav = read(str(root / "tflite_out" / "audio" / "u0.wav"))
        if not (n_done == 1
                and k1_tflite == 2 * r["steps_run"] == 2 * CLI_STEPS
                and sr == 22050 and wav.shape == (CLI_STEPS * 256,)
                and "denoiser" not in r["times"] and np.abs(wav).max() > 0):
            raise AssertionError(f"tflite cli line: {n_done} lines, K1 "
                                 f"{k1_tflite} in {r['steps_run']} steps, "
                                 f"{wav.shape}, {sorted(r['times'])}")
        if sys.modules.get("tensorflow") is not None:
            raise AssertionError("the .tflite path imported tensorflow")
    finally:
        if saved_tf is absent:
            del sys.modules["tensorflow"]
        else:
            sys.modules["tensorflow"] = saved_tf
    report["tflite"] = {
        "file_bytes": tfl_bytes, "ops": tfl_ops, "mel_frames": 256,
        "executor_ms": t_tfl * 1e3, "native_ms": t_nat * 1e3,
        "executor_launches": prof_t["kernel_launches"],
        "native_launches": prof_n["kernel_launches"],
        "executor_device_ms": prof_t["device_ms"],
        "native_device_ms": prof_n["device_ms"],
        "executor_vs_native": tfl_err, "shape_192_raises": "ValueError",
        "cli_line": {
            "steps": r["steps_run"], "k1_launches": k1_tflite,
            "wall_ms": tfl_wall * 1e3,
            **{f"{k}_ms": v * 1e3 for k, v in r["times"].items()}}}
    print("vocoders tflite", json.dumps(report["tflite"]))

    # 5. the tools
    wavs = sorted((data / "wav").glob("*.wav"))
    mel_dirs = {}
    for name, d in (("card", str(dev)), ("cpu", "cpu")):
        mel_dirs[name] = root / f"mels_{name}"
        argv = ["mels", "--wav-dir", str(data / "wav"), "--out-dir",
                str(mel_dirs[name]), "--device", d]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = TP.main(argv)
        wall = time.perf_counter() - t0
        if name == "card":
            shutil.rmtree(mel_dirs[name])
            t0 = time.perf_counter()
            n = TP.main(argv)      # a second run: the constants are built
            card_wall = time.perf_counter() - t0
            first_wall = wall
    mel_err = 0.0
    for i in range(len(wavs)):
        f = f"ljspeech-mel-{i + 1:05d}.npy"
        mc, mh = np.load(mel_dirs["card"] / f), np.load(mel_dirs["cpu"] / f)
        if mc.shape != mh.shape or mc.shape[0] != 80:
            raise AssertionError(f"preprocess mels {f}: {mc.shape}")
        mel_err = max(mel_err, float(np.abs(mc - mh).max()
                                     / np.abs(mh).max()))
    if n != len(wavs) or not mel_err <= MEL_TOL:
        raise AssertionError(f"preprocess mels: {n} files, card vs CPU "
                             f"{mel_err}")
    script = root / "transcript.txt"
    script.write_text(CLI_SCRIPT, encoding="utf-8")
    tp = root / "tools"
    counts = {
        "phones": TP.main(["phones", "--transcript", str(script),
                           "--out-dir", str(tp / "phones"), "--g2p-lexicon",
                           a["lexicon"]]),
        "subwords": TP.main(["subwords", "--transcript", str(script),
                             "--sub-dir", str(tp / "sub"), "--cls-dir",
                             str(tp / "cls"), "--vocab", "500"]),
        "lists": TP.main(["lists", "--wav-dir", str(tp / "wav"), "--dur-dir",
                          str(tp / "phones"), "--train-out",
                          str(tp / "train.txt"), "--val-out",
                          str(tp / "val.txt"), "--val-fraction", "0.25"])}
    (tp / "wav").mkdir()
    for i in range(4):
        shutil.copy(wavs[i], tp / "wav" / f"{i}.wav")
    counts["check_missing"] = TP.main(["check", str(tp / "train.txt")])
    sub = np.load(tp / "sub" / "1.npy")
    counts["phone_ids_u1"] = int(len(np.load(tp / "phones" / "1.npy")))
    lex = a["lexicon"]
    counts["phone_id_map"] = TDP.main(["--vi-lex", lex, "--en-lex", lex,
                                       "--foreign-lex", lex, "--out",
                                       str(tp / "phone_id_list.txt")])
    rep = TCB.main(["--text", "anh banh an me ba em nam",
                    "--fallback-vocabs", "5500", "6000", "7500"])
    if not (counts["phones"] == counts["subwords"] == counts["lists"] == 4
            and counts["check_missing"] == 0 and sub.dtype == np.int32
            and ((sub >= 3) & (sub < 500)).all()
            and counts["phone_id_map"] > 7 and len(rep["pairs"]) == 3):
        raise AssertionError(f"tools: {counts}, {rep['pairs']}")

    sent_s = []
    real_sentence = TD.synthesize_sentence

    def timed_sentence(syn, sent):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_sentence(syn, sent)
        sent_s.append(time.perf_counter() - t)
        return out
    (root / "news.txt").write_text(DEMO_SENTENCES, encoding="utf-8")
    TD.synthesize_sentence = timed_sentence
    try:
        Q.launches = 0
        t0 = time.perf_counter()
        demo_wav = TD.main([
            "--text-file", str(root / "news.txt"), "--out",
            str(root / "news.wav"), "--checkpoint-dir", a["ckpt_dir"],
            "--g2p-lexicon", lex, "--hifigan-checkpoint", a["hifigan"],
            "--hifigan-config", a["config"], "--max-decoder-steps",
            str(CLI_STEPS), "--hparams",
            "[decode_quant:int8-gate_threshold:1.1]", "--device", str(dev)])
        demo_wall = time.perf_counter() - t0
        k1_demo = Q.launches
    finally:
        TD.synthesize_sentence = real_sentence
    sr, news = read(str(root / "news.wav"))
    pause = int(TD.PAUSE_S * TD.SAMPLING_RATE)
    if not (len(sent_s) == 3 and k1_demo == 2 * 3 * CLI_STEPS
            and news.shape == (3 * (CLI_STEPS * 256 + pause),)
            and len(demo_wav) == len(news) and np.abs(news).max() > 0):
        raise AssertionError(f"demo: {len(sent_s)} sentences, K1 {k1_demo}, "
                             f"{news.shape}")
    report["tools"] = {
        "preprocess_mels": {"wavs": len(wavs),
                            "ms_per_wav": card_wall * 1e3 / len(wavs),
                            "ms_per_wav_first_run": first_wall * 1e3
                            / len(wavs),
                            "card_vs_cpu": mel_err},
        **counts, "check_bert_emb_pairs": rep["pairs"],
        "demo": {"sentences": 3, "steps": CLI_STEPS, "k1_launches": k1_demo,
                 "wall_s": demo_wall,
                 "sentence_ms": [s * 1e3 for s in sent_s]}}
    print("vocoders tools", json.dumps(report["tools"]))
    shutil.rmtree(root, ignore_errors=True)
    print(f"vocoders and tools: {time.perf_counter() - t_phase:.1f} s")
    return {"k1_onnx": k1_onnx, "k1_tflite": k1_tflite, "k1_demo": k1_demo}


MR_HPARAMS = "[softdtw_loss_weight:1.0-parity_mode:true]"
MR_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
MR_TIMEOUT_S = 420   # the CLI runs and the groups, all at once
MR_LOSS_RE = r"iter (\d+): loss ([\d.eE+-]+) grad_norm \S+ ([\d.]+)s/it"


def _stored_bytes(state):
    """Bytes of the params and Adam moments a rank stores."""
    from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        (state.params, state.opt_state.mu, state.opt_state.nu)))


def _grad_errors(grads, ref):
    """Per leaf, max|d| over max|g_ref| of the leaf, that max floored at
    1e-3 of the tree's (a conv bias that feeds a training-mode BatchNorm has
    a true gradient of 0: rounding noise on both sides)."""
    from tacotron2_subword_tpu_torch.utils.tree import tree_leaves
    refs = tree_leaves(ref)
    floor = 1e-3 * max(r.abs().max().item() for r in refs)
    return [(a - r).abs().max().item() / max(r.abs().max().item(), floor)
            for a, r in zip(tree_leaves(grads), refs)]


def multi_rank_worker(rank, world, store, out_dir, dev_name, cfg_fields):
    """One rank of a gloo group on ``dev_name`` (several ranks share the
    card): for each mesh of MR_MESHES[world], on the global batch
    (train_batch, B=8, T_out=128; its last row a repeat with weight 0):
    loss_and_grads, loss_and_grads with the soft-DTW weight 0, train_step
    and eval_step, K2 / K3 counted.  Rank 0 first runs the same calls in
    one process (no mesh) with the same seeds and holds each mesh to them:
    every loss and eval loss 1e-5 relative, BN statistics 1e-5, the
    gradients without the soft-DTW term 1e-4 of each leaf's max.  With the
    soft-DTW term the single-process gradients themselves move by ~1e-3
    of a leaf's max when the last BatchNorm's params move by 1e-7
    (``sensitivity``, measured here): the soft-DTW gradient at T_out=128 on
    random weights is that ill-conditioned, so those gradients and the
    grad_norm are held to 5e-3 (``phase_train_parity``'s bound for the
    same term).  The full state stays on the host: the card holds a rank's
    stored slices and its step only, so the per-rank peak memory is the
    mesh's.  Writes its rows to out_dir/rank{rank}.json."""
    import os
    from datetime import timedelta
    import torch.distributed as dist
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.ops import softdtw as SD
    from tacotron2_subword_tpu_torch.parallel import mesh as PM
    from tacotron2_subword_tpu_torch.utils.tree import (to_device, tree_leaves,
                                                        tree_map)
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    peak = ((lambda: torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else (lambda: 0))
    reset = ((lambda: torch.cuda.reset_peak_memory_stats(dev))
             if dev.type == "cuda" else (lambda: None))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        cfg = TacotronConfig(**cfg_fields)
        cfg0 = cfg.replace(softdtw_loss_weight=0.0)
        state, tx = TT.create_train_state(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
        batch = train_batch(cfg, dev, TRAIN_B, TRAIN_T_OUT)
        batch["weight"] = torch.ones(TRAIN_B, device=dev)
        batch["weight"][-1] = 0.0
        gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

        def run(mesh, plan, sharded, local):
            kw = dict(mesh=mesh, plan=plan)
            losses, grads, bn = TT.loss_and_grads(
                sharded, local, cfg, generator=gen(4), **kw)
            grads0 = TT.loss_and_grads(sharded, local, cfg0,
                                       generator=gen(4), **kw)[1]
            _, m = TT.train_step(sharded, local, cfg, tx, generator=gen(5),
                                 **kw)
            ev, _ = TT.eval_step(sharded, local, cfg, generator=gen(6), **kw)
            return {"losses": losses, "grads": grads, "grads0": grads0,
                    "bn": bn, "metrics": m, "eval": ev}

        cpu = lambda tree: to_device(tree, "cpu")
        ref = None
        if rank == 0:
            full = to_device(state, dev)
            sync()
            reset()
            t0 = time.perf_counter()
            ref = run(None, None, full, batch)
            sync()
            ref["wall_s"] = time.perf_counter() - t0
            ref["peak_mem_bytes"] = peak()
            ref["stored_bytes"] = _stored_bytes(full)
            post = [dict(l) for l in full.params["postnet"]]
            post[-1] = {**post[-1], "bn": tree_map(
                lambda t: t * (1 + 1e-7), post[-1]["bn"])}
            moved = TT.loss_and_grads(
                full._replace(params={**full.params, "postnet": post}),
                batch, cfg, generator=gen(4))[1]
            ref["sensitivity"] = max(_grad_errors(moved, ref["grads"]))
            ref = cpu(ref)
            del full, moved
        rows = []
        for n_data, n_model in MR_MESHES[world]:
            mesh = PM.make_mesh(n_data, n_model, group=dist.group.WORLD)
            plan = PM.tacotron_param_sharding(state.params, mesh)
            sharded = to_device(PM.shard_train_state(state, mesh), dev)
            local = PM.shard_batch(batch, mesh)
            PM.collective_barrier(mesh)
            sync()
            reset()
            SD.grad_launches = SD.fwd_launches = 0
            t0 = time.perf_counter()
            out = run(mesh, plan, sharded, local)
            sync()
            wall = time.perf_counter() - t0
            k2, k3 = SD.grad_launches, SD.fwd_launches
            row = {"mesh": [n_data, n_model], "rank": rank,
                   "coords": [mesh.data, mesh.model], "wall_s": wall,
                   "k2_launches": k2, "k3_launches": k3,
                   "peak_mem_bytes": peak(),
                   "stored_bytes": _stored_bytes(sharded),
                   "loss": out["losses"]["total"].item(),
                   "eval_total": out["eval"]["total"].item()}
            # (the CPU runs the plain versions: no launch to count)
            if dev.type == "cuda" and (k2 != 2 or k3 != 1):
                raise AssertionError(f"rank {rank} {row['mesh']}: K2 {k2} "
                                     f"(want 2), K3 {k3} (want 1)")
            if ref is not None:
                out = cpu(out)
                rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
                row["loss_rel_err"] = max(
                    rel(out[key][k].item(), ref[key][k].item())
                    for key in ("losses", "eval") for k in ref[key])
                row["train_total_rel_err"] = rel(
                    out["metrics"]["total"].item(),
                    ref["metrics"]["total"].item())
                row["grad_norm_rel_err"] = rel(
                    out["metrics"]["grad_norm"].item(),
                    ref["metrics"]["grad_norm"].item())
                row["grad_err_no_softdtw"] = max(
                    _grad_errors(out["grads0"], ref["grads0"]))
                row["grad_err"] = max(_grad_errors(out["grads"],
                                                   ref["grads"]))
                row["bn_err_max"] = max(
                    (a - b).abs().max().item()
                    / max(b.abs().max().item(), 1.0)
                    for a, b in zip(tree_leaves(out["bn"]),
                                    tree_leaves(ref["bn"])))
                if not (row["loss_rel_err"] <= 1e-5
                        and row["train_total_rel_err"] <= 1e-5
                        and row["grad_err_no_softdtw"] <= 1e-4
                        and row["grad_err"] <= 5e-3
                        and row["grad_norm_rel_err"] <= 5e-3
                        and row["bn_err_max"] <= 1e-5):
                    raise AssertionError(f"multi-rank {row['mesh']} against "
                                         f"the single-process step: {row}")
                row["single_process"] = {k: ref[k] for k in (
                    "wall_s", "peak_mem_bytes", "stored_bytes",
                    "sensitivity")}
            rows.append(row)
            del sharded, out
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
        PM.collective_barrier(PM.make_mesh(group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world, out_dir, dev_name, cfg_fields):
    """Starts multi_rank_worker on ``world`` ranks (spawned, a file store
    in out_dir); ``_join_ranks`` waits for them."""
    import os
    import torch.multiprocessing as mp
    store = os.path.join(out_dir, f"store{world}")
    return mp.start_processes(multi_rank_worker,
                              args=(world, store, out_dir, dev_name,
                                    cfg_fields), nprocs=world, join=False,
                              start_method="spawn")


def _join_ranks(ctx, world, out_dir, deadline):
    """The rows of ``_spawn_ranks``' ranks; a rank that raises or exits
    non-zero, or a run past ``deadline`` (time.monotonic), raises here
    (the ranks are killed)."""
    import os
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past the deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    rows = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rows += json.load(f)
    return rows


# the training CLI's entry point with cuDNN's and torch's deterministic
# algorithms on: run to run, the default ones move the third iteration's
# loss by a few 1e-6 relative, which would hide what the NCCL path changes
DETERMINISTIC_TRAIN = (
    "import sys, torch; torch.backends.cudnn.deterministic = True; "
    "torch.backends.cudnn.benchmark = False; "
    "torch.use_deterministic_algorithms(True, warn_only=True); "
    "from tacotron2_subword_tpu_torch.apps import train; "
    "train.main(sys.argv[1:])")


def _train_cli_start(argv, env, multihost, log, deterministic=True):
    """Starts the training CLI (``apps.train.main``) as a subprocess, under
    torch.distributed.run with one rank and --multihost when
    ``multihost``, its standard output to the file ``log`` and its errors
    to ``log``.err; ``_train_cli_end`` waits for it."""
    entry = (["-c", DETERMINISTIC_TRAIN] if deterministic
             else ["-m", "tacotron2_subword_tpu_torch.apps.train"])
    cmd = [sys.executable, *entry, *argv]
    if multihost:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node=1", "--no-python", *cmd, "--multihost"]
    with open(log, "w") as out, open(f"{log}.err", "w") as err:
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                                text=True)
    return proc, time.perf_counter(), log


def _train_cli_end(run, deadline):
    """(losses, s/it per iteration, process wall s) of a
    ``_train_cli_start`` run; a non-zero exit, or a run past ``deadline``
    (time.monotonic), raises (the process is killed)."""
    import re
    proc, t0, log = run
    try:
        code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    with open(log) as f, open(f"{log}.err") as e:
        text, err = f.read(), e.read()
    if code != 0:
        raise AssertionError(f"train CLI {log} exited {code}: "
                             f"{text[-2000:]} {err[-3000:]}")
    found = re.findall(MR_LOSS_RE, text)
    return ([float(l) for _, l, _ in found], [float(s) for _, _, s in found],
            wall)


def _mr_cli(root, hparams=MR_HPARAMS, device_args=()):
    """(environment, argv(out dir name)) of phase_multi_rank's CLI runs:
    --synthetic 32, 3 iterations at batch 8, f32 with TF32 off."""
    import os
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    argv = lambda out: ["-o", str(root / out), "--synthetic", "32",
                        "--max-iters", "3", "--batch-size", str(TRAIN_B),
                        "--prefetch", "0", "--hparams", hparams,
                        *device_args]
    return env, argv


def cli_nondeterminism(gpu):
    """``--cli-nondeterminism``: phase_multi_rank's plain CLI run twice
    with PyTorch's default (nondeterministic) algorithms: how far its
    losses move run to run."""
    import shutil
    from pathlib import Path
    root = Path(__file__).resolve().parent / "_runs" / "cli_nondeterminism"
    shutil.rmtree(root, ignore_errors=True)
    env, argv = _mr_cli(root)
    root.mkdir(parents=True)
    deadline = time.monotonic() + MR_TIMEOUT_S
    runs = [_train_cli_end(_train_cli_start(
        argv(f"run{i}"), env, False, str(root / f"run{i}.log"),
        deterministic=False), deadline) for i in range(2)]
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[0][0], runs[1][0])]
    print("train CLI, default algorithms, run to run:", json.dumps({
        "losses": [r[0] for r in runs], "rel_diff_per_iteration": rel,
        "gpu": gpu}))
    shutil.rmtree(root, ignore_errors=True)


def phase_multi_rank(dev, gpu, cfg_fields=None, hparams=MR_HPARAMS,
                     device_args=()):
    """Multi-rank training (``parallel/mesh.py``) at full width, f32, TF32
    off, soft-DTW weight 1.0.  (a) The training CLI under
    torch.distributed.run with one NCCL rank (--multihost) against the same
    command without it, both with deterministic algorithms
    (``DETERMINISTIC_TRAIN``): 3 iterations of --synthetic 32 at batch 8,
    the losses to 1e-6 relative.  (b) Ranks that share the card over one gloo
    group (spawned here, the group passed to make_mesh): meshes (2, 1) and
    (1, 2) on 2 ranks, (2, 2) on 4, each one train step (loss_and_grads
    and train_step) and one eval step of the global batch B=8, T_out=128,
    held to the single-process step (``multi_rank_worker``); K2 and K3
    counted on every rank.  The two CLI runs and the two groups run at
    once, within MR_TIMEOUT_S: their s/it and walls are read under each
    other's load.
    Returns {k2, k3: the launches summed over every rank and mesh,
    k2_per_rank, k3_per_rank: by mesh}."""
    import os
    import shutil
    from pathlib import Path
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    root = Path(__file__).resolve().parent / "_runs" / "multi_rank"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env, argv = _mr_cli(root, hparams, device_args)
    # the phone vocabulary padded to 314 rows so that the model axis can
    # split it (313 is odd; JAX's mesh tests pad theirs the same way)
    fields = cfg_fields or dataclasses.asdict(TacotronConfig(
        softdtw_loss_weight=1.0, parity_mode=True, n_symbols=314))
    deadline = time.monotonic() + MR_TIMEOUT_S
    clis, groups = [], []
    try:
        for name, multihost in (("plain", False), ("nccl", True)):
            clis.append(_train_cli_start(argv(name), env, multihost,
                                         str(root / f"{name}.log")))
        for world in (2, 4):
            out = root / f"world{world}"
            out.mkdir()
            groups.append((_spawn_ranks(world, str(out), str(dev), fields),
                           world, str(out)))
        (plain, plain_s, plain_wall), (multi, multi_s, multi_wall) = (
            _train_cli_end(run, deadline) for run in clis)
        rows = [row for ctx, world, out in groups
                for row in _join_ranks(ctx, world, out, deadline)]
    finally:
        for proc, _, _ in clis:
            if proc.poll() is None:
                proc.kill()
        for ctx, _, _ in groups:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    if len(plain) != 3 or len(multi) != 3:
        raise AssertionError(f"train CLI: {plain} / {multi} losses")
    rel = max(abs(a - b) / abs(b) for a, b in zip(multi, plain))
    if rel > 1e-6:
        raise AssertionError(f"one NCCL rank {multi} against the plain CLI "
                             f"{plain}: {rel} relative")
    cli = {"losses_plain": plain, "losses_nccl_1_rank": multi,
           "max_rel_err": rel,
           "s_per_it_plain": plain_s, "s_per_it_nccl_1_rank": multi_s,
           "s_per_step_plain_iters_2_3": sum(plain_s[1:]) / 2,
           "s_per_step_nccl_iters_2_3": sum(multi_s[1:]) / 2,
           "process_wall_s": [plain_wall, multi_wall],
           "concurrent": True, "gpu": gpu}
    print("multi-rank (a) train CLI, one NCCL rank vs plain:",
          json.dumps(cli))
    for row in rows:
        print("multi-rank (b)", json.dumps({**row, "gpu": gpu}))
    single = next(r["single_process"] for r in rows if "single_process" in r)
    at = lambda mesh: [r for r in rows if r["mesh"] == list(mesh)]
    summary = {
        "k2_launches_per_rank": {str(m): [r["k2_launches"] for r in at(m)]
                                 for w in MR_MESHES.values() for m in w},
        "k3_launches_per_rank": {str(m): [r["k3_launches"] for r in at(m)]
                                 for w in MR_MESHES.values() for m in w},
        "stored_bytes_1x1": single["stored_bytes"],
        "stored_bytes_1x2_per_rank": [r["stored_bytes"] for r in at((1, 2))],
        "peak_mem_bytes_1x1": single["peak_mem_bytes"],
        "peak_mem_bytes_1x2_per_rank": [r["peak_mem_bytes"]
                                        for r in at((1, 2))],
        "peak_mem_bytes_2x2_per_rank": [r["peak_mem_bytes"]
                                        for r in at((2, 2))],
        "wall_s_1x1": single["wall_s"],
        "wall_s_per_mesh": {str(m): max(r["wall_s"] for r in at(m))
                            for w in MR_MESHES.values() for m in w},
        "worst_vs_single": {k: max(r[k] for r in rows if k in r) for k in (
            "loss_rel_err", "train_total_rel_err", "grad_norm_rel_err",
            "grad_err_no_softdtw", "grad_err", "bn_err_max")},
        "single_process_sensitivity": single["sensitivity"],
        "gpu": gpu}
    print("multi-rank summary", json.dumps(summary))
    shutil.rmtree(root, ignore_errors=True)
    return {"k2": sum(r["k2_launches"] for r in rows),
            "k3": sum(r["k3_launches"] for r in rows),
            "k2_per_rank": summary["k2_launches_per_rank"],
            "k3_per_rank": summary["k3_launches_per_rank"]}


SYN_TRAIN, SYN_VAL, SYN_SEED = 64, 16, 0   # utterances of the corpus
SYN_ITERS = 6          # training CLI iterations at B=8, bf16, soft-DTW 1.0
SYN_HPARAMS = "softdtw_loss_weight:1.0-iters_per_checkpoint:3"
SYN_STEPS, SYN_GATES = 256, "0.5,0.25"     # the int8 sweep
SYN_MEL_TOL = 2e-3     # the corpus's numpy mel vs ops/stft on the card
# the f32 row, card vs CPU with the same prenet masks, as phase_whole_path
# (B=2, 50 steps, gate never firing): mel_postnet max|d| <= 1e-3 *
# max|ref|, the row's softdtw and mcd within 1e-3 relative, equal frames
# and gate_ok
SYN_PARITY_N, SYN_PARITY_STEPS, SYN_PARITY_TOL = 2, 50, 1e-3
SYN_GAN_BATCHES, SYN_GAN_ITERS = (4, 16, 32), 5
# gan_batch_scaling's B=16 step against phase_after_training's B=16 step
# (the same step and shapes; a chained run against synced calls, another
# state): within 25 %
SYN_GAN_VS_AFTER = 0.25


def fixed_prenet_masks(TM, masks):
    """Every decode (each makes its own generator) takes ``masks`` from its
    first step on, on the decode's device; returns the undo."""
    streams, keep = {}, []
    real = TM._prenet_masks

    def fixed(generator, n, shape, dtype, device):
        if id(generator) not in streams:
            keep.append(generator)
            streams[id(generator)] = iter(masks)
        return next(streams[id(generator)]).to(device=device, dtype=dtype)
    TM._prenet_masks = fixed
    return lambda: setattr(TM, "_prenet_masks", real)


def phase_synthetic_tools(Q, SD, dev, gpu, gan_step_s):
    """The synthetic-corpus tools of the port at full width (the default
    TacotronConfig, HiFi-GAN v1):
     (a) make_synthetic_dataset, 64 + 16 utterances: ms per utterance;
         each val utterance's float waveform, made again from the tool's
         random stream, is the written int16 wav to the bit, and its
         corpus mel (numpy, float64) agrees with ops/stft.mel_spectrogram
         on the card within SYN_MEL_TOL (the int16 wav's distance is
         reported beside it);
     (b) the training CLI on that corpus, bf16, soft-DTW 1.0, B=8, 6
         iterations with validation and a checkpoint every 3: K2 == 6,
         K3 == 2 x the validation batches, s/it after the first;
     (c) eval_synthetic --sweep-dir over checkpoint_3 and checkpoint_6,
         int8, 16 utterances, 256 steps, gates 0.5 and 0.25: K1 == 2 x the
         decode steps, one CSV row per (checkpoint, gate); run again, every
         row is skipped and nothing is decoded; one f32 row on the card
         against the tool with --cpu, the CPU given the card's prenet
         masks (SYN_PARITY_*);
     (d) gan_batch_scaling at B = 4, 16, 32: ms/it, segments/s, audio-s/s
         and peak memory per B, B=16 held to ``gan_step_s`` (the step time
         of phase_after_training).
    train_tokenizer and tools/orbax_to_torch.py need tokenizers and JAX:
    host-only, tested on the CPU.  Returns {k1, k2, k3: launches,
    report, root: the ``_runs/synthetic`` directory, kept for
    phase_measurement; the caller removes it}."""
    import contextlib
    import csv
    import io
    import shutil
    from pathlib import Path
    from scipy.io.wavfile import read as wavread
    from tacotron2_subword_tpu_torch.apps import train as TAPP
    from tacotron2_subword_tpu_torch.config import create_config
    from tacotron2_subword_tpu_torch.data import dataset as TD
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.ops import stft as S
    from tacotron2_subword_tpu_torch.tools import eval_synthetic as TES
    from tacotron2_subword_tpu_torch.tools import gan_batch_scaling as TGB
    from tacotron2_subword_tpu_torch.tools import make_synthetic_dataset as MS
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "_runs" / "synthetic"
    shutil.rmtree(root, ignore_errors=True)
    data, run = root / "data", root / "run"
    report = {"gpu": gpu}

    # (a) the corpus
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        MS.main(["--out", str(data), "--n-train", str(SYN_TRAIN),
                 "--n-val", str(SYN_VAL), "--seed", str(SYN_SEED)])
    corpus_s = time.perf_counter() - t0
    mel_err, int16_err, frames = [], [], []
    for i in range(SYN_VAL):
        rng = np.random.RandomState(SYN_SEED * 999983 + SYN_TRAIN + i)
        _, _, _, _, mel, wav = MS.make_utterance(rng)
        _, w16 = wavread(str(data / "val" / "wav" / f"{i}.wav"))
        stored = np.load(data / "val" / "mels" / f"ljspeech-mel-{i+1:05d}.npy")
        if not (np.array_equal(w16, np.clip(wav * 32768.0, -32768, 32767
                                            ).astype(np.int16))
                and np.array_equal(stored, mel)):
            raise AssertionError(f"synthetic corpus: val {i} is not the "
                                 f"tool's stream")
        n = mel.shape[1]
        on_card = lambda w: S.mel_spectrogram(torch.from_numpy(
            np.ascontiguousarray(w, np.float32))[None].to(dev))[0, :, :n]
        mel_err.append(float(np.abs(on_card(wav).cpu().numpy() - mel).max()))
        int16_err.append(float(np.abs(on_card(w16 / 32768.0).cpu().numpy()
                                      - mel).max()))
        frames.append(n)
    if max(mel_err) > SYN_MEL_TOL:
        raise AssertionError(f"synthetic corpus: numpy mel vs the card "
                             f"{max(mel_err)} > {SYN_MEL_TOL}")
    report["corpus"] = {
        "utterances": SYN_TRAIN + SYN_VAL, "wall_s": corpus_s,
        "ms_per_utterance": 1e3 * corpus_s / (SYN_TRAIN + SYN_VAL),
        "val_frames": frames, "mel_vs_card_max_abs": max(mel_err),
        "int16_wav_mel_vs_card_max_abs": max(int16_err)}
    print("synthetic (a) corpus", json.dumps(report["corpus"]))

    # (b) the training CLI on it
    hp = f"[{SYN_HPARAMS}]"
    cfg = create_config(hp)
    val_batches = len(list(TD.BucketedLoader(
        TD.BertTacotron2Dataset(TD.load_filepaths(str(data / "val.txt")),
                                *(str(data / "val" / d) for d in
                                  ("mels", "sub", "cls"))),
        batch_size=8, frames_per_step=cfg.n_frames_per_step)))
    tr, va = data / "train", data / "val"
    argv = ["-o", str(run), "--train-list", str(data / "train.txt"),
            "--val-list", str(data / "val.txt"), "--mel-dir",
            str(tr / "mels"), "--sub-dir", str(tr / "sub"), "--cls-dir",
            str(tr / "cls"), "--val-mel-dir", str(va / "mels"),
            "--val-sub-dir", str(va / "sub"), "--val-cls-dir",
            str(va / "cls"), "--batch-size", "8", "--max-iters",
            str(SYN_ITERS), "--hparams", hp]
    SD.grad_launches = SD.fwd_launches = 0
    t0 = time.perf_counter()
    res, _ = _run_cli(TAPP, argv)
    train_wall = time.perf_counter() - t0
    k2, k3 = SD.grad_launches, SD.fwd_launches
    ckpts = [run / f"checkpoint_{n}" for n in (3, 6)]
    if not (res["iterations"] == SYN_ITERS
            and np.isfinite(res["losses"]).all()
            and np.isfinite(res["val_loss"])
            and all((c / "state.pt").is_file() for c in ckpts)):
        raise AssertionError(f"synthetic train: {res}")
    if k2 != SYN_ITERS or k3 != 2 * val_batches:
        raise AssertionError(f"synthetic train: K2 {k2} in {SYN_ITERS} "
                             f"steps, K3 {k3} in 2 x {val_batches} "
                             f"validation batches")
    report["train"] = {
        "iterations": SYN_ITERS, "losses": res["losses"],
        "val_loss": res["val_loss"], "iter_s": res["iter_s"],
        "s_per_it_after_first": float(np.mean(res["iter_s"][1:])),
        "wall_s": train_wall, "val_batches": val_batches,
        "k2_launches": k2, "k3_launches": k3}
    print("synthetic (b) train", json.dumps(report["train"]))

    # (c) the int8 sweep over both checkpoints, then again (all skipped)
    csv_path = root / "sweep.csv"
    sweep = ["--data", str(data), "--sweep-dir", str(run), "--hparams",
             "[decode_quant:int8]", "--n", str(SYN_VAL),
             "--max-steps", str(SYN_STEPS), "--gate-thresholds", SYN_GATES,
             "--out-csv", str(csv_path)]
    Q.launches = 0
    t0 = time.perf_counter()
    res_c = TES.main(sweep)
    sweep_wall = time.perf_counter() - t0
    k1 = Q.launches
    steps = [d["steps_run"] for d in res_c["decodes"]]
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    gates = [float(g) for g in SYN_GATES.split(",")]
    want = [(c.name, g) for c in ckpts for g in gates]
    if [(r["checkpoint"], float(r["gate"])) for r in rows] != want \
            or len(steps) != len(want) or k1 != 2 * sum(steps) \
            or not all(np.isfinite(float(r[k])) for r in rows
                       for k in ("softdtw", "mcd")):
        raise AssertionError(f"synthetic sweep: rows {rows}, K1 {k1} in "
                             f"{steps} steps")
    Q.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = TES.main(sweep)
    with open(csv_path, newline="") as f:
        rows_again = list(csv.DictReader(f))
    if again["decodes"] or Q.launches or rows_again != rows \
            or buf.getvalue().count("already in ledger") != len(ckpts):
        raise AssertionError(f"synthetic sweep resume: {again['decodes']}, "
                             f"K1 {Q.launches}, {buf.getvalue()}")

    # one f32 row (checkpoint_6) on the card and on the CPU, the same masks
    f32 = ["--data", str(data), "--checkpoint", str(ckpts[1]), "--hparams",
           "[parity_mode:true]", "--n", str(SYN_PARITY_N),
           "--max-steps", str(SYN_PARITY_STEPS), "--gate-thresholds", "1.1"]
    # the card's decode draws its own masks (as CUDA graph replays, which
    # hold no mask from the host); the CPU's decode is given the same draws
    gen = torch.Generator(device=dev).manual_seed(TES.MASK_SEED)
    masks = [TM._prenet_masks(gen, 4, (SYN_PARITY_N, cfg.prenet_dim),
                              torch.float32, dev).cpu()
             for _ in range(SYN_PARITY_STEPS)]
    parity = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        extra = ["--cpu"] if d.type == "cpu" else []
        undo = fixed_prenet_masks(TM, masks) if extra else (lambda: None)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                r = TES.main(f32 + ["--out-csv", str(root / f"{name}.csv")]
                             + extra)
        finally:
            undo()
        parity[name] = (r["rows"], r["mel_postnet"])
    (rc, mc), (rp, mp) = parity["card"], parity["cpu"]
    mel_d = float(np.abs(mc - mp).max())
    mel_tol = SYN_PARITY_TOL * float(np.abs(mp).max())
    rel = lambda k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(rc, rp))
    row_err = {k: rel(k) for k in ("softdtw", "mcd")}
    if not (mel_d <= mel_tol and all(v <= SYN_PARITY_TOL
                                     for v in row_err.values())
            and [(a["frames_pred"], a["gate_ok"]) for a in rc]
            == [(b["frames_pred"], b["gate_ok"]) for b in rp]):
        raise AssertionError(f"synthetic f32 row card vs CPU: mel {mel_d} > "
                             f"{mel_tol} or rows {row_err}: {rc} / {rp}")
    report["sweep"] = {
        "rows": rows, "decodes": res_c["decodes"], "k1_launches": k1,
        "wall_s": sweep_wall, "f32_row_card_vs_cpu": {
            "mel_postnet_max_abs": mel_d, "mel_postnet_tol": mel_tol,
            **{f"{k}_rel": v for k, v in row_err.items()}}}
    print("synthetic (c) sweep", json.dumps(report["sweep"]))

    # (d) GAN step against the batch size
    rows_d = TGB.measure(SYN_GAN_BATCHES, SYN_GAN_ITERS, warmup=2, device=dev)
    r16 = next(r for r in rows_d if r["B"] == 16)
    if not all(np.isfinite(r["loss"]) for r in rows_d) or abs(
            r16["s_per_it"] / gan_step_s - 1) > SYN_GAN_VS_AFTER:
        raise AssertionError(f"gan_batch_scaling: {rows_d} against the "
                             f"after-training step {gan_step_s} s")
    report["gan_batch_scaling"] = {
        "rows": [{**r, "ms_per_it": r["s_per_it"] * 1e3} for r in rows_d],
        "after_training_b16_step_s": gan_step_s}
    print("synthetic (d) gan_batch_scaling",
          json.dumps(report["gan_batch_scaling"]))
    print("synthetic: train_tokenizer (needs tokenizers) and "
          "tools/orbax_to_torch.py (needs JAX, orbax) are host-only; they "
          "are tested on the CPU (tests/test_torch_synthetic_tools.py, "
          "tests/test_torch_orbax_eval.py), not run here")
    report["phase_s"] = time.perf_counter() - t_phase
    print("synthetic phase", json.dumps({"phase_s": report["phase_s"],
                                          "gpu": gpu}))
    return {"k1": k1, "k2": k2, "k3": k3, "report": report, "root": root}


MEAS_TSP_STEPS = 3         # train_step_profile --softdtw --steps
MEAS_SERVE_REPEATS = 1     # serving_latency --repeats (11 acoustic calls)
MEAS_EVIDENCE_REPEATS = 1  # kernel_evidence --repeats
MEAS_WALL_WINDOWS = 1      # the bench's untraced infer windows (--bench: 3)
MEAS_GTA_ITERS = 20        # gta_vocoder_smoke --iters
MEAS_GTA_N = 8             # gta_vocoder_smoke --n (2 held out)
# train_step_profile --infer (B=128, 200 steps, int8) launches per step,
# the slope of its 200- and 16-step decodes, against the slope of
# phase_profile's B=128 decode loop at 32 and 64 steps: the decodes sync
# on the host every 16 steps, 11 times in 184 steps against 2 in 32, and
# differ by no more (0.01 % of ~81 launches)
MEAS_LAUNCH_RTOL = 0.005
# busy and span share the profiler's clock (the card's timestamps as it
# converts them), the wall is the host's: in the host-bound decode the
# true span lies within about a millisecond of the wall, and span / wall
# read 0.9951-0.9998 in nine bench windows of 2.2-3.4 s on the H100, and
# 1.0008 and 1.0023 in two since every trace starts with
# xprof.LEAD_KERNELS, so span may pass the wall by 1 %
MEAS_CLOCK_RTOL = 0.01


def bench_py_keys(path):
    """(top-level keys, extra keys) of the JSON line the root bench.py
    prints, read from its source (it is not imported)."""
    import ast
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = {k.value for k in d.keys}
            if "extra" in keys:
                extra = d.values[[k.value for k in d.keys].index("extra")]
                return keys, {k.value for k in extra.keys}
    raise AssertionError(f"{path}: no bench line found")


MEAS_TRACE_REPS = 20   # launches of K1, K2, K3 in graph_kernel_names


def graph_kernel_names(Q, SD, dev):
    """K1, K2 and K3 launched MEAS_TRACE_REPS times each under
    ``utils.xprof.device_profile``, eagerly and as CUDA-graph replays (the
    graph captured before the profiler started, and while it runs):
    {"eager" / "graph_before" / "graph_during": {kernel name: count}} as
    the trace records them (``utils.xprof.parse_profile_ops``)."""
    from tacotron2_subword_tpu_torch.utils import xprof
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 1792, generator=g).to(dev, torch.bfloat16)
    w_q, scale = Q.quantize_int8(torch.randn(2, 1792, 4096, generator=g)
                                 .to(dev), axis=1)
    D = torch.rand(TRAIN_B, TRAIN_T_OUT, TRAIN_T_OUT, generator=g).to(dev)
    run = lambda: (Q.matmul_dequant_int8(x, w_q, scale),
                   SD.softdtw_grad(D, 1.0, 0.0), SD.softdtw_value(D, 1.0, 0.0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)

    def capture():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        return graph
    before = capture()
    before.replay()
    torch.cuda.synchronize()
    out = {}
    for when in ("eager", "graph_before", "graph_during"):
        with xprof.device_profile() as prof:
            step = {"eager": run, "graph_before": before.replay}.get(when)
            step = step or capture().replay
            for _ in range(MEAS_TRACE_REPS):
                step()
            torch.cuda.synchronize()
        out[when] = {name: n for name, _, n in
                     xprof.parse_profile_ops(prof)[0]}
    return out


def phase_measurement(Q, SD, dev, gpu, profile_rows, synthetic):
    """The measurement layer of the port at full width
    (``tacotron2_subword_tpu_torch/bench.py``, ``utils/xprof.py`` and the
    five tools), each through its entry point:
     (a) the bench's pinned workload: ``run_infer`` at B=128 x 200 steps x
         6 calls with profile=True, ``run_train(8)``, ``run_train(8,
         softdtw_loss_weight=1.0)`` (K2 == 1 warm-up + 6 steps),
         ``run_mel_extraction`` and ``run_vocoders``; in every traced
         window busy <= span <= wall (the span on the profiler's clock,
         up to MEAS_CLOCK_RTOL); the bench line's key set is the root
         bench.py's plus infer_device_busy_share and gpu;
     (b) train_step_profile --softdtw --steps 3 (K2 in its table, its
         wrapper launched once per step) and --infer at B=128, 200 int8
         steps (K1 in its table, 2 launches per step; launches per decoder
         step, the slope of its 200- and 16-step decodes, within
         MEAS_LAUNCH_RTOL of the slope in phase_profile's B=128 row,
         ``profile_rows[1]``);
     (c) serving_latency with int8 hparams and a HiFi-GAN g_ file on the
         synthetic run's checkpoint_6 given ``timer_gate`` (its gate
         layer's other weights zeroed, so the gate reads the counter
         alone): the line stops near frame AT_STOP; K1 == 2 x the decoder
         steps of its calls;
     (d) kernel_evidence: exit code 0 (K1, K2, K3 within its tolerances);
     (e) gta_vocoder_smoke --iters 20 --n 8 and infer_wav_demo
         (gate-stopped) on the synthetic corpus (``synthetic``:
         phase_synthetic_tools' return) and that checkpoint;
     (f) K1, K2 and K3 under their names in the trace, launched eagerly
         and replayed from CUDA graphs captured before and during the
         trace (``graph_kernel_names``; the counts reported).
    Writes ``_runs/measurement/`` and removes it.  Returns {k1, k2:
    launches on the phase's path (kernel_evidence's comparisons apart),
    report}."""
    import contextlib
    import io
    import os
    import runpy
    import shutil
    from pathlib import Path
    from tacotron2_subword_tpu_torch import bench as PB
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch.tools import gta_vocoder_smoke as GVS
    from tacotron2_subword_tpu_torch.tools import infer_wav_demo as IWD
    from tacotron2_subword_tpu_torch.tools import serving_latency as SL
    from tacotron2_subword_tpu_torch.tools import train_step_profile as TSP
    from tacotron2_subword_tpu_torch.utils import checkpoint as CK
    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    root = here / "_runs" / "measurement"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    report = {"gpu": gpu}
    times = {}

    def windows_ordered(name, tr):
        wall_ms = tr["wall_s"] * 1e3
        if not (tr["busy_ms"] <= tr["span_ms"]
                <= wall_ms * (1 + MEAS_CLOCK_RTOL)):
            raise AssertionError(f"{name}: busy {tr['busy_ms']} <= span "
                                 f"{tr['span_ms']} <= wall {wall_ms} ms "
                                 f"(+{MEAS_CLOCK_RTOL:.0%}) does not hold")

    # (a) the bench
    t0 = time.perf_counter()
    infer = PB.run_infer(dev, PB.INFER_BATCH, PB.INFER_STEPS,
                         PB.INFER_REPEATS, profile=True,
                         wall_windows=MEAS_WALL_WINDOWS)
    windows_ordered("bench infer", infer["traced"])
    times["bench_infer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    SD.grad_launches = SD.fwd_launches = 0
    train8 = PB.run_train(8, device=dev)
    if SD.grad_launches:
        raise AssertionError("bench run_train(8) launched K2")
    sdtw8 = PB.run_train(8, device=dev, softdtw_loss_weight=1.0)
    k2_bench = SD.grad_launches
    if k2_bench != 1 + PB.TRAIN_REPEATS:
        raise AssertionError(f"bench soft-DTW train: K2 {k2_bench}, want "
                             f"{1 + PB.TRAIN_REPEATS}")
    times["bench_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    melx = PB.run_mel_extraction(device=dev)
    windows_ordered("bench mel extraction", melx["traced"])
    voc = PB.run_vocoders(device=dev)
    times["bench_mel_vocoders_s"] = time.perf_counter() - t0
    line = PB.bench_line(infer, train8, (float("nan"), float("nan")), sdtw8,
                         melx, voc, [], {}, gpu)
    keys, extra = bench_py_keys(here / "bench.py")
    if set(line) != keys or set(line["extra"]) != extra | {
            "infer_device_busy_share", "gpu"}:
        raise AssertionError(f"bench line keys {sorted(line)} / "
                             f"{sorted(line['extra'])} against bench.py's "
                             f"{sorted(keys)} / {sorted(extra)}")
    report["bench"] = {
        "infer": infer, "train_B8": train8, "train_B8_softdtw": sdtw8,
        "k2_softdtw_train": k2_bench, "mel_extraction": melx,
        "vocoders_khz": voc, "line_value": line["value"]}
    print("measurement (a) bench", json.dumps(report["bench"]))

    # (b) train_step_profile
    t0 = time.perf_counter()
    SD.grad_launches = 0
    with contextlib.redirect_stdout(io.StringIO()) as out_t:
        tsp_t = TSP.main(["--softdtw", "--steps", str(MEAS_TSP_STEPS),
                          "--device", str(dev)])
    k2_tsp = SD.grad_launches
    k2_rows = sum(c for n, _, c in tsp_t["ops"] if "softdtw_grad" in n)
    k2_cat = tsp_t["categories_ms"]["K2 soft-DTW value + grad (hand-written)"]
    # the wrapper's count is exact and holds the warm-up step; the trace's
    # is a floor (utils.xprof)
    if k2_tsp != 1 + MEAS_TSP_STEPS or not 0 < k2_rows <= MEAS_TSP_STEPS \
            or not k2_cat > 0 or "K2 soft-DTW" not in out_t.getvalue():
        raise AssertionError(f"train_step_profile --softdtw: K2 {k2_tsp} "
                             f"launches, {k2_rows} in the table")
    Q.launches = 0
    with contextlib.redirect_stdout(io.StringIO()) as out_i:
        tsp_i = TSP.main(["--infer", "--batch", "128", "--hparams",
                          "[decode_quant:int8]", "--device", str(dev)])
    k1_tsp = Q.launches
    steps_i = tsp_i["steps"]
    k1_rows = sum(c for n, _, c in tsp_i["ops"]
                  if "dequant_int8_matmul" in n)
    ref = profile_rows[1]["kernel_launches_per_step_slope"]
    per_step = tsp_i["slope"]["launches_per_step"]
    # a warm-up and a traced decode of steps_i and of SYNC_EVERY steps
    if k1_tsp != 2 * 2 * (steps_i + TM.SYNC_EVERY) \
            or not 0 < k1_rows <= 2 * steps_i \
            or abs(per_step / ref - 1) > MEAS_LAUNCH_RTOL:
        raise AssertionError(
            f"train_step_profile --infer: K1 {k1_tsp} launches ({k1_rows} "
            f"in the table) for {steps_i} steps; {per_step} launches per "
            f"step against phase_profile's slope {ref}")
    print(out_t.getvalue())
    print(out_i.getvalue())
    times["train_step_profile_s"] = time.perf_counter() - t0
    report["train_step_profile"] = {
        "softdtw": {k: tsp_t[k] for k in ("wall_ms", "busy_ms", "span_ms",
                                          "launches_per", "busy_share",
                                          "categories_ms")},
        "infer": {k: tsp_i[k] for k in ("wall_ms", "busy_ms", "span_ms",
                                        "launches_per", "busy_share",
                                        "categories_ms", "slope")},
        "phase_profile_b128_launches_per_step_slope": ref,
        "k2_launches": k2_tsp, "k2_table_rows": k2_rows,
        "k1_launches": k1_tsp, "k1_table_rows": k1_rows}

    # (c) serving_latency on a timer-gated checkpoint, int8, HiFi-GAN
    t0 = time.perf_counter()
    # the gate reads the counter alone: the trained run's other gate
    # weights hold its logit below what the counter adds by frame 2000
    state, _ = CK.load_checkpoint(str(synthetic["root"] / "run"
                                      / "checkpoint_6"), "cpu")
    state.params["decoder"]["gate_layer"]["w"].zero_()
    timer_gate(state.params["decoder"], AT_STOP)
    ck = CK.save_checkpoint(state, str(root), name="timer_gate")
    res = write_resources(str(root))
    os.environ["T2S_RESOURCES_DIR"] = res
    h = HG.HifiganConfig()
    gpath, cpath = str(root / "g_00000001"), str(root / "config_v1.json")
    torch.save({"generator": HG.export_torch_generator(
        unit_norm_generator(HG, h, 1))}, gpath)
    write_hifigan_config(cpath, h)
    Q.launches = 0
    serve, steps = SL.main([
        "--checkpoint", ck, "--hifigan-checkpoint", gpath,
        "--hifigan-config", cpath, "--g2p-lexicon",
        os.path.join(res, "small.lex"), "--hparams", "[decode_quant:int8]",
        "--repeats", str(MEAS_SERVE_REPEATS), "--out-md",
        str(root / "latency.md"), "--device", str(dev)])
    k1_serve = Q.launches
    if k1_serve != 2 * sum(steps) or not (
            AT_MIN_FRAMES <= serve["frames"] < 2 * AT_STOP) or not (
            0 < serve["acoustic_device_ms"] <= serve["acoustic_wall_ms"]
            and 0 < serve["vocoder_device_ms"] <= serve["vocoder_wall_ms"]):
        raise AssertionError(f"serving_latency: {serve}, K1 {k1_serve} in "
                             f"{steps} steps")
    times["serving_latency_s"] = time.perf_counter() - t0
    report["serving_latency"] = {**serve, "k1_launches": k1_serve,
                                 "decode_steps": steps}

    # (d) kernel_evidence as a script: its exit code
    t0 = time.perf_counter()
    argv, sys.argv = sys.argv, ["kernel_evidence", "--repeats",
                                str(MEAS_EVIDENCE_REPEATS), "--out",
                                str(root / "evidence.md")]
    k_before = (Q.launches, SD.grad_launches, SD.fwd_launches)
    try:
        runpy.run_module("tacotron2_subword_tpu_torch.tools.kernel_evidence",
                         run_name="__main__")
    except SystemExit as e:
        code = e.code
    else:
        raise AssertionError("kernel_evidence ended without an exit code")
    finally:
        sys.argv = argv
    if code != 0:
        raise AssertionError(f"kernel_evidence exited {code}")
    times["kernel_evidence_s"] = time.perf_counter() - t0
    report["kernel_evidence"] = {
        "exit_code": code, "comparison_launches": [
            a - b for a, b in zip((Q.launches, SD.grad_launches,
                                   SD.fwd_launches), k_before)]}

    # (e) gta_vocoder_smoke and infer_wav_demo on the synthetic corpus
    t0 = time.perf_counter()
    data = str(synthetic["root"] / "data")
    gta = GVS.main(["--data", data, "--checkpoint", ck, "--work",
                    str(root / "gta"), "--iters", str(MEAS_GTA_ITERS),
                    "--n", str(MEAS_GTA_N), "--device", str(dev)])
    if gta["ft_iters"] != MEAS_GTA_ITERS or not all(np.isfinite(gta[k]) for k in (
            "mel_l1_init", "mel_l1_ft", "mel_l1_init_vs_wav",
            "mel_l1_ft_vs_wav")) or gta["samples"] <= 0:
        raise AssertionError(f"gta_vocoder_smoke: {gta}")
    times["gta_vocoder_smoke_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    demo = IWD.main(["--data", data, "--checkpoint", ck, "--out",
                     str(root / "demo.wav"), "--gate-threshold", "0.5",
                     "--device", str(dev)])
    if not (demo["gate_stopped"] and demo["frames"] >= AT_MIN_FRAMES):
        raise AssertionError(f"infer_wav_demo: {demo}")
    times["infer_wav_demo_s"] = time.perf_counter() - t0
    report["gta_vocoder_smoke"] = gta
    report["infer_wav_demo"] = demo

    # K1, K2 and K3 under their names in the trace, eager and replayed
    # from CUDA graphs (a trace's counts are floors: records can be lost
    # at its start, utils.xprof; the counts are reported)
    names = graph_kernel_names(Q, SD, dev)
    for want in ("dequant_int8_matmul", "softdtw_grad", "softdtw_fwd"):
        for when, got in names.items():
            if not 0 < sum(n for k, n in got.items() if want in k) \
                    <= MEAS_TRACE_REPS:
                raise AssertionError(f"trace ({when}): {want} not "
                                     f"1-{MEAS_TRACE_REPS} times: {names}")
    report["graph_kernel_names"] = names
    report["times_s"] = times
    report["phase_s"] = time.perf_counter() - t_phase
    print("measurement", json.dumps({k: report[k] for k in (
        "train_step_profile", "serving_latency", "kernel_evidence",
        "gta_vocoder_smoke", "infer_wav_demo", "graph_kernel_names",
        "times_s", "phase_s", "gpu")}))
    shutil.rmtree(root, ignore_errors=True)
    return {"k1": k1_tsp + k1_serve, "k2": k2_bench + k2_tsp,
            "report": report}


# G's terms (adversarial, feature, 45 x mel L1) in --gan-grad-trace: all,
# and each alone (gan_step's ``terms``)
GAN_TERMS = {"all": (1.0, 1.0, 1.0), "adv": (1.0, 0.0, 0.0),
             "feat": (0.0, 1.0, 0.0), "mel": (0.0, 0.0, 1.0)}


def gan_grad_trace(dev, gpu, B=2, depths=(8, 64)):
    """``--gan-grad-trace``: how far G's f32 gradient of one GAN step lies
    from the same step in f64.  gan_batch_scaling's seeded state trains on
    the card at B=8 (the seeded generator's output is so quiet that its
    log-mels sit on the 1e-5 clamp, where the mel term has no gradient);
    after each number of steps in ``depths``, on a SyntheticSegments batch
    of B: G's gradient (the one handed to its optimizer) with the
    generator's terms weighted as GAN_TERMS, in f32 on the card with cuDNN
    on and off, in f64 on the card and in f32 on the CPU, each against the
    witness: the step in f64 on the CPU (the f32 weights, inputs and STFT
    constants widened, so it is the exact gradient of the function the f32
    runs round).  Per term: the worst leaf (and its path) by max|d| over
    its max|g|, and the worst |d| over |g|."""
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.apps import train_hifigan as TTH
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.tools import gan_batch_scaling as TGB
    from tacotron2_subword_tpu_torch.utils.tree import (
        cast_floats, to_device, tree_leaves)
    h, cpu = HG.HifiganConfig(), torch.device("cpu")
    state, tx = TGB.init_state(h, dev)
    ds = TTH.SyntheticSegments(32)
    warm = [torch.from_numpy(a).to(dev) for a in ds.sample_batch(8)]
    mel, audio = (torch.from_numpy(a) for a in ds.sample_batch(B))

    def g_grads(st, d, w, f64=False):
        got = []

        def update(g, s, p=None):
            got.append(g)
            return tx.update(g, s, p)
        st, m, a = to_device(st, d), mel.to(d), audio.to(d)
        if f64:
            st, m, a = cast_floats(st, torch.float64), m.double(), a.double()
        TTH.gan_step(st, m, a, h, TT.Optimizer(tx.init, update), tx, terms=w)
        return [t.detach().cpu().double() for t in tree_leaves(got[0])]

    paths = _tree_paths(state.gen)

    def err(a_list, b_list):
        rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
               for a, b in zip(a_list, b_list)]
        worst = int(np.argmax(rel))
        return {"max_rel": rel[worst], "worst": paths[worst],
                "norm_rel": max((a - b).norm().item()
                                / max(b.norm().item(), 1e-300)
                                for a, b in zip(a_list, b_list))}

    out, done = {}, 0
    for depth in depths:
        for _ in range(depth - done):
            state, _ = TTH.gan_step(state, *warm, h, tx, tx)
        done = depth
        st = to_device(state, cpu)
        out[depth] = {}
        for term, w in GAN_TERMS.items():
            ref = g_grads(st, cpu, w, f64=True)
            row = {"cpu_f32": err(g_grads(st, cpu, w), ref),
                   "card_f64": err(g_grads(st, dev, w, f64=True), ref)}
            for cudnn in (True, False):
                torch.backends.cudnn.enabled = cudnn
                try:
                    row["card_cudnn" if cudnn else "card_no_cudnn"] = err(
                        g_grads(st, dev, w), ref)
                finally:
                    torch.backends.cudnn.enabled = True
            out[depth][term] = row
            print("gan grad trace", json.dumps({"steps": depth, "term": term,
                                                **row, "gpu": gpu}))
    return out


def run_bench(gpu):
    """The port's whole bench (``python -m tacotron2_subword_tpu_torch.bench``,
    PyTorch's default TF32 settings, its three CPU probes) in a subprocess:
    its JSON line, checked for the bench's keys and finite numbers, and
    its wall time."""
    from pathlib import Path
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tacotron2_subword_tpu_torch.bench"],
        check=True, capture_output=True, text=True,
        cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    sys.stderr.write(out.stderr[-4000:])
    line = json.loads(out.stdout.strip().splitlines()[-1])
    keys, extra = bench_py_keys(Path(__file__).resolve().parent / "bench.py")
    if set(line) != keys or set(line["extra"]) != extra | {
            "infer_device_busy_share", "gpu"} \
            or not np.isfinite(line["value"]) or line["value"] <= 0:
        raise AssertionError(f"bench line: {line}")
    print("bench", json.dumps(line))
    print("bench wall", json.dumps({"wall_s": wall, "gpu": gpu}))
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from tacotron2_subword_tpu_torch.apps import inference as TI
    from tacotron2_subword_tpu_torch.config import TacotronConfig
    from tacotron2_subword_tpu_torch.models import hifigan as HG
    from tacotron2_subword_tpu_torch.models import tacotron2 as TM
    from tacotron2_subword_tpu_torch import train_lib as TT
    from tacotron2_subword_tpu_torch.nn import layers as L
    from tacotron2_subword_tpu_torch.ops import _build
    from tacotron2_subword_tpu_torch.ops import conv_epilogue as EP
    from tacotron2_subword_tpu_torch.ops import quant as Q
    from tacotron2_subword_tpu_torch.ops import softdtw as SD
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

    if "--cli-nondeterminism" in sys.argv[1:]:
        cli_nondeterminism(gpu)
        print(gpu)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--gan-grad-trace" in sys.argv[1:]:
        gan_grad_trace(dev, gpu)
        print(gpu)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--bench" in sys.argv[1:]:
        run_bench(gpu)
        print(gpu)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--k1-splits" in sys.argv[1:]:
        k1_split_sweep(Q, dev)
        print(gpu)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # wall s of each phase, printed before the kernels line
    t_mark, phase_s = [time.perf_counter()], {}

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    # 2. each kernel against its plain version
    k1_rows = phase_k1(Q, dev)
    k4_rows = phase_conv_epilogue(EP, dev)
    mark("k1")

    # 3. the main path at full width, launches counted
    cfg = TacotronConfig(decode_quant="int8")
    h = HG.HifiganConfig()
    gen = torch.Generator().manual_seed(0)
    params_cpu, bn_cpu = TM.init_tacotron2(gen, cfg, device="cpu")
    gen_params = HG.fuse_generator(HG.init_generator(gen, h, device=dev))
    params, bn = to_device(params_cpu, dev), to_device(bn_cpu, dev)
    launches = phase_serve(Q, TM, TI, params, bn, gen_params, cfg, h, dev,
                           gpu)
    served_vocoder = phase_served_vocoder(EP, HG, dev)
    profile_rows = phase_profile(TM, TI, params, bn, cfg, dev)
    mark("serve_profile")
    decode_graph = phase_decode_graph(Q, TM, TI, params, bn, gen_params, cfg,
                                      h, dev, gpu)
    mark("decode_graph")

    # 4. the whole decode on the card against the CPU
    phase_whole_path(TM, TI, params_cpu, bn_cpu, cfg, dev)
    phase_gate_cost(TM, TI, L, params, bn, cfg, dev, gpu)
    del params, bn, gen_params
    mark("whole_path_gate_cost")

    # 5. the training path: K2 and K3 against their plain versions, the
    #    full-width soft-DTW train step with launches counted, the f32 step
    #    on the card against the CPU, the training CLI
    sdtw_rows = phase_softdtw(
        SD, dev, ptxas_entries(reports["softdtw"], "softdtw_fwd_kernel"))
    mark("softdtw")
    cfg_train = TacotronConfig(softdtw_loss_weight=1.0)
    k2_launches, k3_launches = phase_train(TT, SD, cfg_train, dev, gpu)
    mark("train")
    phase_train_parity(TT, TM, cfg_train, dev)
    phase_train_cli(SD)
    mark("train_parity_cli")
    real_k2, real_k3 = phase_train_real(SD, dev, gpu)
    mark("train_real")

    # 6. the text -> wav CLI at full width: K1 counted on its path,
    #    Griffin-Lim, one f32 line on the card against the CPU
    cli_launches = phase_cli(Q, dev, gpu)
    mark("cli")

    # 7. the after-training pipeline: GTA -> HiFi-GAN -> inference ->
    #    remove_silence -> evaluation (K3) -> checkpoint sweep (K1)
    after = phase_after_training(Q, SD, dev, gpu)
    mark("after_training")

    # 8. the other five attention variants: serving, f32 decode and f32
    #    gradients card vs CPU, the soft-DTW train and eval steps, one DCA
    #    CLI line
    att, _ = phase_attention_variants(Q, SD, dev, gpu)
    mark("attention_variants")

    # 9. WaveGlow (synthesis, training, reference import), the ONNX vocoder
    #    (K1 counted on its CLI line) and the tool CLIs (K1 on the demo)
    voc = phase_vocoders_and_tools(Q, dev, gpu)
    mark("vocoders_and_tools")

    # 10. multi-rank training (parallel/mesh.py): the training CLI on one
    #     NCCL rank against the plain CLI, then meshes (2,1), (1,2), (2,2)
    #     of ranks sharing the card over gloo against the single-process
    #     step, K2 and K3 counted on every rank
    mr = phase_multi_rank(dev, gpu)
    mark("multi_rank")

    # 11. the synthetic-corpus tools: make_synthetic_dataset -> the
    #     training CLI on it (K2 per step, K3 per validation batch) ->
    #     eval_synthetic's int8 sweep (K1 2 x per decode step) ->
    #     gan_batch_scaling at B = 4, 16, 32
    syn = phase_synthetic_tools(Q, SD, dev, gpu,
                                gan_step_s=after["gan_step_s"])
    mark("synthetic_tools")

    # 12. the measurement layer: the port's bench (pinned workload,
    #     K2 in its soft-DTW train run), train_step_profile, serving_latency
    #     (K1), kernel_evidence, gta_vocoder_smoke and infer_wav_demo on
    #     the synthetic corpus
    import shutil
    try:
        meas = phase_measurement(Q, SD, dev, gpu, profile_rows, syn)
    finally:
        shutil.rmtree(syn["root"], ignore_errors=True)
    mark("measurement")
    print("phase times", json.dumps({
        "build_s": build_s, **{f"{k}_s": v for k, v in phase_s.items()},
        "total_s": build_s + sum(phase_s.values()), "gpu": gpu}))

    # 13. the kernels line: K1 per decoder step of the served batch (B=4,
    #    bf16 x): the attention-LSTM call plus the decoder-LSTM call, and the
    #    same at B=128; K2 and K3 at the train step's shape, 8 x 128 x 128
    def k1_step(B):
        step = [r for r in k1_rows if r["B"] == B and r["x"] == "bf16"
                and "ms" in r]
        out = {}
        for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "library_ms",
                    "dense_bmm_ms"):
            vals = [r[key] for r in step]
            out[key] = None if None in vals else sum(vals)
        out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                          for r in step) else "operations")
        out["max_abs_err"] = max(r["max_abs_err"] for r in step)
        return out
    step4, step128 = k1_step(len(REQUESTS)), k1_step(128)
    k1 = {"name": "dequant_int8_matmul", "route": "cuda",
          "source": "tacotron2_subword_tpu_torch/csrc/dequant_int8_matmul.cu",
          "replaces": "tacotron2_subword_tpu/ops/quant.py:74",
          "launches": (launches + cli_launches + after["k1"] + att["k1"]
                       + voc["k1_onnx"] + voc["k1_tflite"] + voc["k1_demo"]
                       + syn["k1"]
                       + meas["k1"]
                       + sum(decode_graph[k]["k1_launches"] for k in (
                           "graph_first", "graph", "eager"))),
          "launches_by_path": {"serve": launches, "cli": cli_launches,
                               "decode_graph": {k: decode_graph[k][
                                   "k1_launches"] for k in (
                                   "graph_first", "graph", "eager")},
                               "after_training_inference": after["k1_infer"],
                               "checkpoint_sweep": after["k1_sweep"],
                               "attention_variants": att["k1"],
                               "onnx_cli_line": voc["k1_onnx"],
                               "tflite_cli_line": voc["k1_tflite"],
                               "demo": voc["k1_demo"],
                               "synthetic": syn["k1"],
                               "measurement": meas["k1"]},
          "cli_launches": cli_launches,
          "max_abs_err": max(r["max_abs_err"] for r in k1_rows
                             if r["x"] == "bf16"),
          **{k: step4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
          "cold_ms": step4["cold_ms"], "dense_bmm_ms": step4["dense_bmm_ms"],
          "b128": step128,
          "per": ("decoder step, bf16 x: (S=2,K=1792,N=4096) + "
                  "(S=1,K=4096,N=4096); top level at B=4, b128 at B=128; "
                  "ms warm L2, cold_ms after a 256 MB flush; launches: "
                  "every path's, launches_by_path apart"),
          "decode_loop": [{k: r[k] for k in (
              "B", "k1_us_per_step", "k1_launches_per_step",
              "device_us_per_step", "kernel_launches_per_step")}
              for r in profile_rows]}
    main_row = next(r for r in sdtw_rows if (r["B"], r["N"], r["M"])
                    == (TRAIN_B, TRAIN_T_OUT, TRAIN_T_OUT))
    row_256 = next(r for r in sdtw_rows if (r["B"], r["N"], r["M"])
                   == (TRAIN_B, 256, 256))
    no_library = ("no single PyTorch call computes soft-DTW (a wavefront "
                  "recursion over the distance matrix)")
    sdtw = []
    for name, key, fn, step_launches, real_launches, eval_launches in (
            ("softdtw_grad", "k2", "t2s_softdtw_grad", k2_launches, real_k2,
             0),
            ("softdtw_fwd", "k3", "t2s_softdtw_fwd", k3_launches, real_k3,
             after["k3"])):
        att_launches = att[key]
        errs = [r[f"{key}_value"] for r in sdtw_rows] + (
            [r[k] for r in sdtw_rows for k in ("k2_E", "k2_global_value",
                                               "k2_global_E") if k in r]
            if key == "k2" else [])
        entry = {
            "name": name, "route": "cuda",
            "source": "tacotron2_subword_tpu_torch/csrc/softdtw.cu",
            "replaces": ("tacotron2_subword_tpu/ops/softdtw.py:357"
                         if key == "k2" else
                         "tacotron2_subword_tpu/ops/softdtw.py:507"),
            "launches": (step_launches + real_launches + eval_launches
                         + att_launches + mr[key] + syn[key]
                         + meas.get(key, 0)),
            "launches_by_path": {"train_step": step_launches,
                                 "train_cli_real_data": real_launches,
                                 "evaluation": eval_launches,
                                 "attention_variants": att_launches,
                                 "multi_rank": mr[key],
                                 "multi_rank_per_rank_by_mesh":
                                     mr[f"{key}_per_rank"],
                                 "synthetic": syn[key],
                                 "measurement": meas.get(key, 0)},
            "max_abs_err": max(errs + ([r["max_abs_err"]
                                        for r in after["k3_shapes"]]
                                       if key == "k3" else [])),
            "ms": main_row[f"{key}_ms"], "plain_ms": main_row[f"{key}_plain_ms"],
            "bound_ms": main_row[f"{key}_bound_ms"],
            "bound_by": main_row[f"{key}_bound_by"], "library_ms": None,
            "library": no_library,
            "serial_diagonals": main_row[f"{key}_serial_diagonals"],
            "us_per_diagonal": main_row[f"{key}_us_per_diagonal"],
            "per": (f"one call at B={TRAIN_B}, N=M={TRAIN_T_OUT} "
                    f"({'train' if key == 'k2' else 'eval'} step)"),
            "entry": fn}
        if key == "k2":
            entry["variant"] = main_row["k2_variant"]
            entry["global_variant_ms"] = main_row["k2_global_ms"]
        else:
            entry["plan"] = main_row["k3_plan"]
            entry["ptxas"] = main_row["k3_ptxas"]
            entry["serial_floor_ms"] = main_row["k3_serial_floor_ms"]
            entry["cycles_per_diagonal"] = main_row["k3_cycles_per_diagonal"]
            entry["cli_bucket"] = {k: row_256[f"k3_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "us_per_diagonal", "plan",
                "serial_floor_ms", "cycles_per_diagonal")}
            entry["evaluation"] = [{k: r[k] for k in (
                "N", "M", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")} | {"scratch": bool(r["plan"]["scratch_floats"]),
                                    "warps": r["plan"]["warps"],
                                    "strips": r["plan"]["strips"]}
                for r in after["k3_shapes"]]
            entry["small"] = [{k: r[k] for k in (
                "B", "N", "M", "k3_ms", "k3_plain_ms", "k3_wall_ms",
                "k3_plain_wall_ms")} for r in sdtw_rows
                if (r["B"], r["N"], r["M"]) in SDTW_SMALL]
        sdtw.append(entry)
    k4 = {"name": "conv_epilogue", "route": "cuda",
          "source": "tacotron2_subword_tpu_torch/csrc/conv_epilogue.cu",
          "replaces": None, "launches": served_vocoder["launches"],
          "launches_per": (f"one served V1 group, {SERVED_GROUP[0]} rows x "
                           f"{SERVED_GROUP[1]} frames, TF32 allowed"),
          "served_vocoder": served_vocoder,
          "per": (f"one call at V1's largest served stage, {K4_STAGE[0]} "
                  f"rows x {K4_STAGE[1]} channels"), "rows": k4_rows}
    print(json.dumps({"kernels": [k1] + sdtw + [k4]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
