"""HiFi-GAN GAN-step throughput against the batch size (the port's copy of
the root ``tools/gan_batch_scaling.py``, with its flags and report table).

    python -m tacotron2_subword_tpu_torch.tools.gan_batch_scaling \
        [--batches 4 16] [--iters 20] [--converge SECONDS] \
        [--out report.md] [--device cpu]

If a step at B=16 costs much less than 4x a step at B=4, each GAN
iteration averages 4x the segments for little more wall time: smoother
discriminator gradients and more examples per second.  ``measure`` times
the step: the full-size v1 generator, the MPD and MSD discriminators and
both Adam updates, which is ``apps.train_hifigan.gan_step`` with
``make_optimizer(2e-4, lr_decay=1.0)`` (reference
hifigan_infer/hifigan_model.py:127-281), on synthetic 8192-sample segments
(``SyntheticSegments(32)``).  Each batch size starts from the same seeded
init; its first step (cuDNN's set-up included) is reported as
``compile_s``, 3 more warm the card, and ``--iters`` steps are timed by
the wall clock over the chained run with one trailing scalar fetch, so
the host never waits inside the chain.  The peak memory allocated per
batch size is reported beside it (CUDA only).  ``--converge SECONDS``
trains each batch size for the same wall time from the same init instead
and reports the mel L1 reached.  ``--out`` appends a markdown table.  The
device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tacotron2_subword_tpu_torch.apps.train_hifigan import (
    SEGMENT, GanState, SyntheticSegments, gan_step, make_optimizer)
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.utils.platform import resolve_device


def init_state(h: HG.HifiganConfig, device, seed: int = 0):
    """(GanState of the seeded generator and discriminators with fresh Adam
    states, the optimizer both take)."""
    gen = torch.Generator().manual_seed(seed)
    params = HG.init_generator(gen, h, device=device)
    disc = HG.init_discriminators(gen, device=device)
    tx = make_optimizer(2e-4, lr_decay=1.0)
    return GanState(params, disc, tx.init(params), tx.init(disc)), tx


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(batch_sizes, iters: int, warmup: int = 3, device=None,
            h: HG.HifiganConfig = None):
    """Per batch size: {B, s_per_it, segments_per_s, audio_s_per_s,
    compile_s (the first step's wall), loss (d + g of the last step),
    peak_gb (None on the CPU)}."""
    device = resolve_device(device)
    h = h or HG.HifiganConfig()  # full-size v1
    state0, tx = init_state(h, device)
    ds = SyntheticSegments(32)
    rows = []
    for B in batch_sizes:
        mel_np, audio_np = ds.sample_batch(B)
        mel = torch.from_numpy(mel_np).to(device)
        audio = torch.from_numpy(audio_np).to(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        step = lambda s: gan_step(s, mel, audio, h, tx, tx)
        t0 = time.perf_counter()
        state, m = step(state0)
        float(m["g_loss"])  # the first step, cuDNN's set-up included
        compile_s = time.perf_counter() - t0
        for _ in range(warmup):
            state, m = step(state)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state)
        final = float(m["d_loss"] + m["g_loss"])  # one trailing fetch
        s_it = (time.perf_counter() - t0) / iters
        peak = (torch.cuda.max_memory_allocated(device) / 1e9
                if device.type == "cuda" else None)
        seg_s = B / s_it
        audio_s = seg_s * SEGMENT / 22050.0
        rows.append({"B": B, "s_per_it": s_it, "segments_per_s": seg_s,
                     "audio_s_per_s": audio_s, "compile_s": compile_s,
                     "loss": final, "peak_gb": peak})
        print(f"B={B}: {s_it*1e3:.1f} ms/it, {seg_s:.1f} segments/s "
              f"({audio_s:.0f} audio-sec/s), first step {compile_s:.1f}s, "
              f"loss {final:.2f}"
              + (f", peak {peak:.3f} GB" if peak is not None else ""),
              flush=True)
        del state
    return rows


def converge(batch_sizes, seconds: float, chunk: int = 25, device=None,
             h: HG.HifiganConfig = None):
    """Equal wall time: each batch size trains from the same init for
    ``seconds`` and reports the mel L1 reached (the median of its last 3
    chunks).  A fresh batch is drawn per chunk of ``chunk`` steps, and the
    mel L1 is fetched once per chunk."""
    device = resolve_device(device)
    h = h or HG.HifiganConfig()
    state0, tx = init_state(h, device)
    ds = SyntheticSegments(32)
    rows = []
    for B in batch_sizes:
        mel_np, audio_np = ds.sample_batch(B)
        state, m = gan_step(state0, torch.from_numpy(mel_np).to(device),
                            torch.from_numpy(audio_np).to(device), h, tx, tx)
        float(m["mel_l1"])  # the first step, outside the budget
        iters, t0 = 0, time.perf_counter()
        history = []
        while time.perf_counter() - t0 < seconds:
            mel_np, audio_np = ds.sample_batch(B)
            mel = torch.from_numpy(mel_np).to(device)
            audio = torch.from_numpy(audio_np).to(device)
            for _ in range(chunk):
                state, m = gan_step(state, mel, audio, h, tx, tx)
            iters += chunk
            history.append(float(m["mel_l1"]))
        final = float(np.median(history[-3:]))
        rows.append({"B": B, "iters": iters, "mel_l1": final,
                     "segments": iters * B})
        print(f"B={B}: {iters} iters / {iters*B} segments in {seconds:.0f}s "
              f"wall, mel L1 {final:.3f} (start {history[0]:.3f})",
              flush=True)
        del state
    return rows


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 16])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--converge", type=float, default=0.0, metavar="SECONDS",
                    help="instead of step timing, train each batch size "
                         "for SECONDS of equal wall from the same init and "
                         "report the mel-L1 reached")
    ap.add_argument("--out", default=None,
                    help="append a markdown table to this report file")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    return ap


def main(argv=None):
    """Returns the rows of ``measure`` or ``converge``."""
    args = build_argparser().parse_args(argv)
    if args.converge:
        rows = converge(args.batches, args.converge, device=args.device)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write("\n| B | iters | segments seen | mel L1 @ equal "
                        "wall |\n|---|---|---|---|\n")
                for r in rows:
                    f.write("| %d | %d | %d | %.3f |\n" % (
                        r["B"], r["iters"], r["segments"], r["mel_l1"]))
            print(f"appended table to {args.out}")
        return rows
    rows = measure(args.batches, args.iters, device=args.device)
    if args.out and rows:
        base = rows[0]
        with open(args.out, "a", encoding="utf-8") as f:
            f.write("\n| B | ms/it | segments/s | audio-sec/s | compile s "
                    "| vs B=%d wall | vs B=%d thru |\n|---|---|---|---|---"
                    "|---|---|\n" % (base["B"], base["B"]))
            for r in rows:
                f.write("| %d | %.1f | %.1f | %.0f | %.0f | %.2fx | %.2fx "
                        "|\n" % (r["B"], r["s_per_it"] * 1e3,
                                 r["segments_per_s"], r["audio_s_per_s"],
                                 r["compile_s"],
                                 r["s_per_it"] / base["s_per_it"],
                                 r["segments_per_s"]
                                 / base["segments_per_s"]))
        print(f"appended table to {args.out}")
    return rows


if __name__ == "__main__":
    main()
