"""Device-time breakdown of the full train step, or of the free-running
decode, by CUDA kernel category (the port's counterpart of the root
``tools/train_step_profile.py``, with its flags).

    python -m tacotron2_subword_tpu_torch.tools.train_step_profile \
        [--batch 8] [--t-out 128] [--steps 10] [--softdtw] [--out NOTE.md]
        [--infer [--infer-steps 200] [--hparams "[decode_quant:int8]"]]
        [--device cpu]

The batch, state and decode are the port's bench workload
(``tacotron2_subword_tpu_torch.bench``: ``train_setup`` and
``_build_infer``).  One step (or decode) runs before the trace; then
``--steps`` train steps (or one decode of ``--infer-steps`` steps, and
one of 16 for the per-step slope) run under ``torch.profiler`` with CUDA
activity, read by ``utils.xprof``:
device busy time (the union of the kernel, copy and set intervals), the
span, the wall time of the traced work, launches, and the kernels' time by
category (``CATEGORIES``; what matches none is "other", printed with its
share and its largest kernels).  ``--hparams`` (the decode's config, e.g.
int8) applies to ``--infer``.  The device is CUDA unless ``--device cpu``
is given; on the CPU the trace holds no device activity and the device
columns read "not measured".
"""

from __future__ import annotations

import argparse
import re
import time

import torch

from tacotron2_subword_tpu_torch import bench
from tacotron2_subword_tpu_torch.utils import xprof
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

# first match wins: the hand-written kernels, then the library and
# PyTorch kernel families by name
CATEGORIES = (
    ("K1 int8 dequant matmul (hand-written)",
     re.compile(r"dequant_int8_matmul")),
    ("K2 soft-DTW value + grad (hand-written)",
     re.compile(r"softdtw_grad")),
    ("K3 soft-DTW value (hand-written)", re.compile(r"softdtw_fwd")),
    ("NCCL collectives", re.compile(r"nccl", re.I)),
    ("RNG", re.compile(r"philox|curand|distribution|bernoulli|dropout|"
                       r"normal_kernel|uniform_kernel|randperm", re.I)),
    ("index / gather / scatter",
     re.compile(r"index|gather|scatter|embedding|take_|masked_select|"
                r"nonzero", re.I)),
    ("copies / transposes",
     re.compile(r"memcpy|memset|copy|transpose|catarray|cat_|flip|"
                r"permute", re.I)),
    ("GEMM / convolution (cuBLAS, cuDNN)",
     re.compile(r"gemm|gemv|cutlass|xmma|cublas|cudnn|conv|nvjet|"
                r"splitkreduce|winograd|implicit_|dot_kernel", re.I)),
    ("elementwise / reduce",
     re.compile(r"elementwise|reduce|reduction|softmax|norm|pointwise|"
                r"fill|scan|sort|cumsum|where|clamp|lstm|sum_|mean_",
                re.I)),
)


def categorize(ops):
    """{category: total ms} of ``(name, ms, n)`` rows, with "other" for the
    names that match no category."""
    out = {name: 0.0 for name, _ in CATEGORIES}
    out["other"] = 0.0
    for name, ms, _n in ops:
        out[category(name)] += ms
    return out


def category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def _trace(run, dev):
    """``run()`` under torch.profiler (the CUDA activity alone; the CPU's
    where there is no card): (DeviceProfile, wall s of run)."""
    from torch.profiler import ProfilerActivity, profile
    with (xprof.device_profile() if dev.type == "cuda" else
          profile(activities=[ProfilerActivity.CPU])) as prof:
        t0 = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return xprof.profile_summary(prof), wall


def report(title: str, s: xprof.DeviceProfile, wall_s: float, n: int,
           unit: str, scale: float, n_top: int):
    """(the text table, its numbers): busy, span and wall per ``unit`` (one
    of ``n``), launches per unit, each category's time per unit and share
    of the kernels' time, the kernels with the most time."""
    total = sum(ms for _, ms, _ in s.ops)
    cats = categorize(s.ops)
    measured = s.n_events > 0
    row = {
        "wall_ms": wall_s * 1e3, "busy_ms": s.busy_ms if measured else None,
        "span_ms": s.span_ms if measured else None,
        "launches": s.n_events, "launches_per": s.n_events / n,
        "busy_share": s.busy_ms / (wall_s * 1e3) if measured else None,
        "categories_ms": cats,
        "ops": [list(o) for o in s.ops],
    }
    f = lambda ms: (f"{ms * scale / n:9.3f}" if measured else
                    "not measured")
    lines = [title,
             f"device busy {f(s.busy_ms)} {unit} (union of kernel "
             f"intervals), span {f(s.span_ms)}, wall "
             f"{wall_s * 1e3 * scale / n:9.3f} {unit}; busy share "
             + (f"{100 * row['busy_share']:.1f}%" if measured else
                "not measured"),
             f"kernel launches {s.n_events} ({s.n_events / n:.2f} per "
             f"{unit.split('/')[-1]})",
             "", f"by category ({unit}, % of the kernels' time):"]
    for cat, ms in sorted(cats.items(), key=lambda t: -t[1]):
        share = f"{100 * ms / total:5.1f}%" if total else "  -  "
        lines.append(f"  {cat:40s} {f(ms)}  {share}")
    other = [(nm, ms, k) for nm, ms, k in s.ops if category(nm) == "other"]
    if other:
        lines.append("  other, largest: " + "; ".join(
            f"{nm[:60]} x{k}" for nm, _, k in other[:5]))
    lines += ["", f"top kernels (total ms, count over the trace):"]
    for name, ms, k in s.ops[:n_top]:
        lines.append(f"  {ms:9.3f} ms  x{k:<6d} {name[:90]}")
    return "\n".join(lines), row


def profile_infer(args, dev):
    """--infer: the decode of ``bench._build_infer`` at B=args.batch for
    args.infer_steps steps (one untraced call first).  A second traced
    decode of SYNC_EVERY steps gives the per-step figures as a slope, so
    the encoders, the postnet and the per-call set-up cancel: launches and
    busy us per decoder step = (long - short) / (steps - SYNC_EVERY)."""
    from tacotron2_subword_tpu_torch.config import create_config
    from tacotron2_subword_tpu_torch.models.tacotron2 import SYNC_EVERY
    cfg = create_config(hparams_string=args.hparams)
    _cfg, make_fn = bench._build_infer(dev, args.batch, cfg)
    if args.infer_steps <= SYNC_EVERY:
        raise ValueError(f"--infer-steps must exceed {SYNC_EVERY}")
    fn, short = make_fn(args.infer_steps), make_fn(SYNC_EVERY)
    float(fn(1)), float(short(1))   # warm-up outside the traces
    s_short, _ = _trace(lambda: float(short(2)), dev)
    s, wall = _trace(lambda: float(fn(2)), dev)
    d = args.infer_steps - SYNC_EVERY
    slope = {"launches_per_step": (s.n_events - s_short.n_events) / d,
             "busy_us_per_step": (s.busy_ms - s_short.busy_ms) * 1e3 / d
             if s.n_events else None}
    text, row = report(
        f"decode device profile: B={args.batch}, {args.infer_steps} "
        f"free-running steps, {cfg.compute_dtype}"
        + (f", {cfg.decode_quant}" if cfg.decode_quant else "")
        + f" (device {dev})", s, wall, args.infer_steps, "us/step", 1e3, 20)
    busy = slope["busy_us_per_step"]
    text += (f"\nper decoder step, slope of the {args.infer_steps}- and "
             f"{SYNC_EVERY}-step decodes (encoders and postnet cancel): "
             f"{slope['launches_per_step']:.2f} launches, "
             + ("busy not measured" if busy is None else
                f"{busy:.2f} us busy"))
    return text, {**row, "steps": args.infer_steps, "B": args.batch,
                  "slope": slope}


def profile_train(args, dev):
    from tacotron2_subword_tpu_torch import train_lib as T
    over = {"softdtw_loss_weight": 1.0} if args.softdtw else {}
    cfg, state, tx, batch_d = bench.train_setup(args.batch, args.t_out, dev,
                                                **over)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    state, m = T.train_step(state, batch_d, cfg, tx, generator=gen(1))
    float(m["total"])   # warm-up outside the trace

    def steps():
        s = state
        for i in range(args.steps):
            s, m = T.train_step(s, batch_d, cfg, tx, generator=gen(2 + i))
        float(m["total"])
    s, wall = _trace(steps, dev)
    text, row = report(
        f"train-step device profile: B={args.batch}, T_out={args.t_out}, "
        f"{cfg.compute_dtype}, {args.steps} steps, softdtw={args.softdtw} "
        f"(device {dev})", s, wall, args.steps, "ms/step", 1.0, 15)
    return text, {**row, "steps": args.steps, "B": args.batch}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--t-out", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--softdtw", action="store_true")
    ap.add_argument("--infer", action="store_true",
                    help="profile the free-running decode loop instead of "
                         "the train step")
    ap.add_argument("--infer-steps", type=int, default=200)
    ap.add_argument("--hparams", default=None,
                    help="the decode's config for --infer")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    return ap


def main(argv=None) -> dict:
    """Prints the report (and writes ``--out``); returns its numbers:
    wall / busy / span ms of the traced work, launches and launches per
    step, ms per category, the kernels' (name, ms, count) rows."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    text, row = (profile_infer if args.infer else profile_train)(args, dev)
    print(text)
    if args.out:
        head = ("# Decode-loop device profile" if args.infer
                else "# Train-step device profile")
        with open(args.out, "w") as f:
            f.write(f"{head}\n\n```\n{text}\n```\n")
    return row


if __name__ == "__main__":
    main()
