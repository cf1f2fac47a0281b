"""What the program's own tracing shows in a traced run of one cell,
beyond the benchmark's metrics:

    python3 -m t2s_bench.program_trace --workload <cell> --seeds <n> ... \
        --seconds <s> [--trace <0|1>]

Each seed is one ``t2s_bench.run`` run, which with ``--trace 1`` turns the
program's spans and counters (``system/<adapter>_trace.py``) on over its
timed window and its profiled batch, whose trace it keeps with its launch
records (``obs["program"]``); with ``--trace 0`` nothing is traced and the
line holds the run's end-to-end metrics and ``by_hand`` alone.  One JSON
line per seed: ``correct``, the window's ``audio_s_per_s`` (with
``--trace 1``, with the tracing's cost and the outside spans' waits), the
run's own metrics (those of ``attribution.METRICS`` among them), the
window's counters, its seconds in each span (``span_s``) and the live
shares reckoned from its lengths (``by_hand``), and with a profiled batch
the attribution's route, the share of device rows that had a launch
record, the batch's idle by span (host-bound and launch latency, s), its
longest CUDA runtime and driver calls by span (``host_calls``) and its
idle gaps (``gaps``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from t2s_bench import attribution as A, judge, layout, run as R


def by_hand(batches, r: int) -> dict:
    """The live shares reckoned from the window's own lengths (``obs
    ["batches"]``: (mel lengths, steps run) a batch): decode row-steps up
    to each stop over B x steps run; vocoder frames max(n, 8) over B x the
    padded frames."""
    rows = live = frames = live_f = 0
    for n, steps in batches:
        kept = judge.vocoder_frames(n)
        pad = -(-int(kept.max()) // judge.BUCKET) * judge.BUCKET
        rows += len(n) * steps
        live += int((n // r).sum())
        frames += len(n) * pad
        live_f += int(kept.sum())
    return {"decode_live_share": 100.0 * live / rows if rows else None,
            "vocoder_live_share": 100.0 * live_f / frames if frames else None}


GAP_BINS_US = (1, 2, 3, 4, 6, 10, 20)


def gaps(a: A.Attribution, parts: int = 10) -> dict:
    """The idle gaps of the profiled batch.  ``leads``: device start less
    launch record (us) of the rows that end a gap, by tenth of the batch,
    as [rows, min, median, median gap]: how far the two clocks agree.
    ``hist``: the gaps counted by length in us, below each of
    ``GAP_BINS_US`` and above the last."""
    tenths = [[] for _ in range(parts)]
    hist = [0] * (len(GAP_BINS_US) + 1)
    if not a.rows:
        return {"leads": [], "hist": hist}
    t0, t1 = a.rows[0].start_ns, a.rows[-1].start_ns + 1
    end = a.rows[0].end_ns
    for r, at in zip(a.rows[1:], a.launch_ns[1:]):
        if r.start_ns > end:
            gap = (r.start_ns - end) / 1e3
            tenths[(r.start_ns - t0) * parts // (t1 - t0)].append(
                ((r.start_ns - at) / 1e3, gap))
            hist[sum(gap >= b for b in GAP_BINS_US)] += 1
        end = max(end, r.end_ns)
    leads = [[len(v), min(v)[0], sorted(v)[len(v) // 2][0],
              sorted(g for _, g in v)[len(v) // 2]] if v else [0]
             for v in tenths]
    return {"leads": leads, "hist": hist}


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = layout.ROOT) -> dict:
    res = R.run(cell, seed, seconds, trace, device=device, root=root)
    obs = res["obs"]
    prog = obs["program"] or {}
    window, attr = prog.get("window"), prog.get("attribution")
    out = {"seed": seed, "correct": res["correct"], "trace": int(trace),
           "audio_s_per_s": obs["audio_s"] / obs["window_s"],
           "metrics": res["metrics"],
           "counters": window[1] if window else None,
           "span_s": ({n: A.span_ns(window[0], n) / 1e9
                       for n in sorted({s[0] for s in window[0]})}
                      if window else None),
           "by_hand": by_hand(obs["batches"],
                              cell["config"]["tacotron"]["n_frames_per_step"])}
    if attr is not None:
        out.update(route=attr.route, launch_matched=attr.matched,
                   idle_by_span={k: [attr.host_bound_s.get(k, 0.0),
                                     attr.latency_s.get(k, 0.0)]
                                 for k in sorted(set(attr.host_bound_s)
                                                 | set(attr.latency_s))},
                   host_calls=A.host_calls(prog["calls"],
                                           prog["profiled"][0]),
                   gaps=gaps(attr),
                   wall_s=prog["wall_s"], device=res["device"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    cell = layout.cell(args.workload)
    for seed in args.seeds:
        try:
            res = run(cell, seed, args.seconds, bool(args.trace))
        except R.NoCard as e:
            print(f"t2s_bench: {e}", file=sys.stderr)
            return 2
        print(json.dumps(res, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
