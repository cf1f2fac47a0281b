"""The benchmark of the port, one run of one cell:

    python3 -m t2s_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the process's start): the program imported, the
card initialised, the weights made on the card from the seed, the traffic
drawn, one warm-up batch served at the cell's own shapes.  Then the window:
batches back to back through the program's serving entry, each counted
when its wavs are on the host, until ``--seconds`` have passed; the rate is
all the audio over all the time of the window.  With ``--trace 1`` the
window runs with spans around the serving entry's layers and, where the
configuration's system adapter has a ``_trace`` file, with the program's
own spans and counters on; then one more batch is profiled, the program's
tracing on over it too.  Then the output check (``judge``): the program's
state is freed and the plain reference judges one batch of the window.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (sentences), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared, with its limit, also printed as the last lines of standard error.
Exits 2, printing no result, where there is no card or too few.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from t2s_bench import (  # noqa: E402
    attribution as A, flops, judge, layout, spans as S, weights as W)
from t2s_bench.frozen import xprof  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tacotron2_subword_tpu")
TRACE_ATTEMPTS = 3
OP_NAME_CHARS = 160


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def tree_specs(cfg: dict, root: Path = layout.ROOT) -> List[W.Spec]:
    """Every leaf of a configuration: the Tacotron 2's, then its vocoder
    part's."""
    name = cfg["vocoder"]
    return (W.tacotron_specs(cfg["tacotron"])
            + layout.vocoder(name, root).specs(cfg[name]))


def make_tree(cell: dict, traffic, seed: int, device,
              root: Path = layout.ROOT) -> dict:
    """The configuration's weights from the seed, rigged by the traffic
    generator: {"params", "bn", "gen"}."""
    specs = tree_specs(cell["config"], root)
    flat = W.make(specs, (2 * seed) % 2 ** 63, device)
    tree = {k: W.nest(flat, k) for k in ("params", "bn", "gen")}
    traffic.rig(tree["params"], cell["mix"])
    return tree


class Window:
    """The batches of one run, and what the check and the metrics read."""

    def __init__(self, cell, traffic, sut, batches, gen, seed, check: int,
                 vocoder):
        self.cell, self.traffic, self.sut = cell, traffic, sut
        self.vocoder = vocoder               # the configuration's part
        self.batches, self.gen, self.seed = batches, gen, seed
        self.check = check                   # the batch the check reads
        self.mix = cell["mix"]
        self.k = 0
        self.wavs: List[np.ndarray] = []     # per batch, all samples
        self.lens: List[np.ndarray] = []     # per batch, samples a sentence
        self.n: List[np.ndarray] = []        # per batch, frames a sentence
        self.ok: List[np.ndarray] = []
        self.steps: List[int] = []
        self.kept: Optional[judge.Kept] = None

    def warm_up(self):
        self.sut.serve(self.batches[0], self.gen)

    def batch(self, record: bool = True):
        """Serve the next batch and bring its wavs to the host; ``record``
        counts it in the window.  Of batch ``check``, keep what the output
        check reads."""
        k = self.k
        reqs = self.batches[k % len(self.batches)]
        state = self.gen.get_state() if k == self.check else None
        out = self.sut.serve(reqs, self.gen)
        wavs = out["wavs"]
        lens = np.array([w.shape[0] for w in wavs], np.int64)
        host = torch.cat(wavs).cpu().numpy()
        n = out["mel_lengths"].cpu().numpy()
        if record:
            self.wavs.append(host)
            self.lens.append(lens)
            self.n.append(n)
            self.ok.append(out["infer_ok"].cpu().numpy())
            self.steps.append(int(out["steps_run"]))
        if state is not None:
            rows = self.traffic.check_rows(self.mix, self.seed, k, n)
            idx = torch.as_tensor(rows, device=out["mel"].device)
            starts = np.concatenate([[0], np.cumsum(lens)])
            self.kept = judge.Kept(
                k, rows, n, int(out["steps_run"]), state,
                out["mel"].index_select(0, idx),
                out["mel_postnet"].index_select(0, idx),
                out["gate"].index_select(0, idx),
                [host[starts[i]:starts[i + 1]] for i in rows])
        self.k += 1

    def run(self, seconds: float) -> float:
        t0 = time.perf_counter()
        while True:
            self.batch()
            el = time.perf_counter() - t0
            if el >= seconds:
                return el

    def failed(self, hop: int) -> int:
        """Sentences that hit the step limit or gave a non-finite or
        wrong-length wav."""
        bad = 0
        for host, lens, n, ok in zip(self.wavs, self.lens, self.n, self.ok):
            starts = np.concatenate([[0], np.cumsum(lens)])
            want = judge.vocoder_frames(n) * hop
            for i in range(len(lens)):
                w = host[starts[i]:starts[i + 1]]
                bad += int(not ok[i] or lens[i] != want[i]
                           or not np.all(np.isfinite(w)))
        return bad

    def audio_s(self, sr: int) -> float:
        return float(sum(int(l.sum()) for l in self.lens)) / sr

    def flops(self) -> float:
        cfg = self.cell["config"]
        voc = self.vocoder.frame_flops(cfg[cfg["vocoder"]])
        total = 0.0
        for k, n in enumerate(self.n):
            reqs = self.batches[k % len(self.batches)]
            total += flops.batch_flops(cfg["tacotron"], voc,
                                       [len(r[0]) for r in reqs],
                                       [len(r[1]) for r in reqs], n)
        return total


@contextlib.contextmanager
def recording(tr):
    """The program's own spans and counters on over the body, where ``tr``
    (the system adapter's ``_trace`` file) is given.  Yields a list that
    holds, after the body, what the program recorded in it: (spans,
    counters)."""
    got: list = []
    if tr is None:
        yield got
        return
    tr.enable()
    tr.take()
    try:
        yield got
    finally:
        got.append(tr.take())
        tr.disable()


def profile_batch(win: Window, spans: S.Spans, sysmod, sync, tr=None
                  ) -> dict:
    """One batch under the device profiler, cut at its span markers:
    ``segments``, ``steps`` run, host ``wall_s``, ``frames`` (the batch's
    mel lengths) and, with the program's tracing ``tr``, ``profiled`` (its
    spans and counters) and ``records`` (the trace's device rows, launch
    records and host calls: ``attribution.records``).  Taken again where
    the trace lost records: a marker, or a K1 launch that the program
    counted."""
    for _ in range(TRACE_ATTEMPTS):
        spans.marks = []
        before = sysmod.counters()
        with xprof.device_profile() as prof, recording(tr) as profiled:
            t0 = time.perf_counter()
            spans.marks.append(("synthesize", True))
            xprof.mark()
            out = win.sut.serve(win.batches[win.k % len(win.batches)],
                                win.gen)
            spans.marks.append(("synthesize", False))
            xprof.mark()
            torch.cat(out["wavs"]).cpu()
            spans.marks.append(("end", False))
            xprof.mark()
            sync()
            wall = time.perf_counter() - t0
        marks, spans.marks = spans.marks, None
        segs = S.segments(xprof.device_rows(prof, markers=True), marks,
                          S.HARNESS)
        counted = {k: v - before[k] for k, v in sysmod.counters().items()}
        if segs is not None and all(
                sum(1 for _, rows in segs for r in rows if name in r[0])
                == counted.get(kid, 0)
                for kid, name in sysmod.KERNELS.items()):
            return {"segments": segs, "steps": int(out["steps_run"]),
                    "wall_s": wall,
                    "frames": [int(n) for n in out["mel_lengths"].tolist()],
                    "profiled": profiled[0] if profiled else None,
                    "records": A.records(prof) if profiled else None}
    raise RuntimeError(f"device trace lost records in {TRACE_ATTEMPTS} "
                       f"attempts")


def breakdown(segs) -> dict:
    rows = [r for _, rs in segs for r in rs]
    prof = xprof.summarize_rows(rows)
    idle = S.idle_gaps(segs)
    return {"device_ops": [[name[:OP_NAME_CHARS], ms / 1e3]
                           for name, ms, _ in prof.ops[:10]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}, prof


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        root: Path = layout.ROOT, control: bool = False) -> dict:
    """One run of ``cell`` (``layout.cell``); returns the result's fields,
    ``checks`` and ``obs`` (what the per-layer metrics read).  With
    ``control``, also ``control``: the gaps of the reference at the
    configuration's control precision, put in the program's place on the
    same served inputs (``t2s_bench.control``)."""
    device = torch.device(device)
    seed %= 2 ** 63
    if device.type == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["workload"]["chips"]):
        raise NoCard(f"the cell needs {cell['workload']['chips']} CUDA "
                     f"card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cfg, mix, wl = cell["config"], cell["mix"], cell["workload"]
    traffic = layout.generator(mix["generator"], root)
    sysmod = layout.system(cfg["system"], root)
    refmod = layout.reference(cfg["reference"], root)
    vocoder = layout.vocoder(cfg["vocoder"], root)
    sync = S.sync_of(device)
    tree = make_tree(cell, traffic, seed, device, root)
    sut = sysmod.System(cfg, mix, tree, device)
    batches = traffic.make(mix, seed, cfg["tacotron"])
    gen = torch.Generator(device=device)
    gen.manual_seed((2 * seed + 1) % 2 ** 63)
    win = Window(cell, traffic, sut, batches, gen, seed,
                 traffic.check_batch(mix, seed), vocoder)
    win.warm_up()                            # the cell's shapes
    sync()
    setup_s = time.perf_counter() - T_START

    spans = tr = None
    if trace:
        spans = S.Spans([(sysmod.module(m), f, label)
                         for m, f, label in sysmod.SPANS], sync)
        tr = layout.system_trace(cfg["system"], root)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with recording(tr) as window_rec:
            window_s = win.run(seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        span_s = dict(spans.total) if spans is not None else {}
        prof = None
        if trace and device.type == "cuda":
            prof = profile_batch(win, spans, sysmod, sync, tr)
    finally:
        if spans is not None:
            spans.close()
    t = cfg["tacotron"]
    hop, sr = t["hop_length"], t["sampling_rate"]
    audio_s = win.audio_s(sr)
    obs = {"cell": cell["name"], "config": cfg, "tacotron": t,
           "kernels": sysmod.KERNELS, "window_s": window_s,
           "audio_s": audio_s, "steps": sum(win.steps),
           "batches": list(zip(win.n, win.steps)), "spans": span_s,
           "flops": win.flops(), "peak_bytes": peak, "trace": None,
           "program": None}
    out: dict = {"attempted": int(sum(len(l) for l in win.lens)),
                 "failed": win.failed(hop)}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell["workload"]["chips"], "memory_peak_bytes": int(peak)}
    if prof is not None:
        bd, summary = breakdown(prof["segments"])
        obs["trace"] = {"segments": prof["segments"], "steps": prof["steps"],
                        "wall_s": prof["wall_s"], "frames": prof["frames"],
                        "busy_s": summary.busy_ms / 1e3,
                        "batch": mix["batch"]}
        device_info.update(busy_s=summary.busy_ms / 1e3,
                           window_s=prof["wall_s"])
        out["breakdown"] = bd
    if tr is not None:
        # in the shape ``attribution.METRICS`` reads, with the profiled
        # batch's host CUDA calls
        obs["program"] = {"window": window_rec[0], "profiled": None,
                          "attribution": None, "calls": None,
                          "wall_s": None}
        if prof is not None:
            rows, launches, calls = prof["records"]
            obs["program"].update(
                profiled=prof["profiled"], calls=calls,
                attribution=A.attribute(rows, launches,
                                        prof["profiled"][0]),
                wall_s=prof["wall_s"])

    # the check: the batch it reads, served after the window where the
    # window was shorter (a run of a second or less); then the program's
    # state is freed and the reference judges
    while win.kept is None:
        win.batch(record=False)
    kept = win.kept
    reqs = batches[kept.batch % len(batches)]
    del sut, tree, win
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_tree = make_tree(cell, traffic, seed, device, root)
    prec = refmod.Precision(cfg["precision"], t["compute_dtype"], plain=True)
    ref_out = judge.outputs(refmod, cfg, ref_tree, reqs, kept, prec, device)
    checks = judge.gaps(judge.served(kept), ref_out, kept.n[kept.rows], hop)
    checks["stop_off"] = judge.stop_off(
        kept, mix["gate_threshold"], getattr(torch, t["compute_dtype"]))
    checks["failed"] = out["failed"]
    limits = wl["limits"]
    if control:
        low = refmod.Precision(cfg["control"], t["compute_dtype"], plain=False)
        out["control"] = judge.gaps(
            judge.outputs(refmod, cfg, ref_tree, reqs, kept, low, device),
            ref_out, kept.n[kept.rows], hop)
        out["control_correct"] = all(v <= limits[k]
                                     for k, v in out["control"].items())
    out["correct"] = all(checks[k] <= limits[k] for k in limits) and \
        set(limits) == set(checks)
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": limits.get(k)} for k, v in checks.items()}

    if trace:
        metrics = {}
        readers = layout.metrics(root)
        for name in layout.cell_metrics(cell["name"], root):
            m = readers[name]
            v = m.read(obs)
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": v, "unit": m.UNIT}
    else:
        metrics = {"audio_s_per_s": {"value": audio_s / window_s,
                                     "unit": "audio-s/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    out["metrics"] = metrics
    out["device"] = device_info
    out["obs"] = obs
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = layout.cell(args.workload)
    try:
        res = run(cell, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"t2s_bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"t2s_bench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    checks = res.pop("checks")
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
