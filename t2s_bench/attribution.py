"""Device work and device idle put down to the program's own spans, and
the per-layer metrics that read the program's spans and counters.

A profiled stretch gives device rows (kernels, copies, sets) and, for each,
its launch record: the CUDA runtime or driver call that the trace holds
under the same correlation id, stamped on the host on the clock of the
program's spans (Unix-epoch ns).  Then:

- a device row belongs to the innermost program span that was open when
  the row was launched (``OUTSIDE`` where none was: the harness);
- an idle gap (from the end of every earlier row to the start of the next)
  belongs to the span in which the host launched the row that ends it.  It
  is host-bound when it is longer than ``QUEUED_GAP_NS``: a row that waited
  in the device's queue starts right after the one before it, so a longer
  gap means the host launched the row after the device had gone idle.
  Shorter gaps are launch latency.

The host-bound test reads the device's clock alone.  Comparing a launch
record with the previous row's end would need the two clocks to agree,
and in the H100's traces (torch 2.11) they do not: a gap-ending row's
device start less its launch record drifts by 5-20 us within one traced
batch, and by up to 12 ms in some lsa batches (``program_trace``'s
``gap_leads``).  Launch records and spans are both host stamps, which
agree within 2 us (the clock test).

A row without a launch record is taken as launched at its device start
less ``LATENCY_NS`` (route "device_start"); with every row matched the
route is "launch", which is what the H100's CUDA-only traces give (a
``cudaLaunchKernel``, ``cuLaunchKernelEx`` or ``cudaMemcpyAsync`` record
for every row).

Spans are (name, parent index or None, start_ns, end_ns) and counters a
dict, as ``system/<adapter>_trace.take`` returns them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from t2s_bench.frozen import xprof

OUTSIDE = "outside"
# on an H100 80GB HBM3 at 700 W: a lone kernel's device start less its
# launch record, median of 20 in the clock test (test_shared_clock_on_card,
# min 6.5 us); a traced batch's idle gaps fall into queued ones, most of
# 1-3 us, and host-late ones, most of 6 us or more, with the fewest at
# 3-6 us in both cells (``program_trace``'s ``gaps``)
LATENCY_NS = 7_060
QUEUED_GAP_NS = 4_000
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
DECODE_LOOP, DECODE_SYNC = "decode.loop", "decode.sync"


class Row(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    corr: int


class Attribution(NamedTuple):
    rows: List[Row]                   # by device start
    launch_ns: List[int]              # per row
    span: List[Optional[int]]         # per row: innermost open span
    host_bound_s: Dict[str, float]    # idle, by the label of its span
    latency_s: Dict[str, float]
    matched: float                    # share of rows with a launch record
    route: str


def _is_launch(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCH_KINDS
    return e.name().startswith("cu")


def records(prof, skip: str = xprof.SENTINEL):
    """(device rows, {correlation id: launch start ns}, host calls) of a
    stopped ``torch.profiler`` profile, from its raw kineto records: rows
    whose name holds ``skip`` (the harness's sentinels and markers) left
    out; host calls are every CUDA runtime or driver call as a Row."""
    from torch.autograd import DeviceType
    rows, launches, calls = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (skip and skip in e.name()):
                rows.append(Row(e.name(), start, start + e.duration_ns(),
                                e.correlation_id()))
        elif _is_launch(e):
            launches[e.correlation_id()] = start
            calls.append(Row(e.name(), start, start + e.duration_ns(),
                             e.correlation_id()))
    return rows, launches, calls


def host_calls(calls: Sequence[Row], spans, top: int = 12):
    """The host's CUDA runtime and driver calls by (span open at the call,
    call name): [span, name, calls, seconds], the ``top`` longest."""
    agg: Dict[tuple, list] = defaultdict(lambda: [0, 0])
    for c, s in zip(calls, innermost([c.start_ns for c in calls], spans)):
        a = agg[(label(spans, s), c.name)]
        a[0] += 1
        a[1] += c.end_ns - c.start_ns
    out = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [[k[0], k[1], n, ns / 1e9] for k, (n, ns) in out]


def innermost(times: Sequence[int], spans) -> List[Optional[int]]:
    """Per time, the index of the innermost span open at it, or None."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][2])
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]][2] <= t:
            s = order[j]
            while stack and spans[stack[-1]][3] < spans[s][2]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and spans[stack[-1]][3] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def label(spans, i: Optional[int]) -> str:
    return OUTSIDE if i is None else spans[i][0]


def attribute(rows: Sequence[Row], launches: Dict[int, int], spans,
              offset_ns: int = LATENCY_NS) -> Attribution:
    rows = sorted(rows, key=lambda r: r.start_ns)
    at = [launches.get(r.corr) for r in rows]
    matched = sum(a is not None for a in at) / len(rows) if rows else 0.0
    at = [r.start_ns - offset_ns if a is None else a
          for r, a in zip(rows, at)]
    span = innermost(at, spans)
    host: Dict[str, float] = defaultdict(float)
    lat: Dict[str, float] = defaultdict(float)
    end = rows[0].end_ns if rows else 0
    for r, s in zip(rows[1:], span[1:]):
        gap = r.start_ns - end
        if gap > 0:
            (host if gap > QUEUED_GAP_NS else lat)[label(spans, s)] += \
                gap / 1e9
        end = max(end, r.end_ns)
    return Attribution(rows, at, span, dict(host), dict(lat), matched,
                       "launch" if matched == 1.0 else "device_start")


def within(spans, i: Optional[int], name: str) -> bool:
    """Whether span ``i`` is ``name`` or lies inside a span of that name."""
    while i is not None:
        if spans[i][0] == name:
            return True
        i = spans[i][1]
    return False


def busy_ns(rows: Sequence[Row]) -> int:
    """The union of the rows' device intervals."""
    total, cur_s, cur_e = 0, None, None
    for r in sorted(rows, key=lambda r: r.start_ns):
        if cur_e is None or r.start_ns > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = r.start_ns, r.end_ns
        else:
            cur_e = max(cur_e, r.end_ns)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def span_ns(spans, name: str) -> int:
    return sum(e - s for n, _, s, e in spans if n == name)


# -- the per-layer metrics -------------------------------------------------
#
# ``obs``: "window" and "profiled", each (spans, counters) or None: the
# program's record over the timed window and over the profiled batch;
# "attribution" (of the profiled batch, or None) and "wall_s" (its host
# wall time).

class Metric(NamedTuple):
    layer: str
    unit: str
    better: str
    source: str
    read: Callable[[dict], Optional[float]]


def _ratio(num: float, den: float, scale: float) -> Optional[float]:
    return scale * num / den if den else None


def decode_host_us_per_step(obs):
    """The host's own time in the decode loop per step: the loop's spans
    less its sync reads, over the steps run, in the window."""
    if not obs.get("window"):
        return None
    spans, c = obs["window"]
    return _ratio(span_ns(spans, DECODE_LOOP) - span_ns(spans, DECODE_SYNC),
                  c.get("decode.steps", 0), 1e-3)


def decode_device_us_per_step(obs):
    """The device's time on the rows launched inside the decode loop (the
    union of their intervals) per step, in the profiled batch."""
    a, prof = obs.get("attribution"), obs.get("profiled")
    if not a or not prof:
        return None
    spans, c = prof
    rows = [r for r, s in zip(a.rows, a.span)
            if within(spans, s, DECODE_LOOP)]
    return _ratio(busy_ns(rows), c.get("decode.steps", 0), 1e-3) \
        if rows else None


def decode_live_share(obs):
    """Row-steps up to each row's stop over all row-steps run, in the
    window."""
    if not obs.get("window"):
        return None
    c = obs["window"][1]
    return _ratio(c.get("decode.live_row_steps", 0),
                  c.get("decode.row_steps", 0), 100.0)


def vocoder_live_share(obs):
    """Vocoder frames kept (max(n, 8) a row) over the frames vocoded, the
    padding included, in the window."""
    if not obs.get("window"):
        return None
    c = obs["window"][1]
    return _ratio(c.get("vocoder.frames_live", 0),
                  c.get("vocoder.frames_run", 0), 100.0)


def host_bound_idle_share(obs):
    """Idle gaps longer than a queued row's (the host launched the row
    that ends them after the device had gone idle), over the profiled
    batch's wall time."""
    a = obs.get("attribution")
    if not a or not obs.get("wall_s"):
        return None
    return _ratio(sum(a.host_bound_s.values()), obs["wall_s"], 100.0)


METRICS: Dict[str, Metric] = {
    "decode_host_us_per_step.synth": Metric(
        "decode loop", "us/step", "lower", "program_span",
        decode_host_us_per_step),
    "decode_device_us_per_step.synth": Metric(
        "decode loop", "us/step", "lower", "device_trace",
        decode_device_us_per_step),
    "decode_live_share.synth": Metric(
        "decode loop", "%", "higher", "program_counter", decode_live_share),
    "vocoder_live_share.synth": Metric(
        "vocoder", "%", "higher", "program_counter", vocoder_live_share),
    "host_bound_idle_share.synth": Metric(
        "device", "%", "lower", "device_trace", host_bound_idle_share),
}
