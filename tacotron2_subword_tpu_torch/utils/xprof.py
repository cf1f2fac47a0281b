"""Device time from a ``torch.profiler`` trace: the port's counterpart of
the JAX package's ``utils/xprof.py``, which reads an xplane.pb.

A trace taken with ``torch.profiler.profile(activities=[..., CUDA])``
holds one record per device activity: each kernel, memcpy and memset,
with its start and duration on the card's clock (CUPTI); the kernels of
a CUDA-graph replay too, under their own names.  On the H100 (torch
2.11, CUDA 12.8) records are lost at the start of a trace: in a process
that has run the training CLI, the first device record of every trace,
and late in chip_smoke.py's run more of them (34-43 of 60 eager
launches, up to 109 of a 112,302-record window, and a marker launched
50 ms after the first record).
``device_profile`` therefore starts every trace with ``LEAD_KERNELS``
sentinel kernels (``torch.cuda._sleep``) that take those losses, awaited,
and leaves ``GUARD_S`` of idle time on either side of the traced work;
``marked_window`` lets a caller check a trace of identical calls, each
between two ``mark()`` kernels, for lost records (``bench.py`` retraces a
window whose calls disagree).  Exact launch counts still come from the
kernel wrappers' counters.  Shared by ``bench.py`` (the busy-time
headline) and the measurement tools (``tools/train_step_profile.py``,
``tools/serving_latency.py``).

The card has no 'XLA Modules' span, so two clocks stand in for it:

- **busy**: the union of the device intervals, the time in which at least
  one kernel, copy or set ran.  Intervals that overlap (the prefetch
  thread's copies beside a kernel, NCCL beside compute) count once: a sum
  of durations would count them twice.
- **span**: from the first device start to the last device end, idle gaps
  included.

busy <= span, both on the profiler's clock; span <= the host's wall time
around the traced work (when that work ends in a synchronize) up to the
two clocks' disagreement, which put 2.3-3.4 s spans 0.08-0.23 % past
their walls on the H100.  ``busy / wall`` is the device-busy share.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, List, NamedTuple, Tuple

Row = Tuple[str, float, float]   # (name, start_us, dur_us)


class DeviceProfile(NamedTuple):
    ops: List[Tuple[str, float, int]]   # (name, total_ms, n_events), ms desc
    busy_ms: float                      # union of the device intervals
    span_ms: float                      # first start to last end
    n_events: int                       # device activities (launches)


SENTINEL = "spin_kernel"   # torch.cuda._sleep's kernel
LEAD_KERNELS = 1024        # sentinels that start a trace
GUARD_S = 0.05             # idle host time on either side of a trace
MARK_CYCLES = 1000         # the spin of a sentinel or a marker


@contextlib.contextmanager
def device_profile():
    """A ``torch.profiler.profile`` of the CUDA activity alone: the host's
    ops are not traced, so the traced work runs close to its untraced
    speed and the trace holds only what this module reads.  LEAD_KERNELS
    sentinel kernels (``torch.cuda._sleep``) run and are awaited first,
    and the host idles ``GUARD_S`` before the body and after it (behind a
    synchronize), so that the records the profiler loses at the start of
    a trace are the sentinels'; ``device_rows`` leaves their rows out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(GUARD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(GUARD_S)


def mark() -> None:
    """A marker kernel on the current stream (the sentinel's): inside
    ``device_profile``, ``marked_window`` splits the trace at it."""
    import torch
    torch.cuda._sleep(MARK_CYCLES)


def summarize_rows(rows: Iterable[Row]) -> DeviceProfile:
    """Per-name totals, busy time (the union of the intervals) and span of
    plain ``(name, start_us, dur_us)`` rows."""
    agg = {}
    intervals = []
    for name, start, dur in rows:
        ms, n = agg.get(name, (0.0, 0))
        agg[name] = (ms + dur / 1e3, n + 1)
        intervals.append((start, start + dur))
    if not intervals:
        return DeviceProfile([], 0.0, 0.0, 0)
    intervals.sort()
    busy_us = 0.0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    span_us = max(e for _, e in intervals) - intervals[0][0]
    ops = sorted(((k, v[0], v[1]) for k, v in agg.items()),
                 key=lambda t: -t[1])
    return DeviceProfile(ops, busy_us / 1e3, span_us / 1e3, len(intervals))


def device_rows(prof, markers: bool = False) -> List[Row]:
    """The CUDA activities (kernels, memcpy, memset) of a stopped
    ``torch.profiler.profile`` as ``(name, start_us, dur_us)`` rows.  Read
    from the raw kineto records, so PyTorch's per-op event tree is never
    built; user annotations (``record_function`` ranges mirrored on the
    device timeline) are not device work and are left out, as are the
    sentinel's and the markers' rows unless ``markers``."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or (not markers and SENTINEL in e.name())):
            continue
        rows.append((e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3))
    return rows


def marked_window(rows: Iterable[Row], n: int
                  ) -> Tuple[List[int], List[Row]]:
    """(records per call, the window's rows) of a trace whose last n + 1
    sentinel or marker rows, in time order, bound n calls (a ``mark()``
    before the first call and after each; ``device_rows(prof,
    markers=True)``): the number of rows between each two consecutive of
    those markers, and every row from the first of them on, the markers
    left out.  ([], []) if the trace holds fewer than n + 1 markers.  n
    identical calls give n equal counts unless records were lost."""
    rows = sorted(rows, key=lambda r: r[1])
    at = [i for i, r in enumerate(rows) if SENTINEL in r[0]]
    if len(at) < n + 1:
        return [], []
    at = at[-(n + 1):]
    return ([b - a - 1 for a, b in zip(at, at[1:])],
            [r for r in rows[at[0]:] if SENTINEL not in r[0]])


def profile_summary(prof) -> DeviceProfile:
    """``summarize_rows`` of a stopped profile's device activities."""
    return summarize_rows(device_rows(prof))


def parse_profile_ops(prof) -> Tuple[List[Tuple[str, float, int]], float]:
    """([(kernel_name, total_ms, n_events)] sorted by ms desc, busy_ms):
    the counterpart of the JAX package's ``parse_xplane_ops``."""
    s = profile_summary(prof)
    return s.ops, s.busy_ms


def device_busy_ms(prof) -> float:
    """Device busy milliseconds of the trace (the union of its device
    intervals): the counterpart of ``device_module_ms``."""
    return profile_summary(prof).busy_ms
