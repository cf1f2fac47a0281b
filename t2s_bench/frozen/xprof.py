"""Frozen copy of the trace reading of ``tacotron2_subword_tpu_torch/utils/xprof.py``
at commit 8e462dd: ``device_profile`` (lead sentinels and idle guards against
the records CUPTI loses at the start of a trace), ``mark``, ``device_rows``
(the raw kineto records, no event tree) and ``summarize_rows`` (busy = the
union of the kernel, copy and set intervals).  The benchmark keeps its own
copy so that a change to the program cannot change how it is measured.

``mark`` takes a label here: the caller keeps the labels in launch order and
matches them to the marker rows of the trace (``split_by_marks``).
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
    """A ``torch.profiler.profile`` of the CUDA activity alone, led by
    LEAD_KERNELS awaited sentinel kernels and GUARD_S of host idle time on
    either side of the body, so that the records lost at the start of a
    trace are the sentinels'."""
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
    """A marker kernel (the sentinel's) on the current stream."""
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
    """The CUDA activities (kernels, memcpy, memset) of a stopped profile as
    ``(name, start_us, dur_us)`` rows, read from the raw kineto records;
    user annotations are left out, and the sentinel's and markers' rows
    unless ``markers``."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or (not markers and SENTINEL in e.name())):
            continue
        rows.append((e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3))
    return rows
