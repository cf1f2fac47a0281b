"""Spans placed from outside the program, around the module functions that
its serving entry calls, and the reading of one profiled stretch.

A span waits for the device on entry and on exit, so its host time is the
layer's whole time.  Inside a profiled stretch each span boundary also
launches a marker kernel; the labels, kept in launch order, name the
stretches of the device trace between the markers (``segments``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from t2s_bench.frozen import xprof

HARNESS = "harness"         # device work after the serving entry returns


class Spans:
    def __init__(self, targets, sync):
        """``targets``: (module, function name, label) triples."""
        self.total: Dict[str, float] = defaultdict(float)
        self.marks: Optional[List[Tuple[str, bool]]] = None
        self._sync = sync
        self._stack: List[str] = []
        self._restore = []
        for mod, name, label in targets:
            real = getattr(mod, name)
            setattr(mod, name, self._wrap(real, label))
            self._restore.append((mod, name, real))

    def _mark(self, label: str, enter: bool) -> None:
        if self.marks is not None:
            xprof.mark()
            self.marks.append((label, enter))

    def _wrap(self, real, label):
        def span(*args, **kwargs):
            self._sync()
            self._mark(label, True)
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self._sync()
                self.total[label] += time.perf_counter() - t0
                self._mark(label, False)
        return span

    def close(self) -> None:
        for mod, name, real in reversed(self._restore):
            setattr(mod, name, real)
        self._restore = []


def segments(rows, marks: List[Tuple[str, bool]], batch_label: str
             ) -> Optional[List[Tuple[str, List[xprof.Row]]]]:
    """The device rows of a profiled stretch cut at its markers: (label of
    the innermost open span, rows) per stretch between two markers, in
    time order.  ``marks`` are (label, entered) in launch order, the first
    and last the stretch's own bounds.  None if markers were lost."""
    rows = sorted(rows, key=lambda r: r[1])
    at = [i for i, r in enumerate(rows) if xprof.SENTINEL in r[0]]
    if len(at) < len(marks):
        return None
    at = at[-len(marks):]
    out, stack = [], []
    for (label, enter), a, b in zip(marks, at, at[1:]):
        if enter:
            stack.append(label)
        elif stack and stack[-1] == label:
            stack.pop()
        here = stack[-1] if stack else batch_label
        out.append((here, rows[a + 1:b]))
    return out


def idle_gaps(segs) -> Dict[str, float]:
    """Idle device seconds by the span that was open, between the first
    and the last row of the stretch."""
    flat = [(s, e, label) for label, rs in segs
            for _, s, d in rs for e in (s + d,)]
    flat.sort()
    idle: Dict[str, float] = defaultdict(float)
    if not flat:
        return idle
    end = flat[0][1]
    for s, e, label in flat[1:]:
        if s > end:
            idle[label] += (s - end) / 1e6
        end = max(end, e)
    return idle


def sync_of(device) -> callable:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
