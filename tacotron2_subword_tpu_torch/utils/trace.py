"""Spans and counters inside the port's serving path.

    from tacotron2_subword_tpu_torch.utils import trace

    with trace.span("decode.loop"):
        ...
    trace.count("decode.steps", n)

    trace.enable()
    ...                       # serve batches
    rec = trace.take()        # Trace(spans, counters) since the last take
    trace.disable()

Off (the default), ``span`` returns one shared no-op object and ``count``
returns at once: nothing is allocated and no clock is read.  On, each span
records its name, the index of its parent span in the same record (the
span open around it, or None) and its start and end in ns on the Unix-epoch
clock (``time.time_ns``), the clock that ``torch.profiler`` stamps its host
records with, so a span can be laid beside the launch records of a trace.
The serving path runs on one thread, so nesting follows a stack.

No span or counter reads anything back from the device: a span measures
the host's time in its code.  The device's time per span comes from a
device trace, by the span open when each kernel was launched.

``take`` also reports the kernel wrappers' launch counters
(``ops.quant.launches``, ``ops.softdtw.grad_launches`` and
``fwd_launches``) as ``k1.launches``, ``k2.launches`` and ``k3.launches``:
the launches made while tracing was on (counted from its reset where a
caller reset one in between).  They are read, not counted a second time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    parent: Optional[int]     # index of the enclosing span in the record
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class _Off:
    """The span of tracing off: one object, entered and left at no cost."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()

_on = False
_spans: List[list] = []      # [name, parent, start_ns, end_ns]
_stack: List[int] = []       # indices of the open spans
_counts: Dict[str, int] = defaultdict(int)
_launch_base: Dict[str, int] = {}


class _On:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = len(_spans)
        _spans.append([self.name, _stack[-1] if _stack else None,
                       time.time_ns(), None])
        _stack.append(self.index)
        return self

    def __exit__(self, *exc):
        _spans[self.index][3] = time.time_ns()
        _stack.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` around its body while
    tracing is on."""
    if not _on:
        return OFF
    return _On(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _on:
        _counts[name] += n


def enabled() -> bool:
    """Whether tracing is on: a caller tests it before reckoning a count."""
    return _on


def _launches() -> Dict[str, int]:
    from tacotron2_subword_tpu_torch.ops import quant, softdtw
    return {"k1.launches": quant.launches,
            "k2.launches": softdtw.grad_launches,
            "k3.launches": softdtw.fwd_launches}


def _read_launches() -> None:
    """Add the launches since the last read to the counters."""
    now = _launches()
    for k, v in now.items():
        base = _launch_base[k]
        _counts[k] += v - base if v >= base else v
    _launch_base.update(now)


def enable() -> None:
    """Turn tracing on; the launch counters are read from here on."""
    global _on
    if not _on:
        _launch_base.update(_launches())
    _on = True


def disable() -> None:
    """Turn tracing off.  What was recorded stays until ``take``."""
    global _on
    if _on:
        _read_launches()
    _on = False


def take() -> Trace:
    """The spans and counters recorded since the last ``take``, cleared.
    Raises while a span is open: its record is not finished."""
    if _stack:
        raise RuntimeError(f"take() inside the open span "
                           f"{_spans[_stack[-1]][0]!r}")
    if _on:
        _read_launches()
    out = Trace([Span(*s) for s in _spans], dict(_counts))
    _spans.clear()
    _counts.clear()
    return out
