"""The program's own tracing, beside the ``synthesize`` adapter: pass-throughs
to ``tacotron2_subword_tpu_torch.utils.trace``, whose spans and counters
the serving entry records while it is on.  ``t2s_bench.program_trace``
loads this file by the configuration's ``system`` name plus ``_trace``.

A program without that module raises ImportError here on the first call.
"""

from __future__ import annotations


def _trace():
    from tacotron2_subword_tpu_torch.utils import trace
    return trace


def enable() -> None:
    _trace().enable()


def disable() -> None:
    _trace().disable()


def take():
    """(spans, counters) recorded since the last take: spans as (name,
    parent index or None, start_ns, end_ns) on the Unix-epoch clock."""
    rec = _trace().take()
    return [tuple(s) for s in rec.spans], dict(rec.counters)
