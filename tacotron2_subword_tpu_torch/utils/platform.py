"""Device selection and the step profiler of the port's entry points."""

from __future__ import annotations

import os
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" when None.  Raises when CUDA is
    asked for and absent: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


class StepProfiler:
    """``torch.profiler`` trace of the steps [start_step, start_step +
    num_steps) (the JAX package's xprof ``StepProfiler``): CPU and, where
    there is a card, CUDA activities, one ``ProfilerStep#n`` span per step,
    written as a Chrome trace ``trace_steps_{first}-{last}.json`` into
    ``logdir``.  ``step(iteration)`` is called before each step; ``close``
    ends a trace still open."""

    def __init__(self, logdir: Optional[str], start_step: int = 5,
                 num_steps: int = 3):
        self.logdir = logdir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None
        self._span = None
        self._last = start_step
        self.path: Optional[str] = None

    def step(self, iteration: int) -> None:
        if not self.logdir:
            return
        if iteration == self.start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif self._prof is None:
            return
        self._end_span()
        if iteration >= self.stop:
            self.close()
            return
        self._span = torch.profiler.record_function(
            f"ProfilerStep#{iteration}")
        self._last = iteration
        self._span.__enter__()

    def _end_span(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def close(self) -> None:
        if self._prof is None:
            return
        self._end_span()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"trace_steps_{self.start}-{self._last}.json")
        prof.export_chrome_trace(self.path)
        print(f"profiler trace written to {self.path}", flush=True)
