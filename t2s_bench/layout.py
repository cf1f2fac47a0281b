"""Where the benchmark finds each of its parts, by the name that
``BENCHMARK.json`` gives it.  Adding a cell, a traffic mix or a per-layer
metric is adding a file; so is adding a configuration, with its vocoder
part, system adapter and reference where they are new: no file here
changes for it.  A new attention is the exception: its weights are drawn
by ``weights.tacotron_specs``, which knows SMA and LSA alone.

    workloads/<cell>.json     config, traffic, chips, why, limits
    configs/<config>.json     the model's sizes, precision, source, the
                              system adapter and the reference that run it,
                              and ``vocoder``: the name of its vocoder part,
                              whose sizes it keeps under the same key
    traffic/<mix>.json        a traffic mix: its generator's name and
                              parameters
    traffic/<generator>.py    a traffic generator (``make(params, seed, cfg)``)
    vocoders/<name>.py        a vocoder part: ``specs(group)``, its weights'
                              leaves ("gen.*", as ``weights.Spec``), and
                              ``frame_flops(group)``, its work a mel frame
    system/<name>.py          the adapter that drives the program
    system/<name>_trace.py    the program's own spans and counters, where
                              the adapter has them: ``enable``,
                              ``disable`` and ``take``, which the traced
                              run turns on over its window and profiled
                              batch
    reference/<name>.py       the plain reference of a configuration, with
                              ``vocode`` (see ``judge``)
    metrics/<metric>.py       one per-layer metric: its declaration and
                              ``read(obs)``

The cells that report a per-layer metric are listed once, in the
metric's entry in ``BENCHMARK.json`` (the folder's parent), so a new cell
joins a metric by that entry, not by an edit of the metric's reader.

A reader's ``obs`` (``run.run``, traced run) holds the cell's whole
``config`` (and its ``tacotron`` group), the window's ``window_s``,
``audio_s``, ``steps``, ``batches`` ((mel lengths, steps run) a batch),
``flops``, ``peak_bytes``, the outside ``spans``' seconds by label; the
profiled batch's ``trace`` (None without a card: ``segments``, ``steps``,
``wall_s``, ``busy_s``, ``batch`` and ``frames``, its mel lengths); and
``program``, the program's own record (None where the system adapter has
no ``_trace`` file): ``window`` and ``profiled``, each (spans, counters),
the profiled batch's ``attribution`` (``attribution.attribute``), its host
CUDA ``calls`` and ``wall_s``, as ``attribution.METRICS`` reads them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent

METRIC_FIELDS = ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def module_from(path: Path) -> ModuleType:
    """Import the Python file ``path`` as a fresh module."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"t2s_bench_part_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, root: Path = ROOT) -> dict:
    return _json(root / "workloads" / f"{name}.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def generator(name: str, root: Path = ROOT) -> ModuleType:
    return module_from(root / "traffic" / f"{name}.py")


def vocoder(name: str, root: Path = ROOT) -> ModuleType:
    return module_from(root / "vocoders" / f"{name}.py")


def system(name: str, root: Path = ROOT) -> ModuleType:
    return module_from(root / "system" / f"{name}.py")


def system_trace(name: str, root: Path = ROOT) -> Optional[ModuleType]:
    """The tracing file of system adapter ``name``, or None where it has
    none."""
    path = root / "system" / f"{name}_trace.py"
    return module_from(path) if path.is_file() else None


def reference(name: str, root: Path = ROOT) -> ModuleType:
    return module_from(root / "reference" / f"{name}.py")


def metrics(root: Path = ROOT) -> Dict[str, ModuleType]:
    """Every per-layer metric, by name (the file's name without ``.py``).
    A file that lacks one of METRIC_FIELDS or ``read`` raises."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        mod = module_from(path)
        missing = [f for f in (*METRIC_FIELDS, "read") if not hasattr(mod, f)]
        if missing:
            raise ValueError(f"{path}: missing {missing}")
        out[path.name[:-3]] = mod
    return out


def manifest(root: Path = ROOT) -> dict:
    """``BENCHMARK.json``, in the folder's parent (the checkout's root)."""
    return _json(root.parent / "BENCHMARK.json")


def cell_metrics(name: str, root: Path = ROOT) -> list:
    """The per-layer metrics that cell ``name`` reports: those whose
    entry lists it, or has no ``workloads`` key."""
    return [m["name"] for m in manifest(root)["per_layer"]
            if name in m.get("workloads", [name])]


def cell(name: str, root: Path = ROOT) -> dict:
    """A cell with its parts resolved: ``workload``, ``config``, ``mix``."""
    wl = workload(name, root)
    return {"name": name, "workload": wl, "config": config(wl["config"], root),
            "mix": traffic(wl["traffic"], root)}
