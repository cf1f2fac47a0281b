"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference imports nothing of the program; only the system adapter
does."""

from __future__ import annotations

import ast
from pathlib import Path

from t2s_bench import layout, run as R

BENCH = Path(__file__).resolve().parent.parent
PORT = "tacotron2_subword_tpu_torch"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in R.FORBIDDEN, (f, name)


def test_only_the_system_adapter_imports_the_program():
    for f in sorted(BENCH.rglob("*.py")):
        if f.parent.name in ("system", "tests"):
            continue
        for name in _imports(f):
            assert name.split(".")[0] != PORT, (f, name)


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, PORT + "_fake", types.ModuleType("x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tacotron2_subword_tpu.config",
                        types.ModuleType("x"))
    assert R.forbidden_modules() == ["tacotron2_subword_tpu.config"]


def test_a_run_loads_none(bench_copy):
    R.run(layout.cell("tiny", bench_copy), 5, 0.0, False, device="cpu",
          root=bench_copy)
    assert R.forbidden_modules() == []
