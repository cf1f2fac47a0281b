"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_kbuild/lib<name>-<hash>.so`` for ``sm_90a`` (Hopper), at first use.
The hash covers the source, every ``*.cu``/``*.cuh`` under ``csrc/`` that
it may include, and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded from the build directory.  ``build`` starts
one ``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module of the
port on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_kbuild"
KERNELS = ("dequant_int8_matmul", "softdtw", "conv_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    cand = Path(home) / "bin" / "nvcc" if home else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _lib_path(name: str, csrc: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((csrc / f"{name}.cu").read_bytes())
    for f in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.
    Returns each kernel's ptxas report (registers, shared memory, spills),
    kept beside the library as ``.log`` for a kernel that was already
    built.  Raises if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, reports = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def ptx(name: str) -> str:
    """The PTX of kernel ``name`` (``nvcc -ptx`` with the build's target,
    language standard and optimisation), to show which instructions it
    asks of the card."""
    arch = NVCC_FLAGS[1].split(",")[0]          # arch=compute_90a
    flags = ["-gencode", f"{arch},code={arch.split('=')[1]}", "-std=c++17",
             "-O3"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.{os.getpid()}.ptx"
    proc = subprocess.run([_nvcc(), *flags, "-ptx", "-o", str(out),
                           str(CSRC_DIR / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -ptx {name}: exit {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    try:
        return out.read_text()
    finally:
        out.unlink()


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.t2s_cuda_error_string.argtypes = [ctypes.c_int]
        lib.t2s_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.t2s_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
