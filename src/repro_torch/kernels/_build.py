"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``*/csrc/*.cu`` under this package becomes one shared library with a
plain C interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the repository root. A library is named by a
hash of its source and flags, so an unchanged source is built once and a
changed one is rebuilt. All missing libraries are built together, one
``nvcc`` each, started at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(_PKG.glob("*/csrc/*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or put "
                           "nvcc on PATH); the CUDA kernels cannot be built")
    return nvcc


def build_all() -> dict[str, Path]:
    """Build every source whose library is missing; -> name -> library.

    Raises with nvcc's output if any build fails. The compiler's
    ``-Xptxas -v`` report is kept beside each library (``build_log``).
    """
    targets = {name: _target(src) for name, src in sources().items()}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            target = todo[name]
            target.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, target)  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("repro_torch: nvcc failed for\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source ``name`` (built if needed)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return _loaded[name]


def build_log(name: str) -> str:
    """nvcc's output (with the ``-Xptxas -v`` report) for kernel ``name``."""
    return _target(sources()[name]).with_suffix(".log").read_text()
