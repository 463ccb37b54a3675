"""Build the port's CUDA sources at first use (counterpart of
``deepspeed_tpu/ops/op_builder.py``, which builds host ops with g++).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/`` at the root of
the checkout, and loads with ``ctypes``. A library's file name carries a
hash of its source and flags, so an edited source rebuilds. Several
sources build in parallel: one ``nvcc`` each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..utils.logging import log_dist

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from PyTorch's CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of deepspeed_tpu_torch need the CUDA "
                       "toolkit to build")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` process per source, all at once. Returns the seconds each
    build took (0.0 when it was already built); the compiler's output,
    register and shared-memory use included, goes to ``<lib>.log``."""
    todo = {n: library_path(n) for n in names
            if not library_path(n).exists()}
    seconds = dict.fromkeys(names, 0.0)
    if not todo:
        return seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, str(CSRC / f"{name}.cu"), "-o", str(tmp)]
        log_dist(f"[op_builder] building {name}: {' '.join(cmd)}")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        lib = todo[name]
        lib.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and ``dlopen`` the library of ``csrc/<name>.cu``."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
