"""Build the hand-written CUDA kernels from the package's own sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a plain-C
shared library that is loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds rather than minutes). Libraries land in
``fastdm_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of
the sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded. Building happens at first use, never at import: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rmsnorm", "rope", "qk_norm_rope", "flash_attn", "quant",
           "w8a8_gemm", "fp8_gemm", "gelu_mul", "int4_pack", "w4a4_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one nvcc process
    per source, all started together. Returns {name: ptxas report} for the
    sources compiled by this call; raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = library_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, dst)
    reports, failed = {}, []
    for name, (proc, tmp, dst) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{output}")
            continue
        os.replace(tmp, dst)  # atomic: a concurrent process never loads half a file
        reports[name] = output
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(output)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
