"""Hand-written CUDA kernels of the port, built at first use.

Each kernel's source lives in ``csrc/`` and is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library is
written under ``_build/`` (git-ignored), named by the source's content hash,
so it is rebuilt exactly when the source changes. Nothing here runs at import
time: the CPU tests import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of the builds made
# by this process, keyed by source name
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every ``csrc/<source>`` that has no library of the same
    content hash yet, all ``nvcc`` processes started together; returns
    ``{source: library path}``. Raises with the compiler's output if any
    build fails; on success ``BUILD_LOG[source]`` keeps ptxas's register
    report."""
    paths = {src: library_path(src) for src in sources}
    jobs = {}
    for src, out in paths.items():
        if os.path.isfile(out) or src in jobs:
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, os.path.join(CSRC, src)]
        jobs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    failed = []
    for src, (tmp, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {src}:\n{stdout}\n{stderr}")
            continue
        BUILD_LOG[src] = (stdout + stderr).strip()
        os.replace(tmp, paths[src])  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(source: str) -> str:
    """``build_all([source])[source]``."""
    return build_all([source])[source]


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(build(source))
        _LIBS[source] = lib
    return lib
