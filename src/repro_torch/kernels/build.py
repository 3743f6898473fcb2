"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles, at first use, into a shared library with
a plain C interface under ``<checkout>/build/repro_torch/`` (``nvcc
-gencode arch=compute_90a,code=sm_90a -O3 -shared``), named by a hash of
its source and the shared ``csrc/*.cuh`` headers, so an edited kernel
never loads a stale build. The library is
loaded with ``ctypes``; nothing here includes PyTorch's headers, so a
build takes seconds. Kernels are IEEE fp32: no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
PTXAS_LOG: dict[str, str] = {}  # source name -> nvcc -Xptxas -v output


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the port's kernels"
    )


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into its hashed shared library (no-op if
    that build exists) and return its path. Safe to run for several
    sources at once, one process each."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(ARCH_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the sources' shared blocks
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (rc {res.returncode}):\n{res.stderr}"
        )
    out.with_suffix(".ptxas.txt").write_text(res.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = compile_source(name)
            log = path.with_suffix(".ptxas.txt")
            PTXAS_LOG[name] = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
