"""Builds the g++-emulated CUDA sources of ``tests/cuda_emu`` for the CPU
tests (``tests/test_torch_kernel_emulation.py``, ``tests/test_torch_large_p.py``)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def compile_harness(tmp_path_factory, source, shared=False):
    """``tests/cuda_emu/<source>`` built with the host C++ compiler: an
    executable, or (``shared``) a shared library. Skips without one."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler")
    name = source.removesuffix(".cpp")
    out = tmp_path_factory.mktemp("cuda_emu") / (f"lib{name}.so" if shared else name)
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", *(["-shared", "-fPIC"] if shared else []),
         f"-I{EMU}", f"-I{CSRC}", "-o", str(out), str(EMU / source)],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    return out


def large_p_library(tmp_path_factory):
    """``csrc/large_p.cu`` as an emulated shared library, typed for
    ``repro_torch.kernels.large_p.Runner``."""
    from repro_torch.kernels import large_p

    lib = ctypes.CDLL(str(compile_harness(tmp_path_factory, "large_p_harness.cpp",
                                          shared=True)))
    large_p.type_library(lib)
    return lib
