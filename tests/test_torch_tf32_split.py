"""How many TF32 pieces the tensor-core fused step needs, on the CPU.

``benchmarks_torch/tf32_split_readings.py`` runs the plain fused POGO step
over VAdam with its products in emulated TF32 (operands read with their
low 13 bits dropped, as the tensor cores read fp32 values) against the
same step in fp32, at SmolLM-360M's q/k width (p, n) = (64, 960). The
kernel's 3xTF32 split (hi truncated, as the tensor cores read x itself)
must keep one step within the tiled kernels'
tolerance (atol 3e-5 / rtol 1e-4, ``tests/test_fused_step.py:95``) and the
distance within the trainer's 1e-5 feasibility bound over 10 steps; one
TF32 product (a kernel that lost its lo pieces) must fail one of the two,
so that these checks can see the split.
"""

import importlib.util
import pathlib

import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks_torch" / \
    "tf32_split_readings.py"


@pytest.fixture(scope="module")
def readings():
    spec = importlib.util.spec_from_file_location("tf32_split_readings", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.readings(batch=4, p=64, n=960, steps=10, seed=0, device="cpu")


@pytest.mark.parametrize("mode", ["3xTF32", "3xTF32 trunc"])
def test_three_tf32_pieces_keep_fp32_results(readings, mode):
    """Both splits: hi rounded, and (the kernel's) hi truncated as the
    tensor cores read x itself."""
    r = readings[mode]
    assert r["within_tol"], r
    assert r["dist_after"] <= 1e-5 and r["true_dist_after"] <= 1e-5, r


@pytest.mark.parametrize("mode", ["1xTF32", "2xTF32"])
def test_fewer_pieces_fail_the_checks(readings, mode):
    r = readings[mode]
    assert not (r["within_tol"] and r["dist_after"] <= 1e-5
                and r["true_dist_after"] <= 1e-5), r


def test_fp32_control_passes(readings):
    """The script's own step in fp32 is the reference's to rounding."""
    r = readings["fp32"]
    assert r["within_tol"] and r["max_abs"] < 1e-6 and r["dist_after"] <= 1e-5, r
