"""The port's CUDA kernels, run on the CPU, against their plain version.

No ``nvcc`` is needed: ``tests/cuda_emu/harness.cpp`` compiles
``src/repro_torch/kernels/csrc/fused_step.cu`` with the host C++ compiler
against ``tests/cuda_emu/cuda_runtime.h``, which runs each block as 256
threads with ``std::barrier`` for ``__syncthreads``. That checks the
kernels' indexing, edge masking, barriers and in-place aliasing at small
shapes; the card checks them again (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Tolerance: atol 3e-5 / rtol 1e-4, the tiled-kernel
tolerance of ``tests/test_fused_step.py`` (fp32 sums in another order).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
TOL = dict(atol=3e-5, rtol=1e-4)
KINDS = {"none": 0, "trace": 1, "vadam": 2}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler")
    out = tmp_path_factory.mktemp("cuda_emu") / "harness"
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", f"-I{EMU}", f"-I{CSRC}",
         "-o", str(out), str(EMU / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    return out


def _run(harness, tmp_path, kind, shape, base_kind, hyper, tile_n=0,
         inplace=False, pv=None, seed=0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    nu = np.abs(rng.standard_normal(b))
    if pv is not None:
        rows = np.arange(p)[None, :, None] < np.asarray(pv)[:, None, None]
        x, g, mu = (np.where(rows, a, 0.0) for a in (x, g, mu))
    x, g, mu, nu = (np.ascontiguousarray(a, np.float32) for a in (x, g, mu, nu))
    count = torch.tensor(3, dtype=torch.int32)
    scal = tfs.pack_scal(0.1, 0.5, base_kind=base_kind, hyper=hyper,
                         post_scale=1.0, count=count, device="cpu")
    pv_arr = np.asarray(pv if pv is not None else [p] * b, np.float32)
    for name, a in (("x", x), ("g", g), ("mu", mu), ("nu", nu),
                    ("scal", scal.numpy()), ("pv", pv_arr)):
        a.astype(np.float32).tofile(tmp_path / f"{name}.bin")
    nesterov = int(base_kind == "trace" and hyper[1])
    subprocess.run(
        [str(harness), str(tmp_path), str(kind), str(b), str(p), str(n),
         str(KINDS[base_kind]), str(nesterov), str(tile_n), str(int(inplace)),
         str(int(pv is not None))],
        check=True, timeout=120,
    )
    t = torch.from_numpy
    want = tref.fused_group_step_ref(
        t(x), t(g), 0.1, method="pogo", lam=0.5, base_kind=base_kind,
        hyper=hyper, mu=t(mu) if base_kind != "none" else None,
        nu=t(nu) if base_kind == "vadam" else None, count=count,
        pv=None if pv is None else torch.tensor(pv, dtype=torch.int32),
    )
    for name, w in zip(("x_out", "mu_out", "nu_out", "dist"), want[:4]):
        if w is None:
            continue
        got = np.fromfile(tmp_path / f"{name}.bin", np.float32).reshape(w.shape)
        np.testing.assert_allclose(got, w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("shape,base_kind,hyper", [
    ((2, 16, 256), "trace", (0.9, False)),
    ((2, 10, 250), "vadam", (0.9, 0.999, 1e-8)),
    ((3, 1, 33), "none", ()),
    ((2, 5, 40), "trace", (0.5, True)),
    ((1, 64, 300), "trace", (0.9, False)),  # M written in five passes
    ((2, 12, 400), "vadam", (0.9, 0.999, 1e-8)),  # 85 column-quads a pass
    ((2, 32, 200), "trace", (0.9, False)),  # grams split 4 ways over k
])
def test_whole_kernel_emulated(harness, tmp_path, shape, base_kind, hyper):
    _run(harness, tmp_path, 0, shape, base_kind, hyper)


@pytest.mark.parametrize("shape,tile_n,base_kind,hyper", [
    ((2, 64, 960), 64, "trace", (0.9, False)),
    ((1, 64, 300), 32, "trace", (0.9, True)),  # SmolLM's p, the planner's tile
    ((2, 64, 200), 64, "vadam", (0.9, 0.999, 1e-8)),
    ((2, 10, 250), 32, "none", ()),
    ((2, 10, 250), 32, "trace", (0.5, True)),
    ((1, 70, 150), 32, "trace", (0.9, False)),
    ((2, 7, 33), 32, "vadam", (0.9, 0.999, 1e-8)),
])
def test_tiled_kernel_emulated(harness, tmp_path, shape, tile_n, base_kind, hyper):
    _run(harness, tmp_path, 1, shape, base_kind, hyper, tile_n=tile_n)


@pytest.mark.parametrize("kind,tile_n", [(0, 0), (1, 32)])
def test_kernels_emulated_in_place_ragged(harness, tmp_path, kind, tile_n):
    """X' over X, mu' over mu, nu' over nu, with zero-padded rows masked
    per matrix (pv)."""
    _run(harness, tmp_path, kind, (4, 8, 200), "vadam", (0.9, 0.999, 1e-8),
         tile_n=tile_n, inplace=True, pv=[8, 5, 1, 0])

