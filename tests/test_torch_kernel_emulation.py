"""The port's CUDA kernels, run on the CPU, against their plain version.

No ``nvcc`` is needed: ``tests/cuda_emu/harness.cpp`` (POGO) and
``landing_harness.cpp`` (Landing), ``two_stage_harness.cpp``,
``ns_harness.cpp`` and ``tp_harness.cpp`` compile
``src/repro_torch/kernels/csrc/fused_step.cu``, ``two_stage.cu``,
``newton_schulz.cu`` and ``newton_schulz_tc.cu``, ``tp_step.cu`` and
(``flash_harness.cpp``) ``flash_attention.cu`` (fp32 at hd % 4 != 0),
``flash_attention_tc.cu`` (bf16) and ``flash_attention_tf32.cu`` (fp32,
3xTF32), (``tc_harness.cpp``)
``fused_step_tc.cu``, its fused step and its two-stage entries, and
(``large_p_harness.cpp``, a shared library that the wrappers' own phases
drive through ``kernels/large_p.py``) ``large_p.cu``, with
the host C++ compiler against ``tests/cuda_emu/cuda_runtime.h``, which
runs each block as threads (256, or the launch's count) with
``std::barrier`` for ``__syncthreads`` (the blocks of a thread block
cluster at once, each with its own shared memory), and
``tests/cuda_emu/hopper.cuh``,
scalar stand-ins of the TMA loads, mbarriers and ``wgmma`` products that
follow the PTX ISA's fragment layouts and 128-byte swizzle, and of the
cluster's barrier and distributed shared memory (a TF32
product reads its fp32 operands with the low 13 bits dropped, so a
3xTF32 kernel that lost its lo pieces fails here too). That checks
the kernels' indexing, edge masking, barriers, pipelines and in-place
aliasing at small shapes; the card checks them again
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). Tolerance: atol
3e-5 / rtol 1e-4 for the fused kernels, the tiled-kernel tolerance of
``tests/test_fused_step.py``; for the two-stage kernels the tolerances of
``tests/test_kernels.py``, atol 1e-6 / rtol 1e-6 whole and 2e-5 / 1e-4
tiled (fp32 sums in another order); for the TP kernels the fused tiled
tolerance, with rtol 1e-4 covering the payload's sum of squares (a sum of
p n squares in another order). The tensor-core fused step takes the
tiled tolerance (3xTF32 products are within ~2^-21 of fp32's), its
two-stage entries the two-stage tiled one; the large route's entries
take their tiled counterparts' (Newton-Schulz its own). The
flash-attention kernels take
``tests/test_flash_kernel.py``'s fp32 tolerance, atol 2e-5 / rtol 1e-4
(the 3xTF32 one against JAX's kernel in interpret mode too, where that
kernel is right), and in bf16 one output ulp (both sides round an fp32
result once).
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import compile_harness as _compile
from _cuda_emu import large_p_library

from repro.core import stiefel as jst
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import landing_field as tlf
from repro_torch.kernels import large_p as tlp
from repro_torch.kernels import newton_schulz as tns
from repro_torch.kernels import pogo_update as tpu
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tp_step as ttp

TOL = dict(atol=3e-5, rtol=1e-4)
KINDS = {"none": 0, "trace": 1, "vadam": 2}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return _compile(tmp_path_factory, "harness.cpp")


@pytest.fixture(scope="module")
def two_stage_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "two_stage_harness.cpp")


@pytest.fixture(scope="module")
def landing_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "landing_harness.cpp")


def _run(harness, tmp_path, kind, shape, base_kind, hyper, tile_n=0,
         inplace=False, pv=None, seed=0, method="pogo", tc=False):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2)
    if method == "landing":  # off the manifold: lam (A X - X) is visible
        x = x + 0.01 * rng.standard_normal(shape)
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
    if tc:  # tc_harness: METHOD B P N BASE NESTEROV INPLACE HAS_PV
        args = [str(int(method == "landing")), str(b), str(p), str(n),
                str(KINDS[base_kind]), str(nesterov), str(int(inplace)),
                str(int(pv is not None))]
    else:
        args = [str(kind), str(b), str(p), str(n), str(KINDS[base_kind]),
                str(nesterov), str(tile_n), str(int(inplace)), str(int(pv is not None))]
    res = subprocess.run([str(harness), str(tmp_path), *args], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    t = torch.from_numpy
    want = tref.fused_group_step_ref(
        t(x), t(g), 0.1, method=method, lam=0.5, base_kind=base_kind,
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
    ((1, 128, 150), 16, "trace", (0.9, False)),  # internlm2-1.8b's p, the planner's tile
])
def test_tiled_kernel_emulated(harness, tmp_path, shape, tile_n, base_kind, hyper):
    _run(harness, tmp_path, 1, shape, base_kind, hyper, tile_n=tile_n)


@pytest.mark.parametrize("kind,tile_n", [(0, 0), (1, 32)])
def test_kernels_emulated_in_place_ragged(harness, tmp_path, kind, tile_n):
    """X' over X, mu' over mu, nu' over nu, with zero-padded rows masked
    per matrix (pv)."""
    _run(harness, tmp_path, kind, (4, 8, 200), "vadam", (0.9, 0.999, 1e-8),
         tile_n=tile_n, inplace=True, pv=[8, 5, 1, 0])


@pytest.mark.parametrize("shape,base_kind,hyper", [
    ((2, 16, 256), "trace", (0.9, False)),
    ((2, 10, 250), "vadam", (0.9, 0.999, 1e-8)),
    ((3, 1, 33), "none", ()),
    ((2, 5, 40), "trace", (0.5, True)),
    ((1, 64, 300), "trace", (0.9, False)),  # X' written in five passes
    ((2, 32, 200), "vadam", (0.9, 0.999, 1e-8)),  # grams split 4 ways over k
])
def test_landing_whole_kernel_emulated(landing_harness, tmp_path, shape, base_kind,
                                       hyper):
    _run(landing_harness, tmp_path, 0, shape, base_kind, hyper, method="landing")


@pytest.mark.parametrize("shape,tile_n,base_kind,hyper", [
    ((2, 64, 960), 32, "trace", (0.9, False)),  # SmolLM's (p, n), planned tile
    ((1, 64, 300), 64, "trace", (0.9, True)),
    ((2, 64, 200), 32, "vadam", (0.9, 0.999, 1e-8)),
    ((2, 10, 250), 32, "none", ()),
    ((1, 70, 150), 32, "trace", (0.9, False)),
    ((2, 7, 33), 32, "vadam", (0.9, 0.999, 1e-8)),
    ((1, 128, 150), 16, "vadam", (0.9, 0.999, 1e-8)),  # internlm2-1.8b's p, tile 16
])
def test_landing_tiled_kernel_emulated(landing_harness, tmp_path, shape, tile_n,
                                       base_kind, hyper):
    _run(landing_harness, tmp_path, 1, shape, base_kind, hyper, tile_n=tile_n,
         method="landing")


@pytest.mark.parametrize("kind,tile_n", [(0, 0), (1, 32)], ids=["whole", "tiled"])
def test_landing_kernels_emulated_in_place_ragged(landing_harness, tmp_path, kind,
                                                  tile_n):
    """X' over X (the tiled kernel writes each tile after reading it), mu'
    over mu, nu' over nu, with zero-padded rows masked per matrix."""
    _run(landing_harness, tmp_path, kind, (4, 8, 200), "vadam", (0.9, 0.999, 1e-8),
         tile_n=tile_n, inplace=True, pv=[8, 5, 1, 0], method="landing")


@pytest.fixture(scope="module")
def tc_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "tc_harness.cpp")


# The tiled kernels' shapes: SmolLM's (64, 960) in 15 chunks (the stage
# ring reused across sweeps); n = 300 and 200 through TMA with a ragged last
# chunk; n = 250 and 33 (n % 4 != 0) through the producer's plain loads;
# p = 10 and 7 padded to the 64-row tile. Two emulated SMs, so a block
# walks several matrices when B > 2. The wide kernel (64 < p <= 128):
# internlm2-1.8b's p = 128 with nesterov through TMA (n = 200: a ragged last
# chunk), p = 72 through plain loads, p = 100 with no base.
TC_CASES = [
    ((2, 64, 960), "trace", (0.9, False)),
    ((1, 64, 300), "trace", (0.9, True)),
    ((2, 64, 200), "vadam", (0.9, 0.999, 1e-8)),
    ((2, 10, 250), "none", ()),
    ((2, 7, 33), "vadam", (0.9, 0.999, 1e-8)),
    ((3, 128, 200), "trace", (0.9, True)),
    ((3, 72, 250), "vadam", (0.9, 0.999, 1e-8)),
    ((2, 100, 200), "none", ()),
]


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("shape,base_kind,hyper", TC_CASES)
def test_tc_kernel_emulated(tc_harness, tmp_path, method, shape, base_kind, hyper):
    _run(tc_harness, tmp_path, 0, shape, base_kind, hyper, method=method, tc=True)


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("n", [200, 250], ids=["tma", "plain_loads"])
def test_tc_kernel_emulated_in_place_ragged(tc_harness, tmp_path, method, n):
    """X' over X (POGO parks M there between sweeps 2 and 3), mu' over mu,
    nu' over nu, zero-padded rows masked per matrix (pv), five matrices on
    two blocks."""
    _run(tc_harness, tmp_path, 0, (5, 8, n), "vadam", (0.9, 0.999, 1e-8),
         inplace=True, pv=[8, 5, 1, 0, 8], method=method, tc=True)


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("n", [200, 250], ids=["tma", "plain_loads"])
def test_tc_wide_kernel_emulated_in_place_ragged(tc_harness, tmp_path, method, n):
    """The wide kernel in place: M's rows 0..63 parked in the scratch while
    X's rows are still the K side of sweep 2's second pass, X' over X, mu'
    over mu, nu' over nu; ragged pv (one matrix with none); three matrices
    on two blocks, so a block reuses its park."""
    _run(tc_harness, tmp_path, 0, (3, 100, n), "vadam", (0.9, 0.999, 1e-8),
         inplace=True, pv=[100, 70, 0], method=method, tc=True)


def _run_two_stage(harness, tmp_path, kind, method, shape, tile_n=0,
                   inplace=False, seed=0):
    """One two-stage kernel through the emulator against its plain version."""
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    x, g = (np.ascontiguousarray(a, np.float32) for a in (x, g))
    for name, a in (("x", x), ("g", g), ("scal", np.array([0.1, 0.5], np.float32))):
        a.tofile(tmp_path / f"{name}.bin")
    subprocess.run(
        [str(harness), str(tmp_path), str(kind), str(method), str(b), str(p),
         str(n), str(tile_n), str(int(inplace))],
        check=True, timeout=120,
    )
    t = torch.from_numpy
    if method == 0:
        want = tref.pogo_update_ref(t(x), t(g), 0.1, 0.5)
    else:
        want = tref.landing_field_ref(t(x), t(g), 0.5)
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(shape)
    tol = dict(atol=1e-6, rtol=1e-6) if kind == 0 else dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want.numpy(), **tol)


@pytest.mark.parametrize("method", [0, 1], ids=["pogo_update", "landing_field"])
@pytest.mark.parametrize("shape", [
    (2, 16, 256),  # the many-matrices shape, fewer of them
    (2, 10, 250),  # ragged n
    (3, 1, 33),
    (1, 64, 300),  # M written over X in five passes
    (2, 32, 200),  # grams split 4 ways over k
])
def test_two_stage_whole_kernels_emulated(two_stage_harness, tmp_path, method, shape):
    _run_two_stage(two_stage_harness, tmp_path, 0, method, shape)


@pytest.mark.parametrize("method", [0, 1], ids=["pogo_update", "landing_field"])
@pytest.mark.parametrize("shape,tile_n", [
    ((2, 64, 960), 32),  # SmolLM's (p, n), POGO's planned tile
    ((1, 64, 960), 64),  # the field's planned tile
    ((2, 10, 250), 32),  # ragged last tile
    ((1, 70, 150), 32),
    ((2, 7, 33), 32),
    ((1, 128, 150), 16),  # internlm2-1.8b's p, POGO's planned tile
])
def test_two_stage_tiled_kernels_emulated(two_stage_harness, tmp_path, method,
                                          shape, tile_n):
    _run_two_stage(two_stage_harness, tmp_path, 1, method, shape, tile_n=tile_n)


@pytest.mark.parametrize("kind,tile_n", [(0, 0), (1, 32)], ids=["whole", "tiled"])
@pytest.mark.parametrize("method", [0, 1], ids=["pogo_update", "landing_field"])
def test_two_stage_kernels_emulated_in_place(two_stage_harness, tmp_path, kind,
                                             tile_n, method):
    """The output written over X: the whole kernels read all of X first;
    the tiled POGO kernel parks M in the output (here X) tile by tile and
    writes X' over it, and the field writes each tile after reading it."""
    _run_two_stage(two_stage_harness, tmp_path, kind, method, (3, 12, 130),
                   tile_n=tile_n, inplace=True)


def _run_two_stage_tc(harness, tmp_path, method, shape, inplace=False, seed=0):
    """``pogo_update_tc`` (method 0) or ``landing_field_tc`` (1) through
    the tensor-core harness against the plain version, at the two-stage
    tiled tolerance."""
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    x, g = (np.ascontiguousarray(a, np.float32) for a in (x, g))
    scal = np.array([0.1, 0.5, 1.0, 0, 0, 0, 0, 0], np.float32)
    for name, a in (("x", x), ("g", g), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    res = subprocess.run(
        [str(harness), str(tmp_path), str(2 + method), str(b), str(p), str(n), "0", "0",
         str(int(inplace)), "0"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    t = torch.from_numpy
    if method == 0:
        want = tref.pogo_update_ref(t(x), t(g), 0.1, 0.5)
    else:
        want = tref.landing_field_ref(t(x), t(g), 0.5)
    got = np.fromfile(tmp_path / "x_out.bin", np.float32).reshape(shape)
    np.testing.assert_allclose(got, want.numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("method", [0, 1], ids=["pogo_update", "landing_field"])
@pytest.mark.parametrize("shape", [
    (2, 64, 960),  # SmolLM's (p, n): 15 chunks, the ring reused across sweeps
    (1, 64, 300),  # TMA with a ragged last chunk
    (2, 10, 250),  # n % 4 != 0: the producer's plain loads
    (2, 7, 33),
])
def test_two_stage_tc_kernels_emulated(tc_harness, tmp_path, method, shape):
    _run_two_stage_tc(tc_harness, tmp_path, method, shape)


@pytest.mark.parametrize("n", [200, 250], ids=["tma", "plain_loads"])
def test_two_stage_tc_pogo_emulated_in_place(tc_harness, tmp_path, n):
    """X' over X: M is parked in X's place between sweeps 2 and 3; five
    matrices on two blocks."""
    _run_two_stage_tc(tc_harness, tmp_path, 0, (5, 8, n), inplace=True)


@pytest.mark.parametrize("shape,inplace", [
    ((3, 128, 200), False),  # internlm2-1.8b's p, TMA, a ragged last chunk
    ((2, 72, 250), False),  # the producer's plain loads
    ((3, 100, 200), True),  # X' over X, M's rows 0..63 parked meanwhile
])
def test_two_stage_tc_wide_pogo_emulated(tc_harness, tmp_path, shape, inplace):
    """``pogo_update_tc`` at 64 < p <= 128: the wide kernel's two-stage
    instance (no base stage, no telemetry)."""
    _run_two_stage_tc(tc_harness, tmp_path, 0, shape, inplace=inplace)


@pytest.mark.parametrize("p", [72, 100, 128])
@pytest.mark.parametrize("n", [300, 250], ids=["tma", "plain_loads"])
def test_two_stage_tc_wide_field_emulated(tc_harness, tmp_path, p, n):
    """``landing_field_tc`` at 64 < p <= 128: the wide kernel's field
    instance (sweep 1 and both passes of sweep 2, Lambda's halves straight
    to the output, the second half's blocks of A and B kept in the park);
    two or three matrices on two blocks, a ragged last chunk."""
    _run_two_stage_tc(tc_harness, tmp_path, 1, (3 if n == 300 else 2, p, n))


@pytest.fixture(scope="module")
def ns_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "ns_harness.cpp")


def _run_ns(harness, tmp_path, kind, shape, tile_n=0, inplace=False,
            masked=False, iters=4, seed=0, against_jax=False):
    """One Newton-Schulz kernel through the emulator against the plain
    version, at 1.5 x Stiefel + 0.05 randn (the watchdog's drift), with the
    odd matrices masked off when ``masked``. Masked-off matrices and their
    distances must come out bit for bit as they went in. Four iterations:
    enough to run the tiled kernel's gram swap twice over; the card holds
    the kernels at 12 (``tests/test_torch_gpu.py``). With ``against_jax``
    the masked-in matrices and distances are also held, at the same
    tolerance, against the JAX package's ``ops.newton_schulz`` (its Pallas
    kernel in interpret mode where it plans one) and
    ``stiefel.manifold_distance``."""
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = 1.5 * np.swapaxes(q, -1, -2) + 0.05 * rng.standard_normal(shape)
    x = np.ascontiguousarray(x, np.float32)
    dist = rng.uniform(1.0, 2.0, b).astype(np.float32)
    mask = (np.arange(b) % 2 == 0) if masked else np.ones(b, bool)
    for name, a in (("x", x), ("dist", dist), ("mask", mask.astype(np.float32))):
        a.tofile(tmp_path / f"{name}.bin")
    subprocess.run(
        [str(harness), str(tmp_path), str(kind), str(b), str(p), str(n),
         str(iters), str(tile_n), str(int(inplace)), str(int(masked))],
        check=True, timeout=120,
    )
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(shape)
    got_d = np.fromfile(tmp_path / "dist_out.bin", np.float32)
    want = tref.newton_schulz_ref(torch.from_numpy(x), iters)
    want_d = tref.manifold_distance_ref(want).numpy()
    on = mask
    np.testing.assert_allclose(got[on], want.numpy()[on], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_d[on], want_d[on], atol=1e-5, rtol=1e-3)
    if against_jax:
        jx = jops.newton_schulz(jnp.asarray(x), iters=iters, interpret=True)
        np.testing.assert_allclose(got[on], np.asarray(jx)[on], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got_d[on], np.asarray(jst.manifold_distance(jx))[on],
                                   atol=1e-5, rtol=1e-3)
    if masked:
        if inplace:
            np.testing.assert_array_equal(got[~on], x[~on])
        np.testing.assert_array_equal(got_d[~on], dist[~on])


@pytest.mark.parametrize("shape", [(2, 16, 256), (2, 10, 250), (2, 1, 33),
                                   (1, 64, 124)])
def test_ns_whole_kernel_emulated(ns_harness, tmp_path, shape):
    _run_ns(ns_harness, tmp_path, 0, shape)


@pytest.mark.parametrize("shape,tile_n", [((1, 64, 300), 64), ((2, 10, 250), 32),
                                          ((1, 70, 150), 32), ((2, 7, 33), 32)])
def test_ns_tiled_kernel_emulated(ns_harness, tmp_path, shape, tile_n):
    _run_ns(ns_harness, tmp_path, 1, shape, tile_n=tile_n)


@pytest.mark.parametrize("kind,tile_n", [(0, 0), (1, 64)], ids=["whole", "tiled"])
def test_ns_kernels_emulated_in_place_with_mask(ns_harness, tmp_path, kind, tile_n):
    """The watchdog's repair: in place over the stack, every other matrix
    masked off (untouched, bit for bit, distance too)."""
    _run_ns(ns_harness, tmp_path, kind, (4, 12, 130), tile_n=tile_n,
            inplace=True, masked=True)


@pytest.mark.parametrize("shape,inplace,masked", [
    ((3, 64, 960), True, True),  # the trainer's (p, n): a cluster of two CTAs
    ((2, 40, 300), False, False),  # ragged p and n in one CTA's chunks
    ((2, 40, 301), True, True),  # n % 4 != 0: scalar loads and stores
    ((4, 48, 1500), True, True),  # a cluster of four, a ragged last chunk
    ((1, 64, 4600), False, False),  # a cluster of eight
])
def test_ns_tc_kernel_emulated(ns_harness, tmp_path, shape, inplace, masked):
    """``newton_schulz_tc`` through its launcher, each cluster's CTAs at
    once (their partial grams meet through the stand-in's distributed
    shared memory), at the Newton-Schulz tolerance; masked-off matrices and
    distances bit-unchanged."""
    _run_ns(ns_harness, tmp_path, 2, shape, inplace=inplace, masked=masked)


@pytest.mark.parametrize("shape,inplace,masked,iters", [
    # internlm2-1.8b's (p, n): 16 CTAs a matrix, the watchdog's 12 iterations
    ((3, 128, 2048), True, True, 12),
    ((3, 72, 300), False, False, 4),  # ragged p and n, a cluster of four
    ((4, 100, 301), True, True, 4),  # n % 4 != 0: scalar loads and stores
    ((5, 128, 520), True, True, 4),  # five matrices walked by two clusters of 8
    # a cluster of two, one CTA without a chunk (p <= 64 runs too)
    ((3, 40, 60), False, False, 4),
])
def test_ns_tc128_kernel_emulated(ns_harness, tmp_path, shape, inplace, masked, iters):
    """``newton_schulz_tc128`` through its launcher: a persistent grid of
    the stand-in's two resident clusters, each cluster's CTAs at once, the
    gram reduce-scattered and gathered through the stand-in's distributed
    shared memory; at the Newton-Schulz tolerance, masked-off matrices and
    distances bit-unchanged; against the JAX package's Newton-Schulz too."""
    _run_ns(ns_harness, tmp_path, 3, shape, inplace=inplace, masked=masked, iters=iters,
            against_jax=True)


@pytest.fixture(scope="module")
def tp_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "tp_harness.cpp")


def _tp_call(harness, tmp_path, mode, shape, k, base_kind, hyper, method, tile_n,
             has_scl, has_pv, inplace):
    b, p, n = shape
    nesterov = int(base_kind == "trace" and hyper[1])
    subprocess.run(
        [str(harness), str(tmp_path), str(mode), str(b), str(p), str(n), str(k),
         str(KINDS[base_kind]), str(nesterov), str(int(method == "landing")),
         str(tile_n), str(int(has_scl)), str(int(has_pv)), str(int(inplace))],
        check=True, timeout=120,
    )


def _run_tp(harness, tmp_path, shape, base_kind, hyper, method, tile_n,
            post_scale=1.0, pv=None, inplace=False, seed=0):
    """``tp_gram`` on the shard's columns against ``ref.tp_partial_ref``,
    then ``tp_apply`` on that payload (a one-shard all-reduce) against
    ``ref.tp_apply_ref``, with vadam's scalar from ``ref.tp_scale_ref``."""
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    x, g, mu = (np.ascontiguousarray(a, np.float32) for a in (x, g, mu))
    t = torch.from_numpy
    scal = ttp.tp_scal(base_kind, hyper, post_scale, eta=0.1, lam=0.5).numpy()
    for name, a in (("x", x), ("g", g), ("mu", mu), ("scal", scal)):
        a.tofile(tmp_path / f"{name}.bin")
    k = tref.tp_payload_width(p, base_kind)
    _tp_call(harness, tmp_path, 0, shape, k, base_kind, hyper, method, tile_n, False,
             False, inplace)
    pay, gb, mu2 = tref.tp_partial_ref(t(x), t(g), base_kind=base_kind, hyper=hyper,
                                       post_scale=post_scale,
                                       mu=t(mu) if base_kind != "none" else None)
    for name, w in (("payload", pay), ("gb", gb), ("mu_out", mu2)):
        if w is None:
            continue
        got = np.fromfile(tmp_path / f"{name}.bin", np.float32).reshape(w.shape)
        np.testing.assert_allclose(got, w.numpy(), err_msg=name, **TOL)
    scl = None
    if base_kind == "vadam":
        nu = torch.from_numpy(np.abs(rng.standard_normal(b)).astype(np.float32))
        scl, _ = tref.tp_scale_ref(pay, p, hyper=hyper, post_scale=post_scale, nu=nu,
                                   count=torch.tensor(3))
        scl.numpy().tofile(tmp_path / "scl.bin")
    pv_arr = np.asarray(pv if pv is not None else [p] * b, np.float32)
    pv_arr.tofile(tmp_path / "pv.bin")
    gb.numpy().tofile(tmp_path / "gb.bin")
    pay.numpy().tofile(tmp_path / "payload.bin")
    _tp_call(harness, tmp_path, 1, shape, k, base_kind, hyper, method, tile_n,
             scl is not None, pv is not None, inplace)
    x2, dist = tref.tp_apply_ref(t(x), gb, pay, 0.1, scl, method=method, lam=0.5,
                                 pv=None if pv is None else torch.tensor(pv))
    got = np.fromfile(tmp_path / "x_out.bin", np.float32).reshape(shape)
    np.testing.assert_allclose(got, x2.numpy(), err_msg="x_out", **TOL)
    got_d = np.fromfile(tmp_path / "dist.bin", np.float32)
    np.testing.assert_allclose(got_d, dist.numpy(), err_msg="dist", **TOL)


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("shape,tile_n,base_kind,hyper,post_scale", [
    ((2, 16, 128), 64, "trace", (0.9, False), 1.0),  # many matrices' shard at width 2
    ((1, 64, 240), 32, "vadam", (0.9, 0.999, 1e-8), 0.7),  # SmolLM's shard at width 4
    ((2, 10, 250), 32, "none", (), 1.5),  # ragged last tile, 250 % 4 != 0
    ((2, 7, 33), 64, "trace", (0.5, True), 1.0),  # one partial tile
])
def test_tp_kernels_emulated(tp_harness, tmp_path, method, shape, tile_n, base_kind,
                             hyper, post_scale):
    _run_tp(tp_harness, tmp_path, shape, base_kind, hyper, method, tile_n,
            post_scale=post_scale)


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_tp_kernels_emulated_in_place_ragged(tp_harness, tmp_path, method):
    """mu' over mu (``tp_gram``), X' over X (``tp_apply``), zero-padded rows
    masked per matrix in the distance."""
    _run_tp(tp_harness, tmp_path, (4, 8, 100), "vadam", (0.9, 0.999, 1e-8), method,
            32, pv=[8, 5, 1, 0], inplace=True)


@pytest.fixture(scope="module")
def flash_harness(tmp_path_factory):
    return _compile(tmp_path_factory, "flash_harness.cpp")


@pytest.mark.parametrize("shape,sk,causal,window,bf16", [
    ((1, 100, 2, 1, 40), 100, True, None, False),     # unaligned, GQA group 2
    ((1, 130, 3, 1, 40), 130, False, None, False),    # non-causal, group 3
    ((2, 150, 4, 2, 32), 150, True, 40, False),       # window across tiles
    ((1, 80, 1, 1, 128), 80, True, 16, False),        # two output chunks
    ((1, 50, 2, 1, 24), 90, False, None, False),      # more keys than queries
    # bf16: the tensor-core kernel
    ((1, 70, 2, 2, 64), 70, True, None, True),        # one tile
    ((1, 300, 2, 1, 128), 300, True, None, True),     # hd 128: two boxes, N = 128
    ((1, 50, 2, 1, 24), 90, False, None, True),       # hd 24 in one zero-filled box, Sk > Sq
    ((1, 333, 3, 1, 40), 333, True, 100, True),       # window across tiles, group 3
    ((1, 200, 2, 2, 32), 400, False, 60, True),       # Sk > Sq, windowed, non-causal
    ((1, 600, 2, 1, 64), 600, True, None, True),      # five tiles: the stage ring reused
    ((1, 130, 2, 1, 5), 130, True, None, True),       # hd 5, rows padded to 8
])
def test_flash_kernel_emulated(flash_harness, tmp_path, shape, sk, causal, window,
                               bf16):
    b, s, h, kvh, hd = shape
    rng = np.random.default_rng(s)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dt)
               for sh in ((b, s, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        t.float().numpy().tofile(tmp_path / f"{name}.bin")
    res = subprocess.run(
        [str(flash_harness), str(tmp_path), str(int(bf16)), str(b), str(s), str(sk),
         str(h), str(kvh), str(hd), str(int(causal)), str(window or 0),
         repr(float(hd**-0.5))], capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(b, s, h, hd)
    want = tfa.run_plain(q, k, v, causal=causal, window=window).float().numpy()
    if bf16:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1 / 64)
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


TF32_FLASH_CASES = [  # (B, S, H, KV, hd), Sk, causal, window, against the JAX kernel
    ((1, 70, 2, 2, 64), 70, True, None, True),       # one tile
    ((1, 300, 2, 1, 128), 300, True, None, True),    # hd 128: four boxes, 32-key tiles, N = 128
    ((1, 50, 2, 1, 24), 90, False, None, False),     # hd 24 in one zero-filled box, Sk > Sq
    ((1, 333, 3, 1, 40), 333, True, 100, True),      # window across tiles, group 3
    ((1, 200, 2, 2, 32), 400, False, 60, False),     # Sk > Sq, windowed, non-causal
    ((1, 600, 2, 1, 64), 600, True, None, True),     # ten tiles: the stage ring reused
    ((1, 128, 2, 1, 32), 256, False, None, True),    # non-causal, block-aligned keys
]


@pytest.mark.parametrize("shape,sk,causal,window,against_jax", TF32_FLASH_CASES)
def test_flash_tf32_kernel_emulated(flash_harness, tmp_path, shape, sk, causal, window,
                                    against_jax):
    """``flash_attention_tf32.cu`` through its launcher (tensor maps, grid
    and block as on the card; the emulator's TF32 products drop each
    operand's low 13 bits) against the plain version at the fp32 flash
    tolerance, and, where the JAX kernel is right (causal, or the keys a
    whole number of its blocks: its wrapper masks with the padded key
    length), against ``repro.kernels.ops.flash_attention`` in interpret mode
    at the same tolerance."""
    b, s, h, kvh, hd = shape
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)))
    for name, a in (("q", q), ("k", k), ("v", v)):
        a.tofile(tmp_path / f"{name}.bin")
    res = subprocess.run(
        [str(flash_harness), str(tmp_path), "2", str(b), str(s), str(sk), str(h), str(kvh),
         str(hd), str(int(causal)), str(window or 0), repr(float(hd**-0.5))],
        capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    got = np.fromfile(tmp_path / "out.bin", np.float32).reshape(b, s, h, hd)
    t = torch.from_numpy
    want = tfa.run_plain(t(q), t(k), t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    if against_jax:
        jax_out = np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
            block_q=128, block_k=128, interpret=True))
        np.testing.assert_allclose(got, jax_out, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------- large p
#
# large_p.cu built as a shared library (large_p_harness.cpp) and driven
# through the wrappers' own phases (kernels/large_p.py) with a Runner on
# CPU tensors: the launchers, the grid, the n-slices and their fixed-order
# sum, the scratch buffers and the in-place paths all run as on the card.
# Emulated blocks run one after another, so a block that wrote over an
# operand another block still reads would show as a wrong answer. p = 136
# and 130 leave a ragged last 64-row tile; n = 200 a ragged last chunk;
# n = 201 (n % 4 != 0) the scalar loads; 64 emulated SMs split n = 256
# into slices of 64 columns.


@pytest.fixture(scope="module")
def large_lib(tmp_path_factory):
    return large_p_library(tmp_path_factory)


def _large_operands(shape, seed, off_manifold=0.0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + off_manifold * rng.standard_normal(shape)
    arrs = (x, 0.2 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape),
            np.abs(rng.standard_normal(b)))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrs]


LARGE_CASES = [  # (shape, base, hyper, emulated SMs, CUDA launches: POGO, Landing)
    ((2, 136, 200), "vadam", (0.9, 0.999, 1e-8), 2, (4, 3)),
    ((1, 130, 201), "trace", (0.5, True), 2, (4, 3)),
    ((2, 136, 256), "trace", (0.9, False), 64, (6, 5)),  # both grams in 4 n-slices
]


@pytest.mark.parametrize("method", ["pogo", "landing"])
@pytest.mark.parametrize("shape,base_kind,hyper,sms,launches", LARGE_CASES)
def test_large_fused_step_emulated(large_lib, method, shape, base_kind, hyper, sms,
                                   launches):
    """``fused_step_large`` against ``ref.fused_group_step_ref`` at the
    fused tiled tolerance."""
    run = tlp.Runner(large_lib, None, sms, min_slice=64)
    x, g, mu, nu = _large_operands(shape, 0, 0.01 if method == "landing" else 0.0)
    kw = dict(method=method, lam=1.0 if method == "landing" else 0.5,
              base_kind=base_kind, hyper=hyper, mu=mu, nu=nu if base_kind == "vadam" else None,
              count=torch.tensor(3, dtype=torch.int32))
    got = tfs.fused_step_large(x, g, 0.1, runner=run, **kw)
    assert run.launches == launches[method == "landing"]
    want = tref.fused_group_step_ref(x, g, 0.1, **kw)
    for name, a, w in zip(("x", "mu", "nu", "dist"), got[:4], want[:4]):
        if w is not None:
            np.testing.assert_allclose(a.numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_large_fused_step_emulated_in_place_ragged(large_lib, method):
    """X', mu' and nu' over X, mu and nu, zero-padded rows masked per
    matrix (pv), one matrix with none."""
    shape = (4, 136, 150)
    x, g, mu, nu = _large_operands(shape, 1)
    pv = [136, 70, 1, 0]
    rows = np.arange(136)[None, :, None] < np.asarray(pv)[:, None, None]
    x, g, mu = (torch.where(torch.from_numpy(rows), a, 0.0) for a in (x, g, mu))
    kw = dict(method=method, lam=0.5, base_kind="vadam", hyper=(0.9, 0.999, 1e-8), mu=mu,
              nu=nu, count=torch.tensor(3, dtype=torch.int32),
              pv=torch.tensor(pv, dtype=torch.int32))
    want = tref.fused_group_step_ref(x.clone(), g, 0.1, **{**kw, "mu": mu.clone(),
                                                           "nu": nu.clone()})
    got = tfs.fused_step_large(x, g, 0.1, inplace=True,
                               runner=tlp.Runner(large_lib, None, 2), **kw)
    assert got[0] is x and got[1] is mu and got[2] is nu
    for name, a, w in zip(("x", "mu", "nu", "dist"), got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("shape,sms,inplace", [((2, 136, 200), 2, True),
                                               ((1, 130, 201), 2, False),
                                               ((1, 136, 256), 64, False)])
def test_large_two_stage_emulated(large_lib, shape, sms, inplace):
    """``pogo_update_large`` (X' over X when ``inplace``: M waits in a
    scratch) and ``landing_field_large`` at the two-stage tiled
    tolerance."""
    run = tlp.Runner(large_lib, None, sms, min_slice=64)
    x, g, _, _ = _large_operands(shape, 2, 0.01)
    want_u = tref.pogo_update_ref(x, g, 0.1, 0.5)
    want_f = tref.landing_field_ref(x, g, 1.0)
    got_f = tlf.landing_field_large(x, g, 1.0, runner=run)
    got_u = tpu.pogo_update_large(x, g, 0.1, 0.5, inplace=inplace, runner=run)
    assert (got_u is x) == inplace
    for got, want in ((got_u, want_u), (got_f, want_f)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,iters,sms,masked", [((3, 136, 200), 4, 2, True),
                                                    ((2, 130, 201), 3, 64, False)])
def test_large_newton_schulz_emulated(large_lib, shape, iters, sms, masked):
    """``newton_schulz_large`` in place over the watchdog's drift, at the
    Newton-Schulz tolerance: every other matrix masked off (bit-unchanged,
    distance too), or an odd count of iterations (the first writes x
    itself, from a copy)."""
    b = shape[0]
    rng = np.random.default_rng(3)
    x = _large_operands(shape, 3)[0]
    x = 1.5 * x + torch.from_numpy(0.05 * rng.standard_normal(shape).astype(np.float32))
    mask = torch.arange(b) % 2 == 0 if masked else None
    dist = torch.from_numpy(rng.uniform(1.0, 2.0, b).astype(np.float32))
    x0, d0 = x.clone(), dist.clone()
    tns.newton_schulz_large(x, iters, out=x, mask=mask, dist=dist,
                            runner=tlp.Runner(large_lib, None, sms, min_slice=64))
    on = mask if masked else torch.ones(b, dtype=torch.bool)
    want = tref.newton_schulz_ref(x0, iters)
    np.testing.assert_allclose(x[on].numpy(), want[on].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dist[on].numpy(), tref.manifold_distance_ref(want[on]).numpy(),
                               atol=1e-5, rtol=1e-3)
    assert torch.equal(x[~on], x0[~on]) and torch.equal(dist[~on], d0[~on])
