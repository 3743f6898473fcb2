"""Newton-Schulz's cluster kernel of ``csrc/small_p.cu`` (row 9cl:
``newton_schulz_cluster``, one matrix's Y held in a thread block cluster's
shared memory through every iteration), run on the CPU through
``tests/cuda_emu/small_p_harness.cpp`` (METHOD 4), against its plain
version ``ref.newton_schulz_ref`` / ``ref.manifold_distance_ref`` and
against the JAX package's ``ops.newton_schulz`` (its Pallas kernel in
interpret mode) and ``stiefel.manifold_distance``.

The harness calls the C launchers, so the tensor map, the persistent
cluster grid (two emulated clusters walk the matrices, so that each
cluster's mbarriers and both sets of published grams are reused across
matrices and iterate parities) and the distributed shared memory are
checked too. Input: the watchdog's drift, 1.5 x a Stiefel draw + 0.05
randn. Tolerance: Newton-Schulz's atol 1e-6 for Y (``tests/test_kernels.py
:54-61``) and 1e-5 / rtol 1e-3 for the distance, as the emulation tests of
the other Newton-Schulz kernels hold them. Masked-off matrices and their
distances must come out bit for bit as they went in (out of place: the
output buffer's matrices untouched).
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _cuda_emu import compile_harness

from repro.core import stiefel as jst
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

NS = 4  # the harness's METHOD


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return compile_harness(tmp_path_factory, "small_p_harness.cpp")


def _run(harness, tmp_path, shape, iters, c, inplace, masked, with_dist=True, seed=0,
         keep_every=2):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = 1.5 * np.swapaxes(q, -1, -2) + 0.05 * rng.standard_normal(shape)
    x = np.ascontiguousarray(x, np.float32)
    out0 = rng.standard_normal(shape).astype(np.float32)  # the output buffer before
    dist = rng.uniform(1.0, 2.0, b).astype(np.float32)
    mask = (np.arange(b) % keep_every == 0) if masked else np.ones(b, bool)
    for name, a in (("x", x), ("out", out0), ("dist", dist), ("mask", mask.astype(np.float32))):
        a.tofile(tmp_path / f"{name}.bin")
    res = subprocess.run(
        [str(harness), str(tmp_path), str(NS), str(b), str(p), str(n), str(iters),
         str(int(with_dist)), str(int(inplace)), str(int(masked)), str(c)],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = np.fromfile(tmp_path / "x_out.bin", np.float32).reshape(shape)
    got_d = np.fromfile(tmp_path / "dist_out.bin", np.float32)
    want = tref.newton_schulz_ref(torch.from_numpy(x), iters)
    want_d = tref.manifold_distance_ref(want).numpy()
    jx = jops.newton_schulz(jnp.asarray(x), iters=iters, interpret=True)
    on = mask
    np.testing.assert_allclose(got[on], want.numpy()[on], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[on], np.asarray(jx)[on], atol=1e-6, rtol=0, err_msg="JAX")
    if with_dist:
        np.testing.assert_allclose(got_d[on], want_d[on], atol=1e-5, rtol=1e-3)
        np.testing.assert_allclose(got_d[on], np.asarray(jst.manifold_distance(jx))[on],
                                   atol=1e-5, rtol=1e-3, err_msg="JAX")
    else:
        np.testing.assert_array_equal(got_d, dist)
    np.testing.assert_array_equal(got[~on], (x if inplace else out0)[~on])
    np.testing.assert_array_equal(got_d[~on], dist[~on])
    return got


# c: the cluster size, 0 the launcher's own (ns_cluster).
@pytest.mark.parametrize("shape,iters,c,inplace,masked", [
    # the paper's p; four 252-column boxes a CTA, rank 1's last cut short at
    # n; five matrices on two clusters, the watchdog's 12 iterations (13
    # grams a matrix, so the published sets' parity flips between matrices)
    ((5, 10, 2000), 12, 2, True, True),
    ((3, 1, 64), 4, 0, False, False),  # p = 1: one gram block, 256 lanes
    ((5, 7, 300), 4, 4, False, True),  # ragged p and n, out of place, masked
    ((4, 24, 512), 4, 2, True, True),  # p = 24: one column a thread, rows rolled
    ((3, 31, 256), 12, 4, False, False),  # p = 31: PB = 32, one CTA an SM
    ((3, 10, 40), 4, 8, True, True),  # a cluster of 8 whose last three CTAs hold no box
], ids=["paper_p_c2_in_place_masked", "p1", "ragged_c4_masked", "p24_rolled",
        "p31_c4", "c8_empty_ctas"])
def test_ns_cluster_kernel_emulated(harness, tmp_path, shape, iters, c, inplace, masked):
    _run(harness, tmp_path, shape, iters, c, inplace, masked, seed=sum(shape))


def test_ns_cluster_kernel_emulated_without_distance(harness, tmp_path):
    """No distance asked: no gram after the last iterate, each box taking
    the next matrix's load as the last round finishes it; dist untouched."""
    _run(harness, tmp_path, (5, 12, 1000), 4, 2, False, True, with_dist=False, seed=3)


def test_ns_cluster_kernel_emulated_sparse_mask(harness, tmp_path):
    """Every third matrix kept, on two clusters: cluster 0 walks 0, 2, 4
    and 6 and keeps 0 and 6, so its scan passes two masked-off matrices;
    cluster 1 walks 1, 3 and 5 and keeps 3 alone, not the first it reads."""
    _run(harness, tmp_path, (7, 7, 300), 4, 2, True, True, seed=5, keep_every=3)


def test_ns_cluster_kernel_emulated_no_iterations(harness, tmp_path):
    """Zero iterations: X / f written, the distance of X / f."""
    _run(harness, tmp_path, (3, 10, 256), 0, 2, False, False, seed=4)


@pytest.mark.parametrize("p,n,c", [(10, 10000, 4), (12, 10000, 8), (4, 4096, 2),
                                   (24, 10000, 8), (31, 2048, 2), (16, 4096, 2),
                                   (28, 10000, 8)])
def test_ns_cluster_size_mirrors_the_source(p, n, c):
    """``ops.ns_cluster``, as ``ns_cluster`` in the source: to p = 12 the
    least cluster whose CTA, Y's slots alone, leaves its SM room for a
    second (the paper's (10, 10000) takes 4: 101 KB a CTA), else the least
    whose slots fit a CTA; past p = 12, where the kernel's registers allow
    one CTA an SM, the least whose slots fit."""
    assert tops.ns_cluster(p, n) == c
    smem = tops.ns_cluster_smem_bytes(p, n, c)
    assert smem <= tops.SMEM_LIMIT_BYTES
    ctas = min(tops.SM_SMEM_BYTES // (smem + 1024), 2 if p <= 12 else 1)
    for smaller in (2, 4, 8)[:(2, 4, 8).index(c)]:
        s = tops.ns_cluster_smem_bytes(p, n, smaller)
        assert s > tops.SMEM_LIMIT_BYTES or tops.SM_SMEM_BYTES // (s + 1024) < ctas


@pytest.mark.parametrize("p,n", [(10, 9998), (33, 2048), (31, 60000), (8, 300000)])
def test_no_ns_cluster_past_its_reach(p, n):
    """No cluster where n % 4 != 0, p > 32 or a cluster of 8 cannot hold Y."""
    assert tops.ns_cluster(p, n) == 0
