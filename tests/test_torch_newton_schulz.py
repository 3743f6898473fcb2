"""Parity of the port's Stiefel projections and Newton-Schulz with the JAX
package, on the CPU.

The same numpy inputs go through both packages:

* ``stiefel.project_newton_schulz``, ``project_qr`` and
  ``project_polar`` against ``repro.core.stiefel``'s (atol 1e-5: fp32
  products in another order; polar 1e-4, two fp32 eigh routines);
* ``ref.newton_schulz_ref`` and ``ops.newton_schulz`` (the kernels' plain
  version on a CPU tensor) against JAX's ``ops.newton_schulz`` with the
  Pallas kernel in interpret mode and against ``ref.newton_schulz_ref``
  (atol 1e-6, ``tests/test_kernels.py:54-61``), ragged shapes included;
* the watchdog's masked repair (``ops.newton_schulz_repair``): repaired
  matrices equal the projection and reach its distance, the others keep
  their bits.

The CUDA kernels themselves run through the emulator
(``tests/test_torch_kernel_emulation.py``) and on the card
(``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stiefel as jst
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import stiefel as tst
from repro_torch.kernels import newton_schulz as tns
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# QR: Householder in both LAPACKs. Polar: (X X^T)^{-1/2} from two fp32
# eigh implementations, whose eigenvalue errors 1/sqrt(w) amplifies.
PROJ_TOL = {"project_qr": 1e-5, "project_polar": 1e-4}
SHAPES = [(1, 3, 3), (4, 16, 32), (2, 10, 250), (3, 16, 256), (2, 7, 33), (1, 128, 256)]


def _drifted(shape, seed=0, scale=1.5, noise=0.05):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = scale * np.swapaxes(q, -1, -2) + noise * rng.standard_normal(shape)
    return np.ascontiguousarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_newton_schulz_plain_matches_jax_kernel(shape):
    x = _drifted(shape)
    want = np.asarray(jops.newton_schulz(jnp.asarray(x), interpret=True))
    got = tops.newton_schulz(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(tref.newton_schulz_ref(torch.from_numpy(x)).numpy(),
                               np.asarray(jref.newton_schulz_ref(jnp.asarray(x))),
                               atol=1e-6)
    assert float(tst.manifold_distance(torch.from_numpy(got)).max()) < 1e-2


@pytest.mark.parametrize("iters", [1, 12, 20])
def test_project_newton_schulz_matches_jax(iters):
    x = _drifted((3, 8, 40), seed=1)
    want = np.asarray(jst.project_newton_schulz(jnp.asarray(x), iters=iters))
    got = tst.project_newton_schulz(torch.from_numpy(x), iters=iters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 6, 20), (2, 16, 16), (1, 10, 250)])
@pytest.mark.parametrize("proj", ["project_qr", "project_polar"])
def test_factorisation_projections_match_jax(shape, proj):
    x = _drifted(shape, seed=2, scale=1.0, noise=0.3)
    want = np.asarray(getattr(jst, proj)(jnp.asarray(x)))
    got = getattr(tst, proj)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=PROJ_TOL[proj])
    # as feasible as the JAX package's result (fp32 polar of a square
    # matrix reaches ~1e-3 in both)
    d_got = float(tst.manifold_distance(torch.from_numpy(got)).max())
    d_want = float(jnp.max(jst.manifold_distance(want)))
    assert d_got <= d_want + 1e-5


def test_leading_dims_flatten():
    x = _drifted((6, 8, 24), seed=3).reshape(2, 3, 8, 24)
    got = tops.newton_schulz(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.newton_schulz(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 12, 130), (6, 64, 96)])
def test_masked_repair_on_cpu(shape):
    """Every other matrix past the threshold: those are projected (the
    projection's distance lands in ``dist``), the others keep their bits."""
    x = torch.from_numpy(_drifted(shape, seed=4))
    b = shape[0]
    dist = torch.where(torch.arange(b) % 2 == 0, torch.tensor(2.0), torch.tensor(0.01))
    dist[-1] = float("nan")  # non-finite rows are the rollback's job
    x0, d0 = x.clone(), dist.clone()
    rep = tops.newton_schulz_repair(x, dist, torch.tensor(0.1), iters=12)
    want_rep = torch.isfinite(d0) & (d0 > 0.1)
    assert torch.equal(rep, want_rep)
    proj = tref.newton_schulz_ref(x0, 12)
    torch.testing.assert_close(x[rep], proj[rep], atol=1e-6, rtol=0)
    torch.testing.assert_close(dist[rep], tref.manifold_distance_ref(proj[rep]))
    assert torch.equal(x[~rep], x0[~rep])
    assert torch.equal(dist[~rep].isnan(), d0[~rep].isnan())
    assert torch.equal(dist[~rep & d0.isfinite()], d0[~rep & d0.isfinite()])
    assert float(dist[rep].max()) < 1e-2


def test_mask_requires_in_place():
    x = torch.from_numpy(_drifted((2, 4, 8)))
    with pytest.raises(ValueError, match="out=x"):
        tns.newton_schulz_whole(x, mask=torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("p,n,want", [
    (16, 256, ("whole", 0)),  # the many-matrices shape: Y in shared memory
    (10, 250, ("whole", 0)),
    # SmolLM q/k: 245,760 B does not fit a block; the tensor-core kernel
    # keeps Y in a cluster of two CTAs
    (64, 960, ("tc", 0)),
    (48, 1500, ("tc", 0)),  # a cluster of four
    # internlm2-1.8b's q/k: the p <= 128 tensor-core kernel, 16 CTAs a matrix
    (128, 2048, ("tc128", 0)),
    (100, 1500, ("tc128", 0)),  # a ragged p in 65..128
    (72, 2048, ("tc128", 0)),
    # n past 16 CTAs of two chunks each, at n % 4 == 0: Y streams through a
    # TMA ring (row 9s)
    (124, 4096, ("stream", 0)),
    (128, 2049, ("tiled", 64)),  # n % 4 != 0: a row stride TMA cannot take
    # p below NS_TC_MIN_P: the cluster kernel of csrc/small_p.cu where a
    # cluster of at most 8 CTAs holds Y and n % 4 == 0
    (16, 4096, ("cluster", 0)),
    (10, 10000, ("cluster", 0)),  # the paper's unitary-PC sizes
    (31, 2048, ("cluster", 0)),
    (10, 9998, ("tiled", 64)),  # n % 4 != 0: a row stride TMA cannot take
    (31, 60000, ("tiled", 64)),  # n past what a cluster of 8 holds
    (40, 6000, ("tiled", 64)),  # p past the cluster route, n past 9tc's clusters
    (64, 6000, ("tiled", 64)),  # n past eight CTAs' shared memory
    (128, 6144, ("stream", 0)),  # starcoder2-15b's q/k: row 9s
])
def test_newton_schulz_planner(p, n, want):
    assert tops.plan_newton_schulz(p, n) == want
    kind, tile_n = want
    size = {"whole": lambda: tops.ns_whole_smem_bytes(p, n),
            "tc": lambda: tops.ns_tc_smem_bytes(n),
            "tc128": lambda: tops.ns_tc128_smem_bytes(n),
            "stream": tops.ns_stream_smem_bytes,
            "cluster": lambda: tops.ns_cluster_smem_bytes(p, n, tops.ns_cluster(p, n)),
            "tiled": lambda: tops.ns_tiled_smem_bytes(p, tile_n)}[kind]()
    assert 0 < size <= tops.SMEM_LIMIT_BYTES


def test_newton_schulz_planner_raises_for_large_p():
    """Where it raised before, the planner now gives the large route
    (``csrc/large_p.cu``): its tensor-core kernels at n % 4 == 0, its
    CUDA-core ones elsewhere."""
    assert tops.plan_newton_schulz(256, 4096) == ("large_tc", 0)
    assert tops.plan_newton_schulz(256, 4097) == ("large", 0)
