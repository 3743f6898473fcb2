"""Parity of the port's Stiefel primitives and health verdict with the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: fp32 products of (p, n) matrices summed in different orders,
atol 1e-5 / rtol 1e-5. Random draws cannot match JAX's threefry streams,
so ``random_stiefel`` is checked by property (``X X^T = I`` to 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import health as jhealth
from repro.core import stiefel as jst
from repro_torch import health as thealth
from repro_torch.core import stiefel as tst

SHAPES = [(3, 5, 40), (2, 16, 256), (4, 1, 7), (2, 3, 3, 12)]


def _near_stiefel(shape, seed, noise=1e-2):
    rng = np.random.default_rng(seed)
    *lead, p, n = shape
    a = rng.standard_normal((*lead, n, p))
    q, _ = np.linalg.qr(a)
    x = np.swapaxes(q, -1, -2) + noise * rng.standard_normal(shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_manifold_distance_matches_jax(shape):
    x = _near_stiefel(shape, 0)
    want = np.asarray(jst.manifold_distance(jnp.asarray(x)))
    got = tst.manifold_distance(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_matches_jax(shape):
    x = _near_stiefel(shape, 1, noise=0.3)
    want = np.asarray(jst.gram(jnp.asarray(x)))
    got = tst.gram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("p", [1, 4, 9])
def test_masked_eye_matches_jax(p):
    pv = np.array([0, p, max(p - 1, 0), 1], np.int32)
    want = np.asarray(jst.masked_eye(p, jnp.asarray(pv)))
    got = tst.masked_eye(p, torch.from_numpy(pv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_manifold_distance_masked_matches_jax():
    b, p, n = 4, 6, 20
    x = _near_stiefel((b, p, n), 2)
    pv = np.array([6, 3, 1, 0], np.int32)
    rows = np.arange(p)[None, :, None] < pv[:, None, None]
    x = np.where(rows, x, 0.0).astype(np.float32)
    want = np.asarray(jst.manifold_distance_masked(jnp.asarray(x), jnp.asarray(pv)))
    got = tst.manifold_distance_masked(torch.from_numpy(x), torch.from_numpy(pv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(16, 256), (5, 3, 40), (8, 8)])
def test_random_stiefel_is_on_the_manifold(shape):
    gen = torch.Generator().manual_seed(7)
    x = tst.random_stiefel(gen, shape, device="cpu")
    assert tuple(x.shape) == shape
    assert x.is_contiguous()
    assert float(tst.manifold_distance(x).max()) < 1e-5


def test_random_stiefel_is_seeded_and_rejects_tall():
    a = tst.random_stiefel(torch.Generator().manual_seed(3), (4, 9), device="cpu")
    b = tst.random_stiefel(torch.Generator().manual_seed(3), (4, 9), device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="p <= n"):
        tst.random_stiefel(torch.Generator(), (9, 4), device="cpu")


def test_random_stiefel_stacked_draws_per_matrix():
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    x = tst.random_stiefel_stacked(gens, (3, 4, 12), device="cpu")
    assert float(tst.manifold_distance(x).max()) < 1e-5
    alone = tst.random_stiefel(torch.Generator().manual_seed(2), (4, 12), device="cpu")
    torch.testing.assert_close(x[1], alone, rtol=0, atol=0)


def test_random_stiefel_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.random_stiefel(torch.Generator(), (4, 9))


@pytest.mark.parametrize("residual", [0.25, float("nan"), float("inf")])
def test_health_from_residual_matches_jax(residual):
    j = jhealth.from_residual(jnp.asarray([residual, 0.0], jnp.float32))
    t = thealth.from_residual(torch.tensor([residual, 0.0]))
    np.testing.assert_array_equal(t.finite.numpy(), np.asarray(j.finite))
    assert bool(t.ok()) == bool(j.ok())
