"""Parity of the port's landing polynomial and quartic-root lambda
(``repro_torch.core.quartic``) with ``repro.core.quartic``, on the CPU,
at the tolerances of ``tests/test_quartic.py``: coefficients rtol 2e-4 /
atol 1e-6, the gram form against the direct form rtol 1e-4 / atol 1e-5.

Lambda itself is held by what it achieves. The minimum of the landing
polynomial P sits at a near-double root, where the fp32 Ferrari solve of
either package puts +-sqrt(eps)-sized imaginary parts on the pair (the
roots of the same coefficients differ between the packages by up to
0.06j), so the chosen lambdas may differ (by 0.06 in one case below), and
P at the chosen lambda scatters by up to ~1.5e-3 P(0) in either package
(JAX's own choices within one batch below: 7e-8 to 5e-3 at P(0) = 9.4;
2e-2 P(0) with the gram form's fallback of 0.7). Per matrix the two
packages' picks are not comparable; over a batch of 32 they are: the test
holds the mean and the max of P(lambda) / P(0) at the port's lambdas
within 10% (+1e-6) of those at JAX's, evaluated in fp64 from JAX's
coefficients. POGO's ``find_root`` step is held to the JAX package's
over three steps: params atol 2e-5 / rtol 1e-4, the reported distance
(about 1e-3 here, the lambda spread times the normal field) atol 5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import quartic as jq
from repro.core import stiefel as jst
from repro_torch.core import api as tapi
from repro_torch.core import quartic as tq
from repro_torch.core import stiefel as tst

COEF_TOL = dict(rtol=2e-4, atol=1e-6)


def _m(seed, b=4, p=6, n=14, eta=0.3, drift=1.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = drift * np.swapaxes(q, -1, -2)
    g = rng.standard_normal((b, p, n))
    g = g / np.maximum(np.linalg.norm(g, axis=(-2, -1), keepdims=True), 1.0)
    m = np.asarray(jst.riemannian_gradient(jnp.asarray(x), jnp.asarray(g)))
    return np.ascontiguousarray(x - eta * m, np.float32)


@pytest.mark.parametrize("seed,eta,drift", [(0, 0.3, 1.0), (1, 0.8, 1.0),
                                            (2, 0.1, 1.5), (3, 0.05, 1.0)])
def test_landing_poly_coeffs_match_jax(seed, eta, drift):
    m = _m(seed, eta=eta, drift=drift)
    want = jq.landing_poly_coeffs(jnp.asarray(m))
    got = tq.landing_poly_coeffs(torch.from_numpy(m))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **COEF_TOL)
    c = torch.from_numpy(m) @ torch.from_numpy(m).transpose(-1, -2) - torch.eye(m.shape[1])
    for a, b in zip(tq.landing_poly_coeffs_from_gram(c), got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_eval_quartic_is_the_distance():
    m = torch.from_numpy(_m(5, b=1, p=5, n=12, eta=0.2))[0]
    coeffs = tq.landing_poly_coeffs(m)
    for lam in (0.0, 0.3, 0.5, 0.9, 1.5):
        x1 = m + lam * (torch.eye(5) - m @ m.T) @ m
        direct = float(tst.manifold_distance(x1)) ** 2
        np.testing.assert_allclose(float(tq.eval_quartic(coeffs, lam)), direct,
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("seed,eta,drift", [(0, 0.3, 1.0), (1, 0.8, 1.0),
                                            (2, 0.1, 1.5), (4, 0.5, 1.2)])
@pytest.mark.parametrize("form", ["direct", "gram"])
def test_optimal_lambda_matches_jax(seed, eta, drift, form):
    m = _m(seed, b=32, eta=eta, drift=drift)
    coeffs = [np.asarray(a, np.float64)
              for a in jq.landing_poly_coeffs(jnp.asarray(m))]
    if form == "direct":
        got = tq.optimal_lambda(torch.from_numpy(m)).numpy()
        want = np.asarray(jq.optimal_lambda(jnp.asarray(m)))
    else:  # the watchdog's blend: from the gram, another fallback
        c = m @ np.swapaxes(m, -1, -2) - np.eye(m.shape[1], dtype=np.float32)
        got = tq.optimal_lambda_from_gram(torch.from_numpy(c), fallback=0.7).numpy()
        want = np.asarray(jq.optimal_lambda_from_gram(jnp.asarray(c), fallback=0.7))
    assert np.all((got >= -0.5) & (got <= 2.0))
    r_got = jq.eval_quartic(coeffs, got.astype(np.float64)) / coeffs[4]
    r_want = jq.eval_quartic(coeffs, want.astype(np.float64)) / coeffs[4]
    assert r_got.mean() <= 1.1 * r_want.mean() + 1e-6, (r_got.mean(), r_want.mean())
    assert r_got.max() <= 1.1 * r_want.max() + 1e-6, (r_got.max(), r_want.max())


def test_on_manifold_falls_back():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((2, 10, 4)))
    x = torch.from_numpy(np.ascontiguousarray(np.swapaxes(q, -1, -2), np.float32))
    torch.testing.assert_close(tq.optimal_lambda(x, fallback=0.5), torch.full((2,), 0.5))


def test_min_distance_real_root_matches_jax():
    roots = np.array([[1 + 2j, 0.5 + 1e-4j, -1 - 1j, 3 + 0.1j]], np.complex64)
    np.testing.assert_allclose(
        tq.min_distance_real_root(torch.from_numpy(roots)).numpy(),
        np.asarray(jq.min_distance_real_root(jnp.asarray(roots))))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_find_root_step_matches_jax(use_kernel):
    """POGO with ``find_root`` (the two-stage step; the kernel flag takes
    ``kernel_update``'s plain quartic path, as in JAX) over three steps."""
    rng = np.random.default_rng(7)
    xs = np.stack([np.swapaxes(np.linalg.qr(rng.standard_normal((16, 6)))[0], 0, 1)
                   for _ in range(3)]).astype(np.float32)
    params = {f"w{i}": xs[i] for i in range(3)}
    grads = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = japi.orthogonal("pogo", learning_rate=0.2, find_root=True,
                           use_kernel=use_kernel)
    topt = tapi.orthogonal("pogo", learning_rate=0.2, find_root=True,
                           use_kernel=use_kernel)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tp = {k: tp[k] + tu[k] for k in tp}
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(float(tapi.max_distance(ts)),
                               float(japi.max_distance(js)), atol=5e-5, rtol=0)
