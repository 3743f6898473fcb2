"""Parity of the port's fused group step (CPU path: the plain version of
both CUDA kernels) with the JAX package's oracle and its Pallas kernels.

The same numpy inputs go through ``repro_torch.kernels.ops.fused_group_step``
on the CPU, JAX ``ref.fused_group_step_ref``, and JAX
``ops.fused_group_step(use_pallas=True, interpret=True)`` — the whole
kernel, and the tiled kernel forced by shrinking ``ops.VMEM_BUDGET_BYTES``
as ``tests/test_fused_step.py`` does. Tolerances are those the JAX tests
hold the Pallas kernels to: atol 2e-5 / rtol 1e-4 whole, atol 3e-5 /
rtol 1e-4 tiled (fp32 sums in another order).

Static jit arguments key JAX's dispatch cache, so the tiled cases use
their own ``hyper`` values and ``post_scale`` (plan selection happens at
trace time and a cached whole plan would otherwise be reused).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops

# (6, 10, 1024): the paper's unitary-PC p at an n that the card's planner
# sends to the cluster kernel (its CPU path is the same plain version).
SHAPES = [(3, 5, 40), (2, 10, 250), (4, 16, 256), (6, 10, 1024)]

WHOLE_BASES = [
    ("none", ()),
    ("trace", (0.31, False)),
    ("trace", (0.52, True)),  # nesterov
    ("vadam", (0.9, 0.999, 1e-8)),
]
TILED_BASES = [
    ("none", ()),
    ("trace", (0.33, False)),
    ("trace", (0.54, True)),
    ("vadam", (0.91, 0.998, 1e-8)),
]
WHOLE_TOL = dict(atol=2e-5, rtol=1e-4)
TILED_TOL = dict(atol=3e-5, rtol=1e-4)
NAMES = ("x", "mu", "nu", "dist", "finite")


def _operands(shape, seed=0, pv=None):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    if pv is not None:
        rows = np.arange(p)[None, :, None] < np.asarray(pv)[:, None, None]
        x, g, mu = (np.where(rows, a, 0.0) for a in (x, g, mu))
    nu = np.abs(rng.standard_normal(b))
    return tuple(a.astype(np.float32) for a in (x, g, mu, nu))


def _both(shape, base_kind, hyper, post_scale=1.0, pv=None, seed=0):
    """(jax kwargs, torch kwargs, x, g) for one case."""
    x, g, mu, nu = _operands(shape, seed, pv)
    has_mu = base_kind != "none"
    has_nu = base_kind == "vadam"
    common = dict(method="pogo", lam=0.5, base_kind=base_kind, hyper=hyper,
                  post_scale=post_scale)
    jkw = dict(common, mu=jnp.asarray(mu) if has_mu else None,
               nu=jnp.asarray(nu) if has_nu else None,
               count=jnp.asarray(3, jnp.int32) if has_nu else None,
               pv=None if pv is None else jnp.asarray(pv, jnp.int32))
    tkw = dict(common, mu=torch.from_numpy(mu) if has_mu else None,
               nu=torch.from_numpy(nu) if has_nu else None,
               count=torch.tensor(3, dtype=torch.int32) if has_nu else None,
               pv=None if pv is None else torch.tensor(pv, dtype=torch.int32))
    return jkw, tkw, x, g


def _compare(want, got, tol, label):
    for a, b, name in zip(want, got, NAMES):
        if a is None:
            assert b is None, f"{label}/{name}"
            continue
        np.testing.assert_allclose(
            np.asarray(b.numpy(), np.float32), np.asarray(a, np.float32),
            err_msg=f"{label}/{name}", **tol,
        )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_fused_step_matches_jax_oracle(shape, base_kind, hyper):
    jkw, tkw, x, g = _both(shape, base_kind, hyper)
    want = jref.fused_group_step_ref(jnp.asarray(x), jnp.asarray(g), 0.1, **jkw)
    got = tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    _compare(want, got, WHOLE_TOL, f"ref/{base_kind}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_fused_step_matches_pallas_whole(shape, base_kind, hyper):
    jkw, tkw, x, g = _both(shape, base_kind, hyper, seed=1)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=True, interpret=True, **jkw)
    got = tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    _compare(want, got, WHOLE_TOL, f"whole/{base_kind}")


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("base_kind,hyper", TILED_BASES)
def test_fused_step_matches_pallas_tiled(shape, base_kind, hyper, monkeypatch):
    monkeypatch.setattr(jops, "VMEM_BUDGET_BYTES", 64 * 1024)
    plan = jops.plan_candidates(*shape[1:], shape[0], f"fused_pogo+{base_kind}")
    assert plan[0]["kind"] == "tiled"
    jkw, tkw, x, g = _both(shape, base_kind, hyper, post_scale=0.8, seed=2)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=True, interpret=True, **jkw)
    got = tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    _compare(want, got, TILED_TOL, f"tiled/{base_kind}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_step_ragged_pv_matches_jax(use_pallas):
    """Zero-padded rows with per-matrix valid-row counts: the telemetry
    masks each matrix's identity to its true rows."""
    pv = [5, 3, 1]
    jkw, tkw, x, g = _both((3, 5, 40), "trace", (0.29, False), pv=pv, seed=3)
    want = jops.fused_group_step(jnp.asarray(x), jnp.asarray(g), 0.1,
                                 use_pallas=use_pallas, interpret=True, **jkw)
    got = tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    _compare(want, got, WHOLE_TOL, f"pv/{use_pallas}")
    assert float(got[3].max()) < 1.0  # padded diagonal is not counted


@pytest.mark.parametrize("wrapper", [tfs.fused_step_whole, tfs.fused_step_tiled,
                                     tfs.fused_step_cluster, tfs.fused_step_tiled_tc,
                                     tfs.fused_step_tiled_tc128,
                                     tfs.fused_step_cluster_landing])
def test_wrappers_run_the_plain_version_on_cpu(wrapper):
    jkw, tkw, x, g = _both((2, 10, 250), "vadam", (0.9, 0.999, 1e-8), seed=4)
    if wrapper.__name__.endswith("_landing"):  # the method is the wrapper's own
        tkw.pop("method")
        jkw["method"] = "landing"
    before = tops.launches()
    got = wrapper(torch.from_numpy(x), torch.from_numpy(g), 0.1, **tkw)
    want = jref.fused_group_step_ref(jnp.asarray(x), jnp.asarray(g), 0.1, **jkw)
    _compare(want, got, WHOLE_TOL, wrapper.__name__)
    # No kernel was launched: the launch counters count CUDA launches only.
    assert tops.launches() == before


@pytest.mark.parametrize("base_kind,hyper", WHOLE_BASES)
def test_inplace_matches_out_of_place(base_kind, hyper):
    _, tkw, x, g = _both((3, 5, 40), base_kind, hyper, seed=5)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    want = tops.fused_group_step(xt.clone(), gt, 0.1, **{
        k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in tkw.items()
    })
    got = tops.fused_group_step(xt, gt, 0.1, inplace=True, **tkw)
    assert got[0] is xt
    if base_kind != "none":
        assert got[1] is tkw["mu"]
    for a, b in zip(want, got):
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["pogo", "landing"])
def test_fused_step_rejects_complex_and_unknown_methods(method):
    """Both fused branches are real-only; a method with no fused branch is
    refused (Landing's branch is held against JAX in
    ``tests/test_torch_landing_fused.py``)."""
    x = torch.zeros((1, 2, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="real-only"):
        tops.fused_group_step(x, x, 0.1, method=method, lam=0.5)
    xr = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="unknown fused method"):
        tops.fused_group_step(xr, xr, 0.1, method="rgd", lam=0.5)
