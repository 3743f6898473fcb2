"""Parity of the port's tensor-parallel group step with the JAX package, on
the CPU.

The same numpy inputs go through the port's plain versions of the TP
kernels (``ref.tp_partial_ref``, ``ref.tp_apply_ref`` via
``ops.fused_group_step_tp_partial``/``_finish`` on a CPU tensor) and JAX's
``ref.tp_partial_ref``/``tp_finish_ref`` and ``ops.fused_group_step_tp_
partial``/``_finish`` with ``use_pallas=True, interpret=True`` (the
``tp_gram_whole``/``tp_apply_whole`` Pallas kernels). The single-device
schedule (``ops.fused_group_step_tp``, n split into 1, 2 or 4 shards,
payloads left-folded) is held against JAX's and against the port's
unsharded fused step. Tolerance atol 3e-5 / rtol 1e-4, the tiled-kernel
tolerance of ``tests/test_fused_step.py:95``: fp32 sums in another order,
and the TP step's gram algebra differs from the unsharded step's direct
products by rounding.

The gloo cases run the TP route of ``constraint_step`` in 2 ranks on a
(1, 2) mesh and 4 ranks on a (2, 2) mesh, each rank a process of its own
(``init_method=file://`` under ``tmp_path``), on ``DTensor`` stacks
``Shard(-1)`` on "model". Each must make exactly one all-reduce per group
per step and match three steps of JAX's single-device schedule
(``ops.fused_group_step_tp``) on its own columns within the same
tolerance: gloo's reduction is not a left fold, and a padded case splits
its columns differently from JAX's padding.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import api as tapi
from repro_torch.core import schedule as tsched
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tp_step as ttp

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=3e-5, rtol=1e-4)
BASES = [
    ("none", ()),
    ("trace", (0.9, False)),
    ("trace", (0.5, True)),  # nesterov
    ("vadam", (0.9, 0.999, 1e-8)),
]
METHODS = {"pogo": 0.5, "landing": 1.0}  # method -> lam


def _operands(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.swapaxes(q, -1, -2) + 0.01 * rng.standard_normal(shape)
    g = 0.2 * rng.standard_normal(shape)
    mu = 0.1 * rng.standard_normal(shape)
    nu = np.abs(rng.standard_normal(b))
    return tuple(a.astype(np.float32) for a in (x, g, mu, nu))


def _kw(base_kind, hyper, mu, nu, j):
    """Keyword arguments of a step for JAX (``j``) or the port."""
    arr = jnp.asarray if j else torch.from_numpy
    count = (jnp.asarray(3, jnp.int32) if j else torch.tensor(3, dtype=torch.int32))
    return dict(base_kind=base_kind, hyper=hyper,
                mu=arr(mu) if base_kind != "none" else None,
                nu=arr(nu) if base_kind == "vadam" else None,
                count=count if base_kind == "vadam" else None)


def _close(got, want, label):
    for name, a, b in zip(("x", "mu", "nu", "dist", "finite"), want, got):
        if a is None:
            assert b is None, f"{label}/{name}"
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=f"{label}/{name}", **TOL)


@pytest.mark.parametrize("post_scale", [1.0, 0.6])
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_partial_ref_matches_jax(base_kind, hyper, post_scale):
    x, g, mu, _ = _operands((3, 8, 48))
    want = jref.tp_partial_ref(jnp.asarray(x), jnp.asarray(g), base_kind=base_kind,
                               hyper=hyper, post_scale=post_scale,
                               mu=jnp.asarray(mu) if base_kind != "none" else None)
    got = tref.tp_partial_ref(torch.from_numpy(x), torch.from_numpy(g),
                              base_kind=base_kind, hyper=hyper,
                              post_scale=post_scale,
                              mu=torch.from_numpy(mu) if base_kind != "none" else None)
    assert got[0].shape[1] == tref.tp_payload_width(8, base_kind) == \
        jref.tp_payload_width(8, base_kind)
    for a, b, name in zip(want, got, ("payload", "gbase", "mu")):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **TOL)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_finish_ref_matches_jax(method, base_kind, hyper):
    """The finish on a payload summed over two shards, pv masking one row."""
    x, g, mu, nu = _operands((4, 8, 48), seed=1)
    pv = np.array([8, 7, 8, 5], np.int32)
    jk, tk = _kw(base_kind, hyper, mu, nu, True), _kw(base_kind, hyper, mu, nu, False)
    pay_j, gb_j, _ = jref.tp_partial_ref(jnp.asarray(x), jnp.asarray(g),
                                         base_kind=base_kind, hyper=hyper, mu=jk["mu"])
    pay = np.array(pay_j)
    want = jref.tp_finish_ref(jnp.asarray(x), gb_j, jnp.asarray(pay), 0.1,
                              method=method, lam=METHODS[method], base_kind=base_kind,
                              hyper=hyper, nu=jk["nu"], count=jk["count"],
                              pv=jnp.asarray(pv))
    got = tref.tp_finish_ref(torch.from_numpy(x), torch.from_numpy(np.array(gb_j)),
                             torch.from_numpy(pay), 0.1, method=method,
                             lam=METHODS[method], base_kind=base_kind, hyper=hyper,
                             nu=tk["nu"], count=tk["count"], pv=torch.from_numpy(pv))
    for a, b, name in zip(want, got, ("x", "nu", "dist", "finite")):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), err_msg=name, **TOL)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_partial_and_finish_match_pallas_interpret(method, base_kind, hyper):
    """The port's TP entry points (the plain versions of ``tp_gram`` and
    ``tp_apply`` on a CPU tensor) against JAX's with its Pallas TP
    kernels in interpret mode, one shard's columns then the finish."""
    x, g, mu, nu = _operands((3, 8, 64), seed=2)
    jk, tk = _kw(base_kind, hyper, mu, nu, True), _kw(base_kind, hyper, mu, nu, False)
    pallas = dict(use_pallas=True, interpret=True)
    pay_j, gb_j, mu_j = jops.fused_group_step_tp_partial(
        jnp.asarray(x), jnp.asarray(g), base_kind=base_kind, hyper=hyper,
        post_scale=0.8, mu=jk["mu"], **pallas)
    pay_t, gb_t, mu_t = tops.fused_group_step_tp_partial(
        torch.from_numpy(x), torch.from_numpy(g), base_kind=base_kind, hyper=hyper,
        post_scale=0.8, mu=tk["mu"])
    for a, b, name in ((pay_j, pay_t, "payload"), (gb_j, gb_t, "gbase"),
                       (mu_j, mu_t, "mu")):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **TOL)
    pay = np.array(pay_j)
    want = jops.fused_group_step_tp_finish(
        jnp.asarray(x), gb_j, jnp.asarray(pay), 0.1, method=method,
        lam=METHODS[method], base_kind=base_kind, hyper=hyper, post_scale=0.8,
        nu=jk["nu"], count=jk["count"], **pallas)
    got = tops.fused_group_step_tp_finish(
        torch.from_numpy(x), torch.from_numpy(np.array(gb_j)), torch.from_numpy(pay),
        0.1, method=method, lam=METHODS[method], base_kind=base_kind, hyper=hyper,
        post_scale=0.8, nu=tk["nu"], count=tk["count"])
    for a, b, name in zip(want, got, ("x", "nu", "dist", "finite")):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), err_msg=name, **TOL)


@pytest.mark.parametrize("tp_shards", [1, 2, 4])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_single_device_schedule_matches_jax(tp_shards, method, base_kind, hyper):
    x, g, mu, nu = _operands((3, 6, 80), seed=3)
    want = jops.fused_group_step_tp(
        jnp.asarray(x), jnp.asarray(g), 0.1, method=method, lam=METHODS[method],
        tp_shards=tp_shards, **_kw(base_kind, hyper, mu, nu, True))
    got = tops.fused_group_step_tp(
        torch.from_numpy(x), torch.from_numpy(g), 0.1, method=method,
        lam=METHODS[method], tp_shards=tp_shards, **_kw(base_kind, hyper, mu, nu, False))
    _close(got, want, f"{method}/{base_kind}/{tp_shards}")


@pytest.mark.parametrize("tp_shards", [1, 4])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_tp_oracle_matches_jax(tp_shards, method, base_kind, hyper):
    """``ref.fused_group_step_tp_ref`` against JAX's, pv masking two rows."""
    x, g, mu, nu = _operands((3, 6, 80), seed=6)
    pv = np.array([6, 4, 5], np.int32)
    want = jref.fused_group_step_tp_ref(
        jnp.asarray(x), jnp.asarray(g), 0.1, method=method, lam=METHODS[method],
        tp_shards=tp_shards, pv=jnp.asarray(pv), **_kw(base_kind, hyper, mu, nu, True))
    got = tref.fused_group_step_tp_ref(
        torch.from_numpy(x), torch.from_numpy(g), 0.1, method=method,
        lam=METHODS[method], tp_shards=tp_shards, pv=torch.from_numpy(pv),
        **_kw(base_kind, hyper, mu, nu, False))
    _close(got, want, f"{method}/{base_kind}/{tp_shards}")


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("base_kind,hyper", BASES)
def test_single_device_schedule_matches_the_unsharded_step(method, base_kind, hyper):
    x, g, mu, nu = _operands((3, 10, 120), seed=4)
    tk = _kw(base_kind, hyper, mu, nu, False)
    want = tops.fused_group_step(torch.from_numpy(x), torch.from_numpy(g), 0.1,
                                 method=method, lam=METHODS[method], **tk)
    got = tops.fused_group_step_tp(torch.from_numpy(x), torch.from_numpy(g), 0.1,
                                   method=method, lam=METHODS[method], tp_shards=4,
                                   **_kw(base_kind, hyper, mu, nu, False))
    _close(got, want, f"{method}/{base_kind}")


def test_single_device_schedule_needs_even_shards():
    x = torch.zeros((1, 2, 10))
    with pytest.raises(ValueError, match="does not split"):
        tops.fused_group_step_tp(x, x, 0.1, method="pogo", lam=0.5, tp_shards=4)


def test_tp_wrappers_run_the_plain_version_on_cpu():
    x, g, mu, nu = _operands((2, 8, 40), seed=5)
    xt, gt, mut = (torch.from_numpy(a) for a in (x, g, mu))
    before = (ttp.tp_gram.launches, ttp.tp_apply.launches)
    pay, gb, mu2 = ttp.tp_gram(xt, gt, base_kind="trace", hyper=(0.9, False),
                               mu=mut.clone(), inplace=True)
    want = tref.tp_partial_ref(xt, gt, base_kind="trace", hyper=(0.9, False), mu=mut)
    for a, b in zip(want, (pay, gb, mu2)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    x2, dist = ttp.tp_apply(xt.clone(), gb, pay, 0.1, method="landing", lam=1.0,
                            inplace=True)
    w2, wd = tref.tp_apply_ref(xt, gb, pay, 0.1, method="landing", lam=1.0)
    torch.testing.assert_close(x2, w2, rtol=0, atol=0)
    torch.testing.assert_close(dist, wd, rtol=0, atol=0)
    assert (ttp.tp_gram.launches, ttp.tp_apply.launches) == before


@pytest.mark.parametrize("n,width,n_pad,local", [
    (960, 2, 960, 480), (962, 2, 968, 484), (961, 2, 968, 484), (40, 4, 48, 12),
    (480, 4, 480, 120),
])
def test_tp_spec_pads_each_shard_to_four_columns(n, width, n_pad, local):
    spec = tsched.tp_spec(n, width)
    assert (spec.n_pad, spec.local_n, spec.width, spec.axis) == (n_pad, local, width,
                                                                  "model")
    assert spec.padded == (n_pad != n)
    assert tsched.padded_n(n, width) == n_pad
    assert tsched.padded_n(n, 1) == n


@pytest.mark.parametrize("n,width", [(100, 1), (3, 4), (5, 4)])
def test_tp_spec_refuses_what_tp_cannot_help(n, width):
    assert tsched.tp_spec(n, width) is None


def test_planning_takes_tp_shards():
    leaves = [torch.zeros(3, 4, 24)]
    assert tsched.plan_groups(leaves, None, tp_shards=2) == \
        tsched.plan_groups(leaves, None)
    with pytest.raises(ValueError, match="tp_shards"):
        tsched.plan_groups(leaves, None, tp_shards=0)


def test_tp_compress_is_still_refused():
    for method, kw in (("pogo", {}), ("landing", {"safe_step": False})):
        with pytest.raises(NotImplementedError, match=r"sharded schedules \(tp_compress\)"):
            tapi.orthogonal(method, use_kernel=True, tp_compress=True, **kw)


def test_tp_planner_fits_one_block():
    for p in (1, 16, 64, 96):
        for what, fn in (("gram", tops.tp_gram_smem_bytes),
                         ("apply", tops.tp_apply_smem_bytes)):
            tile = tops.plan_tp(what, p, fn)
            assert fn(p, tile) <= tops.SMEM_LIMIT_BYTES
    assert tops.plan_tp("apply", 64, tops.tp_apply_smem_bytes) == 32  # 2 blocks/SM
    assert tops.plan_tp("gram", 64, tops.tp_gram_smem_bytes) == 64
    for p in (100, 256):  # five (p, p) grams outgrow one block
        with pytest.raises(ValueError, match=rf"p={p} .*232448"):
            tops.plan_tp("apply", p, tops.tp_apply_smem_bytes)


# ------------------------------------------------------------------- gloo

# One rank: the mesh, DTensor stacks from the shared inputs, three steps of
# constraint_step, its local blocks and counters written back. A group of
# DTensor leaves under the watchdog has no route and must raise.
WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch import optim
from repro_torch.core import api
from repro_torch.distributed import shard_hints as sh

rank, world, dp, tmp, method, base, lr = sys.argv[1:8]
rank, world, dp, lr = int(rank), int(world), int(dp), float(lr)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", rank=rank,
                        world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(dp, world // dp),
                  mesh_dim_names=("data", "model"))
sh.set_mesh(mesh)
data = np.load(f"{tmp}/in.npz")
shard = lambda a: sh.shard_columns(torch.from_numpy(a), mesh, shard_batch=dp > 1)
bases = {"trace": optim.chain(optim.trace(0.9)),
         "vadam": optim.chain(optim.scale_by_vadam())}
kw = {"safe_step": False} if method == "landing" else {}
opt = api.orthogonal(method, learning_rate=lr, use_kernel=True,
                     base_optimizer=bases[base], **kw)
# The functional update on a tree of DTensor leaves: DTensor updates with
# the leaves' placements that add up to the first in-place step.
tree = {"w": shard(data["x"])}
upd, _ = opt.update({"w": shard(data["g0"])}, opt.init(tree), tree)
functional = isinstance(upd["w"], type(tree["w"])) and \
    upd["w"].placements == tree["w"].placements
cs = api.ConstraintSet.from_tree({"w": shard(data["x"])}, device="cpu")
local = cs.stacks[0].to_local()
state = opt.init(cs)
step = api.constraint_step(opt)
calls = []
for i in range(3):
    before = sh.all_reduce_payload.calls
    gs = api.ConstraintSet.from_tree({"w": shard(data[f"g{i}"])}, device="cpu")
    cs, state, health = step(cs, state, gs)
    calls.append(sh.all_reduce_payload.calls - before)
    if i == 0:
        want = tree["w"].to_local() + upd["w"].to_local()
        functional &= torch.allclose(cs.stacks[0].to_local(), want, atol=1e-6, rtol=0)
mu, nu, _ = optim.resolve_fused_base(bases[base]).get_slots(state.base_state)
guarded = api.orthogonal(method, learning_rate=lr, use_kernel=True,
                         base_optimizer=bases[base],
                         watchdog=api.WatchdogConfig(), **kw)
try:
    api.constraint_step(guarded)(cs, guarded.init(cs), gs)
    refused = ""
except NotImplementedError as e:
    refused = str(e)
np.savez(f"{tmp}/out{rank}.npz", x=cs.stacks[0].to_local().numpy(),
         mu=mu.stacks[0].to_local().numpy(),
         dist=state.last_distance.per_group[0].numpy(),
         nu=np.zeros(0) if nu is None else nu.stacks[0].to_local().numpy())
print(json.dumps({"rank": rank, "calls": calls, "functional": functional,
                  "in_place": cs.stacks[0].to_local().data_ptr() == local.data_ptr(),
                  "finite": bool(health.finite), "refused": refused}), flush=True)
dist.destroy_process_group()
"""


def _jax_three_steps(x, gs, method, base, lr, width, n_pad):
    """Three steps of JAX's single-device TP schedule on the zero-padded
    stack, the state threaded as the driver threads it."""
    b, _, n = x.shape
    pad = ((0, 0), (0, 0), (0, n_pad - n))
    xj = jnp.asarray(np.pad(x, pad))
    mu = jnp.zeros_like(xj)
    nu = jnp.zeros((b,), jnp.float32)
    kw = dict(base_kind="trace", hyper=(0.9, False)) if base == "trace" else \
        dict(base_kind="vadam", hyper=(0.9, 0.999, 1e-8))
    for i, g in enumerate(gs):
        xj, mu, nu2, dist, _ = jops.fused_group_step_tp(
            xj, jnp.asarray(np.pad(g, pad)), lr, method=method,
            lam=METHODS[method], mu=mu,
            nu=nu if base == "vadam" else None,
            count=jnp.asarray(i, jnp.int32) if base == "vadam" else None,
            tp_shards=width, **kw)
        nu = nu2 if nu2 is not None else nu
    return (np.asarray(xj)[..., :n], np.asarray(mu)[..., :n], np.asarray(nu),
            np.asarray(dist))


@pytest.mark.parametrize("world,dp,shape,method,base", [
    (2, 1, (3, 8, 40), "pogo", "vadam"),
    (2, 1, (3, 8, 42), "landing", "trace"),  # padded: 21 columns a rank -> 24
    (4, 2, (4, 8, 40), "landing", "vadam"),
    (4, 2, (4, 8, 41), "pogo", "trace"),  # padded, and an uneven split
], ids=["2rank-pogo-vadam", "2rank-landing-trace-padded",
        "4rank-landing-vadam", "4rank-pogo-trace-padded"])
def test_gloo_tp_route_matches_jax(tmp_path, world, dp, shape, method, base):
    """Three ``constraint_step``\\ s on ``world`` gloo ranks: one all-reduce
    per group per step on every rank, X' and mu' written in place into
    the local blocks, and every rank's blocks equal to JAX's single-device
    TP schedule's on its rows and columns. The functional ``update`` on a
    tree of the same DTensor leaves returns DTensor updates that match the
    first in-place step to 1e-6 (``x + (x' - x)`` rounds once more)."""
    rng = np.random.default_rng(7)
    b, p, n = shape
    q, _ = np.linalg.qr(rng.standard_normal((b, n, p)))
    x = np.ascontiguousarray(np.swapaxes(q, -1, -2), np.float32)
    gs = [(0.05 * rng.standard_normal(shape)).astype(np.float32) for _ in range(3)]
    np.savez(tmp_path / "in.npz", x=x, **{f"g{i}": g for i, g in enumerate(gs)})
    lr = 0.1
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(dp), str(tmp_path),
         method, base, str(lr)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    width = world // dp
    wx, wmu, wnu, wdist = _jax_three_steps(x, gs, method, base, lr, width,
                                           width * -(-n // width))
    cols = np.array_split(np.arange(n), width)  # torch.chunk's split of n
    rows = np.array_split(np.arange(b), dp)
    for r, info in enumerate(outs):
        assert info["calls"] == [1, 1, 1], info  # one group, three steps
        assert info["in_place"] and info["finite"] and info["functional"], info
        assert "sharded schedules" in info["refused"], info
        got = np.load(tmp_path / f"out{r}.npz")
        d, m = divmod(r, width)
        sel = np.ix_(rows[d], np.arange(p), cols[m])
        np.testing.assert_allclose(got["x"], wx[sel], err_msg=f"rank {r} x", **TOL)
        np.testing.assert_allclose(got["mu"], wmu[sel], err_msg=f"rank {r} mu", **TOL)
        np.testing.assert_allclose(got["dist"], wdist[rows[d]],
                                   err_msg=f"rank {r} dist", **TOL)
        if base == "vadam":
            np.testing.assert_allclose(got["nu"], wnu[rows[d]],
                                       err_msg=f"rank {r} nu", **TOL)
