#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card, then drives the port's three main paths with
``constraint_step`` at the full width of SmolLM-360M's constrained q/k
projections (one 640 x (64, 960) stack, the tiled kernels) and at the
many-matrices shape 2048 x (16, 256) (the whole kernels):

* the fused group step, ``orthogonal("pogo", use_kernel=True,
  base_optimizer=chain(trace(0.9)))``;
* POGO over Adam on the two-stage step, ``orthogonal("pogo",
  learning_rate=1e-3, base_optimizer=chain(scale_by_adam()),
  use_kernel=True)``. Adam's output has unit scale per entry, so lr 0.1
  diverges at (64, 960) in both packages
  (``tests/test_torch_two_stage.py::test_pogo_adam_step_size_at_smollm_width``);
* the paper's Landing on the two-stage step, ``orthogonal("landing",
  learning_rate=0.25, base_optimizer=chain(trace(0.1)), use_kernel=True)``
  (lam 1, eps 0.5, exact safe step).

Each path's kernels must launch once per step, its first step must agree
with the plain route, and its feasibility must hold. Any failure exits
non-zero. The second-to-last line is a JSON record of every kernel
(launches on the main path, error against the plain version, times and
bounds); the last line is the device record. Without a CUDA card it exits
2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
WHOLE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_fused_step.py:67
TILED_TOL = dict(atol=3e-5, rtol=1e-4)  # tests/test_fused_step.py:95
# tests/test_kernels.py:34-50 (whole, atol 1e-6) and :65-75 (tiled).
TWO_STAGE_WHOLE_TOL = dict(atol=1e-6, rtol=1e-6)
TWO_STAGE_TILED_TOL = dict(atol=2e-5, rtol=1e-4)
LR = 0.1
GRAD_SCALE = 5e-4  # per-entry gradient std: keeps eta ||R|| near 1e-2
SMOLLM_STEPS = 10
MANY = {"w": (2048, 16, 256)}
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "fused_step_whole": ("fused_step", "src/repro/kernels/fused_step.py:175"),
    "fused_step_tiled": ("fused_step", "src/repro/kernels/fused_step.py:608"),
    "pogo_update_whole": ("two_stage", "src/repro/kernels/pogo_update.py:64"),
    "pogo_update_tiled": ("two_stage", "src/repro/kernels/pogo_update.py:143"),
    "landing_field": ("two_stage", "src/repro/kernels/landing_field.py:42"),
    "landing_field_tiled": ("two_stage", "src/repro/kernels/landing_field.py:79"),
}
# Two-stage kernel -> its flops per matrix over p^2 n: six p x p x n
# products for the POGO update, five for the field.
TWO_STAGE_FLOPS = {"pogo_update_whole": 12, "pogo_update_tiled": 12,
                   "landing_field": 10, "landing_field_tiled": 10}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _errors(got, want, tol):
    """(max abs, max rel, ok) over the outputs that exist; the relative
    error of an output is its max abs error over its largest magnitude."""
    import torch

    max_abs = max_rel = 0.0
    ok = True
    for a, b in zip(got[:4], want[:4]):
        if b is None:
            continue
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float(d.max() / b.abs().max().clamp_min(1e-30)))
        ok &= bool(torch.all(d <= tol["atol"] + tol["rtol"] * b.abs()))
    return max_abs, max_rel, ok


def _time_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_in_turns(kernel, plain, rounds=3):
    """Medians of ``rounds`` timings each of the kernel (20 launches) and
    the plain version (10 calls), taken in turns: plain, kernel, kernel,
    plain, ..."""
    ks, ps = [], []
    for i in range(rounds):
        turns = [(ps, plain, 10), (ks, kernel, 20)]
        for out, fn, iters in (turns if i % 2 == 0 else turns[::-1]):
            out.append(_time_ms(fn, iters))
    return statistics.median(ks), statistics.median(ps)


def _bound_ms(bytes_, flops):
    """Least time for the work: the larger of its bytes over the HBM rate
    and its fp32 operations over the fp32 rate, and which one bounds it."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bound(b, p, n, base_kind):
    """One fused step: 5 HBM passes of the (B, p, n) fp32 operands (read X,
    g, mu; write X', mu') plus the per-matrix scalars, against six
    p x p x n products (12 p^2 n flops per matrix)."""
    passes = 5 if base_kind != "none" else 3
    scalars = (3 if base_kind == "vadam" else 1) * b * 4
    return _bound_ms(passes * b * p * n * 4 + scalars, 12 * p * p * n * b)


def _operands(gen, b, p, n):
    import torch

    from repro_torch.core import stiefel

    x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
    g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
    mu = 0.1 * torch.randn((b, p, n), generator=gen, device="cuda")
    nu = torch.rand((b,), generator=gen, device="cuda")
    return x, g, mu, nu


def phase_fused_kernels(gen):
    """Each fused kernel against the plain version at the main-path shapes."""
    import torch

    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ops, ref

    cases = [
        ("fused_step_whole", 2048, 16, 256, "trace", (0.9, False)),
        ("fused_step_whole", 256, 16, 256, "vadam", (0.9, 0.999, 1e-8)),
        ("fused_step_whole", 256, 16, 256, "none", ()),
        ("fused_step_tiled", 640, 64, 960, "trace", (0.9, False)),
        ("fused_step_tiled", 640, 64, 960, "vadam", (0.9, 0.999, 1e-8)),
        ("fused_step_tiled", 640, 64, 960, "trace", (0.9, True)),
    ]
    records = {}
    for name, b, p, n, base, hyper in cases:
        x, g, mu, nu = _operands(gen, b, p, n)
        kw = dict(method="pogo", lam=0.5, base_kind=base, hyper=hyper,
                  mu=mu if base != "none" else None,
                  nu=nu if base == "vadam" else None,
                  count=torch.tensor(3, dtype=torch.int32, device="cuda"))
        tol = WHOLE_TOL if name.endswith("whole") else TILED_TOL
        kind, tile_n = ops.plan(p, n)  # the tile the main path runs
        if f"fused_step_{kind}" != name:
            raise SystemExit(f"the planner picks {kind} for ({p}, {n}), not {name}")
        wrapper = getattr(fs, name)
        if kind == "tiled":
            wrapper = functools.partial(wrapper, tile_n=tile_n)
        got = wrapper(x, g, LR, **kw)
        torch.cuda.synchronize()
        want = ref.fused_group_step_ref(x, g, LR, **kw)
        max_abs, max_rel, ok = _errors(got, want, tol)
        print(f"kernel {name} {b}x({p},{n}) {base}{hyper}: max_abs {max_abs:.3e} "
              f"max_rel {max_rel:.3e} (atol {tol['atol']}, rtol {tol['rtol']}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
        if name not in records:  # the first case of each kernel is its main-path shape
            ms, plain_ms = _time_in_turns(
                lambda: wrapper(x, g, LR, **kw),
                lambda: ref.fused_group_step_ref(x, g, LR, **kw))
            bound_ms, bound_by = _bound(b, p, n, base)
            print(f"  {name} tile_n {tile_n} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                  f"{bound_ms:.4f} ({bound_by})", flush=True)
            records[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
        del x, g, mu, nu, got, want
    return records


def phase_two_stage_kernels(gen):
    """Each two-stage kernel against its plain version at its main-path
    shape (timed, with its bound) and at a ragged shape, 7 x (10, 250).
    X is a Stiefel draw plus 0.01 randn, and the check first shows that
    dropping lam's term would break the tolerance."""
    import torch

    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pogo_update as pu

    records = {}
    for name in TWO_STAGE_FLOPS:
        pogo = name.startswith("pogo")
        tiled = name.endswith("tiled")
        planner = ops.plan_pogo_update if pogo else ops.plan_landing_field
        b, p, n = (640, 64, 960) if tiled else (2048, 16, 256)
        kind, tile_n = planner(p, n)
        if (kind == "tiled") != tiled:
            raise SystemExit(f"the planner picks {kind} for ({p}, {n}), not {name}")
        wrapper = getattr(pu if pogo else lf, name)
        if tiled:
            wrapper = functools.partial(wrapper, tile_n=tile_n)
        if pogo:
            def run(x, g, wrapper=wrapper):
                return wrapper(x, g, LR, 0.5)

            def plain(x, g, lam=0.5):
                return ref.pogo_update_ref(x, g, LR, lam)
        else:
            def run(x, g, wrapper=wrapper):
                return wrapper(x, g, 1.0)

            def plain(x, g, lam=1.0):
                return ref.landing_field_ref(x, g, lam)
        tol = TWO_STAGE_TILED_TOL if tiled else TWO_STAGE_WHOLE_TOL
        for shape in ((b, p, n), (7, 10, 250)):
            x, g, _, _ = _operands(gen, *shape)
            # Off the manifold, so that lam's term (the land stage's
            # lam (M M^T - I) M, the field's lam (A X - X)) is visible.
            x += 0.01 * torch.randn(shape, generator=gen, device="cuda")
            got = run(x, g)
            torch.cuda.synchronize()
            want = plain(x, g)
            without = plain(x, g, lam=0.0)
            if _errors((without,), (want,), tol)[2]:
                raise SystemExit(f"{name} {shape}: the check cannot see lam's term")
            max_abs, max_rel, ok = _errors((got,), (want,), tol)
            print(f"kernel {name} {shape[0]}x{shape[1:]} tile_n {tile_n}: max_abs "
                  f"{max_abs:.3e} max_rel {max_rel:.3e} (atol {tol['atol']}, rtol "
                  f"{tol['rtol']}; lam's term up to {float((want - without).abs().max()):.1e}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version")
            if name not in records:  # the main-path shape comes first
                ms, plain_ms = _time_in_turns(lambda: run(x, g), lambda: plain(x, g))
                # Read X and G, write one result.
                bound_ms, bound_by = _bound_ms(3 * b * p * n * 4,
                                               TWO_STAGE_FLOPS[name] * p * p * n * b)
                print(f"  {name} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                      f"{bound_ms:.4f} ({bound_by})", flush=True)
                records[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
            else:
                records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                                   max_abs)
            del x, g, got, want, without
    return records


def make_opt(path, use_kernel=True):
    """The optimizer of main path ``path`` (``fused``, ``pogo_adam`` or
    ``landing``); ``benchmarks_torch/profile_step.py`` traces the same."""
    from repro_torch.core import api
    from repro_torch.optim import chain, scale_by_adam, trace

    if path == "fused":
        return api.orthogonal("pogo", learning_rate=LR, use_kernel=use_kernel,
                              base_optimizer=chain(trace(0.9)))
    if path == "pogo_adam":
        return api.orthogonal("pogo", learning_rate=1e-3, use_kernel=use_kernel,
                              base_optimizer=chain(scale_by_adam()))
    if path == "landing":
        return api.orthogonal("landing", learning_rate=0.25, use_kernel=use_kernel,
                              base_optimizer=chain(trace(0.1)))
    raise ValueError(f"unknown path {path!r}")


def _clone_state(state):
    from repro_torch import tree

    return state._replace(count=state.count.clone(),
                          base_state=tree.tree_map(lambda t: t.clone(),
                                                   state.base_state))


def drive_main_path(gen, shapes, label, steps, card, make_opt, max_dist):
    """``make_opt(True)`` + ``constraint_step`` on a ConstraintSet of random
    Stiefel leaves: 2 warm-up steps, then ``steps`` counted steps. The first
    counted step is held against the plain route, ``make_opt(False)``'s
    out-of-place update from the same state. Returns the launches of each
    kernel during the counted steps."""
    import torch

    from repro_torch.core import api, stiefel
    from repro_torch.kernels import ops

    params = {k: stiefel.random_stiefel(gen, s, device="cuda") for k, s in shapes.items()}
    cs = api.ConstraintSet.from_tree(params)
    del params
    opt = make_opt(True)
    state = opt.init(cs)
    step = api.constraint_step(opt)
    grads = [
        api.ConstraintSet(cs.plan, [GRAD_SCALE * torch.randn(s.shape, generator=gen,
                                                             device="cuda")
                                    for s in cs.stacks])
        for _ in range(steps + 2)
    ]
    print(f"{label}: {cs}", flush=True)
    for gs in grads[:2]:
        cs, state, health = step(cs, state, gs)
    torch.cuda.synchronize()

    # The plain route's first counted step, from the same state.
    plain = make_opt(False)
    cs0 = api.ConstraintSet(cs.plan, [s.clone() for s in cs.stacks])
    upd, plain_state = plain.update(grads[2], _clone_state(state), cs0)
    want_x = [x + u for x, u in zip(cs0.stacks, upd.stacks)]
    want_d = plain_state.last_distance.per_group
    del cs0, upd, plain_state
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times, dists = [], []
    for i, gs in enumerate(grads[2:]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cs, state, health = step(cs, state, gs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        dist = float(api.max_distance(state))
        dists.append(dist)
        if not bool(health.finite) or not dist <= max_dist:
            raise SystemExit(f"{label} step {i}: finite={bool(health.finite)} "
                             f"max_distance={dist} (limit {max_dist})")
        if i == 0:
            got = tuple(cs.stacks) + tuple(state.last_distance.per_group)
            max_abs, _, ok = _errors(got, tuple(want_x) + tuple(want_d), TILED_TOL)
            print(f"{label} step 0 vs plain route: max_abs {max_abs:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise SystemExit(f"{label}: main path disagrees with the plain route")
            del want_x, want_d
    launches = ops.launches()
    for s in cs.stacks:
        if not bool(torch.isfinite(s).all()):
            raise SystemExit(f"{label}: non-finite stack")
    times.sort()
    print(f"{label}: {steps} steps, median step {times[len(times) // 2]:.4f} ms, "
          f"max_distance per step {[f'{d:.2e}' for d in dists]}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"launches {launches} [{card}]", flush=True)
    return launches


def _expect_launches(label, launches, kernel, steps):
    """``kernel`` launched once per step, and no other kernel."""
    want = {name: (steps if name == kernel else 0) for name in launches}
    if launches != want:
        raise SystemExit(f"{label}: launches {launches}, expected {want}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import smollm_360m
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import pogo_update as pu
    from repro_torch.models import ortho

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per source, together
        list(ex.map(build.compile_source, sources))
    fs._lib()
    pu.lib()
    for name in sources:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = phase_fused_kernels(gen)
    records.update(phase_two_stage_kernels(gen))

    smollm = ortho.orthogonal_leaf_shapes(smollm_360m.config())
    paths = [  # (label, shapes, steps, path, feasibility limit, kernel)
        ("fused smollm-360m q/k", smollm, SMOLLM_STEPS, "fused", 1e-5,
         "fused_step_tiled"),
        ("fused 2048x(16,256)", MANY, 10, "fused", 1e-5, "fused_step_whole"),
        ("pogo+adam smollm-360m q/k", smollm, 10, "pogo_adam", 1e-5,
         "pogo_update_tiled"),
        ("pogo+adam 2048x(16,256)", MANY, 10, "pogo_adam", 1e-5, "pogo_update_whole"),
        ("landing smollm-360m q/k", smollm, 10, "landing", 0.5, "landing_field_tiled"),
        ("landing 2048x(16,256)", MANY, 10, "landing", 0.5, "landing_field"),
    ]
    launches = {}
    for label, shapes, steps, path, max_dist, kernel in paths:
        counts = drive_main_path(gen, shapes, label, steps, card,
                                 functools.partial(make_opt, path), max_dist)
        _expect_launches(label, counts, kernel, steps)
        launches[kernel] = counts[kernel]

    kernels = [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/kernels/csrc/{source}.cu", replaces=replaces,
             launches=launches[name], library_ms=None, **records[name])
        for name, (source, replaces) in KERNELS.items()
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
