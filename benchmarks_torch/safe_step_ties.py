#!/usr/bin/env python3
"""Where Landing's CPU and card runs part after a binding safe step.

    python3 benchmarks_torch/safe_step_ties.py [--steps 3] [--devices cpu,cuda]
        [--offset 0.0]

Runs Landing on the tree of ``tests/test_torch_gpu.py::
test_two_stage_step_on_card_matches_cpu`` (q 6 x (16, 300), tall k
2 x (960, 64), gradients 0.3 randn; X moved ``--offset`` randn off the
manifold, none by default) for ``--steps`` steps, three ways:
fp32 in-place ``constraint_step``s on each of ``--devices`` (the plain
versions on the CPU, the landing-field kernels on the card) and fp64 on
the CPU (the plain route, ``use_kernel=False``) as a third witness. It
records, per step and per matrix, ``a0 = ||X X^T - I||_F^2 - eps^2`` (zero
on the eps-sphere; ``a0 > 0`` is the safe step's "already violating"
test), the eta the safe step chose, and X after the step.

For every matrix it prints the first step after which the two fp32 runs
disagree beyond atol 3e-5 / rtol 1e-4, with a0 and eta of all three runs
at that step, and whether that step was a tie: both fp32 runs saw
``|a0| <= TIE * eps`` and chose etas more than 1e-5 apart (relative).
It also counts, for each fp32 run, the matrices that part from the fp64
run and how many of them part after a tie. ``TIE * eps`` is ten times
a0's fp32 rounding, ``2 eps ||d(X X^T)||_F`` with ``||d(X X^T)||_F``
about 5e-7 at p = 64. Cases (``CASES``): the
paper's Landing, whose safe step binds at step 0; Landing over Adam at
the card test's lr 1e-3 (it never binds); the same at lr 0.1 (it binds).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 3e-5, 1e-4  # the card test's tolerances
TIE = 1e-5
CASES = {  # case -> (base optimizer, orthogonal's keywords)
    "landing_trace": ("trace", dict(learning_rate=0.25)),
    "landing_adam": ("adam", dict(learning_rate=1e-3, eps=0.05)),
    "landing_adam_lr0.1": ("adam", dict(learning_rate=0.1, eps=0.05)),
}


def _problem(dtype, offset):
    import numpy as np

    rng = np.random.default_rng(6)
    params = {"q": np.swapaxes(np.linalg.qr(rng.standard_normal((6, 300, 16)))[0],
                               -1, -2),
              "k": np.linalg.qr(rng.standard_normal((2, 960, 64)))[0]}
    grads = {k: (0.3 * rng.standard_normal(v.shape)).astype(dtype)
             for k, v in params.items()}
    noise = np.random.default_rng(7)
    params = {k: (v + offset * noise.standard_normal(v.shape)).astype(dtype)
              for k, v in params.items()}
    return params, grads


def run(case, device, dtype, steps, offset=0.0):
    """``steps`` Landing steps of ``case`` from X moved ``offset`` randn off
    the manifold: per step, per group, the matrices' (a0, eta, X after the
    step), in fp64 on the CPU."""
    import torch

    from repro_torch import optim
    from repro_torch.core import api

    base, kw = CASES[case]
    params, grads = _problem(dtype, offset)
    opt = api.orthogonal(
        "landing", use_kernel=dtype == "float32",
        base_optimizer=optim.chain(optim.trace(0.1)) if base == "trace"
        else optim.scale_by_adam(), **kw)
    safe_eta, seen = api._safe_eta, []

    def recorded(x, d, eta0, eps):
        eta = safe_eta(x, d, eta0, eps)
        c = x @ x.transpose(-1, -2) - torch.eye(x.shape[-2], dtype=x.dtype,
                                                 device=x.device)
        seen.append((torch.sum(c * c, dim=(-2, -1)) - eps**2, eta.reshape(-1)))
        return eta

    cs = api.ConstraintSet.from_tree(params, device=device)
    gs = api.ConstraintSet.from_tree(grads, device=device)
    state = opt.init(cs)
    step = api.constraint_step(opt)
    out = []
    api._safe_eta = recorded
    try:
        for _ in range(steps):
            seen.clear()
            if dtype == "float32":
                cs, state, _ = step(cs, state, gs)
            else:  # in-place steps take fp32 stacks only
                upd, state = opt.update(gs, state, cs)
                cs = cs.apply(upd)
            out.append([(a0.double().cpu(), eta.double().cpu(), x.double().cpu())
                        for (a0, eta), x in zip(seen, cs.stacks)])
    finally:
        api._safe_eta = safe_eta
    return out


def partings(run_a, run_b, eps):
    """``{(group, matrix): None or (step, tie)}``: the first step after
    which the two runs' X disagree beyond atol/rtol, and whether that step
    was a tie (both ``|a0| <= TIE * eps``, etas apart)."""
    out = {}
    for gi in range(len(run_a[0])):
        for m in range(run_a[0][gi][0].shape[0]):
            out[gi, m] = None
            for s, (step_a, step_b) in enumerate(zip(run_a, run_b)):
                (a0a, etaa, xa), (a0b, etab, xb) = step_a[gi], step_b[gi]
                if bool((xa[m] - xb[m]).abs().le(ATOL + RTOL * xb[m].abs()).all()):
                    continue
                ea, eb = float(etaa[m]), float(etab[m])
                tie = (max(abs(float(a0a[m])), abs(float(a0b[m]))) <= TIE * eps
                       and abs(ea - eb) > 1e-5 * max(ea, eb))
                out[gi, m] = (s, tie)
                break
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--devices", default="cpu,cuda",
                    help="the two fp32 runs to compare (cpu,cuda on the card)")
    ap.add_argument("--offset", type=float, default=0.0,
                    help="start X this many randn off the manifold (the card test "
                         "of ties uses 0.003 and 0.0005)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    first, second = args.devices.split(",")
    if "cuda" in (first, second):
        if not torch.cuda.is_available():
            print("safe_step_ties: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
    for case, (_, kw) in CASES.items():
        eps = kw.get("eps", 0.5)
        names = [f"f32_{first}", f"f32_{second}" + ("_2" if second == first else ""),
                 "f64_cpu"]
        runs = dict(zip(names, (run(case, first, "float32", args.steps, args.offset),
                                run(case, second, "float32", args.steps, args.offset),
                                run(case, "cpu", "float64", args.steps, args.offset))))
        print(f"{case} (eps {eps}, tie |a0| <= {TIE * eps:.1e}, offset {args.offset}): "
              f"{args.steps} steps, runs {names}", flush=True)
        for n in names[:2]:
            parts = [v for v in partings(runs[n], runs["f64_cpu"], eps).values() if v]
            print(f"  {n} against f64_cpu: {len(parts)} matrices part, "
                  f"{sum(tie for _, tie in parts)} of them after a tie", flush=True)
        for (gi, m), part in partings(runs[names[0]], runs[names[1]], eps).items():
            if part is None:
                print(f"  group {gi} matrix {m}: agree at every step", flush=True)
                continue
            s, tie = part
            at = {n: runs[n][s][gi] for n in names}
            print(f"  group {gi} matrix {m}: PARTED after step {s} "
                  f"({'a tie' if tie else 'NOT a tie'}); a0 "
                  + " ".join(f"{n} {float(a[0][m]):+.3e}" for n, a in at.items())
                  + "; eta " + " ".join(f"{n} {float(a[1][m]):.5e}" for n, a in at.items()),
                  flush=True)
        for s in range(args.steps):
            for gi in range(len(runs[names[0]][s])):
                for n in names:
                    a0, eta, _ = runs[n][s][gi]
                    print(f"    step {s} group {gi} {n}: a0 "
                          f"{[f'{v:+.2e}' for v in a0.tolist()]} eta "
                          f"{[f'{v:.4e}' for v in eta.tolist()]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
