#!/usr/bin/env python3
"""The large route on the card: its tensor-core kernels beside its CUDA-core
ones, in one call.

    python3 benchmarks_torch/large_tc_readings.py [--shape B,P,N ...]
        [--ns-shape B,P,N ...] [--reps 3] [--iters 10] [--check-only]

At each ``--shape`` (default the paper's CNN filters 3 x (256, 2304) and
O-ViT 18 x (1024, 1024)) the four large entries, fused POGO over
trace(0.9), fused Landing over trace(0.1), the POGO update and the landing
field, each on the tensor cores (``*_large_tc``, ``csrc/large_p.cu``'s
3xTF32 ``wgmma`` kernels) and on the CUDA cores (``*_large``), held
against the plain version (fused 3e-5 / 1e-4, two-stage 2e-5 / 1e-4),
then timed in turns with it (tensor cores, CUDA cores, CUDA cores,
tensor cores, ...), with the CUDA launches of a call. At each
``--ns-shape`` (default O-ViT's and internlm2-1.8b's 576 x (128, 2048))
Newton-Schulz, 12 iterations on the watchdog's drifted input (1.5 x
Stiefel plus 0.05 randn, a tenth of it at a square matrix), held against
the plain version (atol 1e-6): the large route on the tensor cores beside
the CUDA-core one (past p = 128) or row 9's tiled kernel (p <= 128),
each also timed as the repair with no matrix past the threshold (every
matrix masked off), and the CUDA-core large route's idle repair as its
Python loop issued it before the loop moved into C. Prints the median,
least and most of ``--reps`` CUDA-event timings of ``--iters`` calls, the
ptxas lines of ``large_p.cu``, and the card's name and power limit. Needs
one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED_TOL = dict(atol=3e-5, rtol=1e-4)
TWO_STAGE_TOL = dict(atol=2e-5, rtol=1e-4)
NS_TOL = dict(atol=1e-6, rtol=0.0)
NS_ITERS = 12


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def _in_turns(runs, reps, iters):
    """``{label: [ms, ...]}`` over ``reps`` rounds whose order reverses
    every round."""
    times = {k: [] for k in runs}
    order = list(runs)
    for r in range(reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(_time_ms(runs[k], iters))
    return times


def _stats(ts):
    return f"median {statistics.median(ts):.4f} min {min(ts):.4f} max {max(ts):.4f}"


def _close(got, want, tol):
    import torch

    err = max(float((a - w).abs().max()) for a, w in zip(got, want) if w is not None)
    ok = all(bool(torch.all((a - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()))
             for a, w in zip(got, want) if w is not None)
    return err, ok


def _python_loop_ns(large_p, x, iters, out, mask):
    """The CUDA-core large route's Newton-Schulz as its Python loop issued
    it (a gram and an apply an iteration, from Python)."""
    import torch

    run = large_p.runner(x)
    tmp = torch.empty_like(x)
    src = x
    for k in range(1, iters + 1):
        dst = out if (iters - k) % 2 == 0 else tmp
        gm = large_p.gram(run, src, mask=mask)[0]
        large_p.apply(run, "ns", gm, src, dst, scal=None, mask=mask, first=k == 1)
        src = dst
    return out


def _phases(large_p, x, g, mu, reps, iters):
    """Each launch of a fused POGO step over trace(0.9) on the tensor cores,
    timed alone, beside its 3xTF32 tensor work at 495 TFLOP/s."""
    import torch

    from repro_torch.kernels import fused_step as fs

    b, p, n = x.shape
    run = large_p.runner(x)
    scal = fs.pack_scal(0.1, 0.5, base_kind="trace", hyper=(0.9, False), post_scale=1.0,
                        count=None, device=x.device)
    mu2, geu, _ = large_p.base_stage(run, g, mu, scal, "trace", False)
    ea, ea_lo, _ = large_p.gram_tc(run, x)
    bb, bb_lo, _ = large_p.gram_tc(run, x, g=geu)
    m = torch.empty_like(x)
    large_p.apply_tc(run, "leap", ea, ea_lo, geu, m, pb=bb, pb_lo=bb_lo, x=x, scal=scal)
    e, e_lo, _ = large_p.gram_tc(run, m)
    xo = torch.empty_like(x)
    pq = large_p.tc_padded(p)
    sym = large_p.tc_gram_blocks(p, False) / large_p.tc_gram_blocks(p, True)  # of a full gram
    sym2 = sym
    work = {  # p x p x n products, each 2 p^2 n flops, x 3 (3xTF32)
        "base stage (mu')": (0.0, lambda: large_p.base_stage(run, g, mu, scal, "trace", False)),
        "phase 1 self gram (E_A)": (sym, lambda: large_p.gram_tc(run, x)),
        "phase 1 cross gram (B)": (1.0, lambda: large_p.gram_tc(run, x, g=geu)),
        "leap apply": (2.0, lambda: large_p.apply_tc(run, "leap", ea, ea_lo, geu, m, pb=bb,
                                                     pb_lo=bb_lo, x=x, scal=scal)),
        "C gram": (sym, lambda: large_p.gram_tc(run, m)),
        "land apply": (1.0, lambda: large_p.apply_tc(run, "land", e, e_lo, m, xo, scal=scal)),
        "distance (E^2, E^3)": (None, lambda: large_p._gram_identity_tc(run, e, e_lo, 0.5, p,
                                                                         None)),
    }
    times = _in_turns({k: f for k, (_, f) in work.items()}, reps, iters)
    for label, ts in times.items():
        products = work[label][0]
        flops = (2 * pq**3 * (sym2 + 1.0) if products is None else 2 * products * p * p * n) * b
        print(f"  phase {label} {b}x({p},{n}): ms {_stats(ts)}; 3xTF32 tensor work "
              f"{1e3 * 3 * flops / 495e12:.4f} ms", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--ns-shape", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("large_tc_readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import stiefel
    from repro_torch.kernels import build, large_p, ref
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import pogo_update as pu

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    large_p.lib()
    for line in build.PTXAS_LOG.get("large_p", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas[large_p] {line.strip()}", flush=True)
    shapes = [tuple(map(int, s.split(","))) for s in args.shape] or [
        (3, 256, 2304), (18, 1024, 1024)]
    ns_shapes = [tuple(map(int, s.split(","))) for s in args.ns_shape] or [
        (18, 1024, 1024), (576, 128, 2048)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for shape in shapes:
        b, p, n = shape
        x = stiefel.random_stiefel(gen, shape, device="cuda")
        g = 0.2 * torch.randn(shape, generator=gen, device="cuda")
        mu = 0.1 * torch.randn(shape, generator=gen, device="cuda")
        xl = x + 0.01 * torch.randn(shape, generator=gen, device="cuda")
        entries = []
        for method, hyper, lam, xin in (("pogo", (0.9, False), 0.5, x),
                                        ("landing", (0.1, False), 1.0, xl)):
            kw = dict(method=method, lam=lam, base_kind="trace", hyper=hyper, mu=mu)
            entries.append((f"fused {method}", FUSED_TOL,
                            functools.partial(ref.fused_group_step_ref, xin, g, 0.1, **kw),
                            functools.partial(fs.fused_step_large_tc, xin, g, 0.1, **kw),
                            functools.partial(fs.fused_step_large, xin, g, 0.1, **kw), 4))
        entries.append(("pogo update", TWO_STAGE_TOL,
                        functools.partial(ref.pogo_update_ref, xl, g, 0.1, 0.5),
                        functools.partial(pu.pogo_update_large_tc, xl, g, 0.1, 0.5),
                        functools.partial(pu.pogo_update_large, xl, g, 0.1, 0.5), 1))
        entries.append(("landing field", TWO_STAGE_TOL,
                        functools.partial(ref.landing_field_ref, xl, g, 1.0),
                        functools.partial(lf.landing_field_large_tc, xl, g, 1.0),
                        functools.partial(lf.landing_field_large, xl, g, 1.0), 1))
        for label, tol, plain, tc, cc, outs in entries:
            want = plain()
            want = want[:outs] if outs > 1 else (want,)
            res = {}
            for route, fn in (("tensor cores", tc), ("CUDA cores", cc)):
                got = fn()
                torch.cuda.synchronize()
                got = got[:outs] if outs > 1 else (got,)
                err, ok = _close(got, want, tol)
                bad += not ok
                by = [f"{float((a - w).abs().max()):.3e}" for a, w in zip(got, want)
                      if w is not None]
                counted = large_p.runner(x)
                fn(runner=counted)
                res[route] = counted.launches
                print(f"{label} {b}x({p},{n}) {route}: max_abs {err:.3e} by output {by} "
                      f"(atol {tol['atol']}, rtol {tol['rtol']}) {'ok' if ok else 'MISMATCH'}; "
                      f"CUDA launches a call {counted.launches}", flush=True)
            if args.check_only:
                continue
            times = _in_turns({"tensor cores": tc, "CUDA cores": cc}, args.reps, args.iters)
            plain_ms = _time_ms(plain, 3)
            for route, ts in times.items():
                print(f"  {label} {b}x({p},{n}) {route}: ms {_stats(ts)}", flush=True)
            print(f"  {label} {b}x({p},{n}) plain: ms {plain_ms:.4f}", flush=True)
        if not args.check_only:
            _phases(large_p, x, g, mu, args.reps, args.iters)
        del x, g, mu, xl
    for shape in ns_shapes:
        b, p, n = shape
        x0 = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
        x0 += (0.005 if p == n else 0.05) * torch.randn(shape, generator=gen, device="cuda")
        want = ref.newton_schulz_ref(x0, NS_ITERS)
        out = torch.empty_like(x0)
        other = (ns.newton_schulz_large if p > 128 else
                 functools.partial(ns.newton_schulz_tiled, tile_n=64))
        kernels = {"tensor-core large": ns.newton_schulz_large_tc,
                   "CUDA-core large" if p > 128 else "row 9 tiled": other}
        drift = {k: functools.partial(f, x0, NS_ITERS, out=out) for k, f in kernels.items()}
        for label, fn in drift.items():
            err, ok = _close((fn(),), (want,), NS_TOL)
            torch.cuda.synchronize()
            bad += not ok
            print(f"newton-schulz {b}x({p},{n}) {label}: max_abs {err:.3e} (atol 1e-6) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
        y = x0.clone()
        none = torch.zeros(b, dtype=torch.bool, device="cuda")
        idle = {f"{k} idle": functools.partial(f, y, NS_ITERS, out=y, mask=none)
                for k, f in kernels.items()}
        if p > 128:
            idle["CUDA-core large idle, Python loop"] = functools.partial(
                _python_loop_ns, large_p, y, NS_ITERS, y, none)
        for fn in idle.values():
            fn()
        torch.cuda.synchronize()
        if not torch.equal(y, x0):
            bad += 1
            print(f"newton-schulz {b}x({p},{n}): an idle repair wrote a masked-off matrix")
        if args.check_only:
            continue
        times = _in_turns(drift, args.reps, max(1, args.iters // 3))
        times.update(_in_turns(idle, args.reps, 20))
        for label, ts in times.items():
            print(f"  newton-schulz {b}x({p},{n}) {label}: ms {_stats(ts)}", flush=True)
        del x0, want, out, y
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
