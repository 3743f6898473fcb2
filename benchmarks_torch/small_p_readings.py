#!/usr/bin/env python3
"""The cluster kernel of ``csrc/small_p.cu`` on the card, its four entries
beside the routes below them, in one call.

    python3 benchmarks_torch/small_p_readings.py [--shape B,P,N ...]
        [--rounds 3] [--check-only] [--source LABEL=PATH ...]
    python3 benchmarks_torch/small_p_readings.py --ns [--shape B,P,N ...]
        [--source LABEL=PATH ...] [--split] [--rounds 3]
    python3 benchmarks_torch/small_p_readings.py --ns --idle [--shape B,P,N ...]
        [--source LABEL=PATH ...] [--rounds 3]

Builds ``small_p.cu`` with the sources it is timed against and prints its
ptxas lines (registers, spills), then runs ``chip_smoke.py``'s
``phase_cluster_crossovers`` at each ``--shape`` (default the paper's 1048 x
(10, 10000) and the script's ``CLUSTER_READINGS``): fused POGO over
trace(0.9), the POGO update, fused Landing over trace(0.1) and the landing
field on the cluster kernel, checked against the plain version (3e-5 /
1e-4 for the fused step, 2e-5 / 1e-4 for the two-stage entries), timed in
turns with the CUDA-core tiled kernels (or the tensor-core ones from
``ops.TC_MIN_P``, Landing's from ``ops.LANDING_TC_MIN_P``), then every
cluster size that fits at the paper's shape. ``--check-only`` checks the
first shape and stops. With ``--source`` (copies of ``csrc/small_p.cu``,
built with ``-I`` of the checkout's ``csrc``; the label ``checkout`` is the
checkout's own) each build's four entries run at each ``--shape`` instead
(default the paper's), checked against the plain version, timed in turns,
with each
build's ptxas lines (``--no-check`` times builds whose results are not
meant to agree, such as a copy with the products taken out, which shows
what the loads, stores and barriers cost alone). Prints the card's name
and power limit. ``--ns`` reads Newton-Schulz's cluster kernel (row 9cl,
``newton_schulz_cluster``) instead, at each ``--shape`` (default
``NS_READINGS``: 1048 x (p, n), p = 4, 10, 16, 24, 28 and 31, n = 2048,
4096 and 10000, and p = 32): at each cluster size that fits, in turns
with row 9 (the CUDA-core tiled kernel) and, at p = 32, with 9tc (the
tensor-core kernel planned there), 12 iterations on the watchdog's drift
(1.5 x a Stiefel draw + 0.05 randn), each held against the plain version
(atol 1e-6), then each as the idle repair (every matrix masked off); with
the clusters the card keeps resident. With ``--source`` each build's
``newton_schulz_cluster`` runs at each ``--shape`` (default the paper's)
instead, at its own cluster size, checked, timed in turns. ``--split``
times timing-only copies of the checkout's source at the paper's shape,
at 0 and 12 iterations (so the difference over 12 is an iteration's
cost), cumulative: ``full`` the source; ``local`` every peer's published
gram read from the CTA's own shared memory (no DSMEM); ``nobar`` the
gram's cluster barrier a CTA barrier; ``nogram`` the gram's products
taken out; ``noupdate`` the update's products taken out too (what is left
is the rounds' loads and stores, the publishing and the CTA barriers).
``--idle`` times the idle repair (every matrix masked off) of each build
(default the checkout's) beside row 9's at each ``--shape`` (default the
paper's): the launch alone on the card, queued behind a sleeping kernel so
that the host's work is hidden, and the repair through
``ops.newton_schulz_repair`` as ``chip_smoke.py`` times it, with the
planner's cache and without it.
Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=[],
                    help="B,P,N (repeatable); default the paper's and CLUSTER_READINGS")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a copy of csrc/small_p.cu (repeatable)")
    ap.add_argument("--ns", action="store_true",
                    help="Newton-Schulz's cluster kernel beside row 9 (and 9tc at p = 32)")
    ap.add_argument("--split", action="store_true",
                    help="with --ns: timing-only copies that take the exchange and the "
                         "products out in turn")
    ap.add_argument("--idle", action="store_true",
                    help="with --ns: the idle repair beside row 9's, the launch alone and "
                         "through the entry")
    ap.add_argument("--no-check", action="store_true",
                    help="time --source builds without holding them to the plain version "
                         "(skeletons that skip work)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("small_p_readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmarks_torch"))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import pogo_update as pu

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card()
    print(card, flush=True)
    fs.cluster_lib()
    fs._lib()
    fs.tc_lib()
    pu.lib()
    for line in build.PTXAS_LOG.get("small_p", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas[small_p] {line.strip()}", flush=True)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.ns and args.idle:
        _ns_idle(args, shapes or [chip_smoke.PAPER_SHAPE], gen, chip_smoke)
    elif args.ns and (args.source or args.split):
        _ns_variants(args, shapes or [chip_smoke.PAPER_SHAPE], gen, chip_smoke)
    elif args.ns:
        _ns_readings(shapes or NS_READINGS, gen, chip_smoke, args.rounds)
    if args.ns:
        print(card, flush=True)
        return 0
    if args.source:
        _variants(args, shapes or [chip_smoke.PAPER_SHAPE], gen, chip_smoke)
        print(card, flush=True)
        return 0
    shapes = shapes or [chip_smoke.PAPER_SHAPE, *chip_smoke.CLUSTER_READINGS]
    chip_smoke.phase_cluster_crossovers(gen, shapes[:1] if args.check_only else shapes,
                                        rounds=1 if args.check_only else args.rounds)
    print(card, flush=True)
    return 0


def _variants(args, shapes, gen, chip_smoke):
    """Each ``--source`` build's four entries at each shape, in turns."""
    import ctypes
    import functools

    import torch
    from kernel_variants import _build
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import pogo_update as pu
    from repro_torch.kernels import ref

    os.makedirs(os.path.join(ROOT, "build", "kernel_variants"), exist_ok=True)
    libs = {}
    for label, path in (s.split("=", 1) for s in args.source):
        if label == "checkout":
            libs[label] = fs.cluster_lib()
            continue
        _, so, regs = _build(label, path, ("-", "-"), build, includes=(str(build.CSRC),))
        for line in regs:
            print(f"ptxas[{label}] {line}", flush=True)
        lib = ctypes.CDLL(so)
        for entry in ("fused_step_cluster", "pogo_update_cluster", "landing_field_cluster"):
            getattr(lib, entry).argtypes = getattr(fs.cluster_lib(), entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[label] = lib
    kw = dict(method="pogo", lam=0.5, base_kind="trace", hyper=(0.9, False), post_scale=1.0,
              nu=None, count=None, pv=None)
    lkw = dict(kw, method="landing", lam=1.0, hyper=(0.1, False))
    lr, llr = chip_smoke.LR, chip_smoke.LANDING_LR
    for b, p, n in shapes:
        x, g, mu, _ = chip_smoke._operands(gen, b, p, n)
        xl = x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        wants = (ref.fused_group_step_ref(x, g, lr, mu=mu, **kw),
                 (ref.pogo_update_ref(x, g, lr, 0.5),),
                 ref.fused_group_step_ref(xl, g, llr, mu=mu, **lkw),
                 (ref.landing_field_ref(xl, g, 1.0),))
        fns = []
        for label, lib in libs.items():
            def own(lib=lib):
                return lib
            entries = (
                functools.partial(fs._launch, lib.fused_step_cluster, x, g, lr, mu=mu,
                                  inplace=False, extra=(0,), **kw),
                functools.partial(pu.launch, "pogo_update_cluster", x, g, lr, 0.5,
                                  torch.empty_like(x), 0, lib=own),
                functools.partial(fs._launch, lib.fused_step_cluster, xl, g, llr, mu=mu,
                                  inplace=False, extra=(0,), **lkw),
                functools.partial(pu.launch, "landing_field_cluster", xl, g, 0.0, 1.0,
                                  torch.empty_like(x), 0, lib=own))
            tols = (chip_smoke.TILED_TOL, chip_smoke.TWO_STAGE_TILED_TOL) * 2
            for what, fn, w, tol in zip(ENTRIES, entries, wants, tols):
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                if not args.no_check and not chip_smoke._errors(got, w, tol)[2]:
                    raise SystemExit(f"{label} {what} at {(b, p, n)} disagrees")
            fns += [(fn, 10) for fn in entries]
        t = chip_smoke._time_rotating(fns, args.rounds)
        k = len(ENTRIES)
        for i, label in enumerate(libs):
            times = ", ".join(f"{what} {v:.4f} ms" for what, v in zip(ENTRIES, t[k * i:]))
            print(f"variant {label} {b}x({p},{n}): {times}", flush=True)
        del x, g, mu, xl, wants


ENTRIES = ("fused POGO", "POGO update", "fused Landing", "field")
NS_READINGS = [(1048, p, n) for p in (4, 10, 16, 24, 28, 31) for n in (2048, 4096, 10000)] + [
    (1048, 32, n) for n in (2048, 4096)]


def _ns_readings(shapes, gen, chip_smoke, rounds):
    """Row 9cl at each cluster size that fits, in turns with row 9 (and 9tc
    at p = 32), checked, timed, then idle."""
    import functools

    import torch
    from repro_torch.core import stiefel
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops, ref

    iters = chip_smoke.NS_ITERS
    for b, p, n in shapes:
        x = 1.5 * stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        x += 0.05 * torch.randn((b, p, n), generator=gen, device="cuda")
        want = ref.newton_schulz_ref(x, iters)
        out = torch.empty_like(x)
        kernels = [("row 9", functools.partial(ns.newton_schulz_tiled,
                                               tile_n=ops.ns_tiled_tile_n(p)))]
        if p >= ops.NS_TC_MIN_P and ops.ns_tc_cluster(n):
            kernels.append(("9tc", ns.newton_schulz_tc))
        resident = {}
        for c in (2, 4, 8):
            clusters = fs.cluster_lib().ns_cluster_max_clusters(p, n, c)
            if clusters > 0:
                kernels.append((f"9cl c={c}", functools.partial(ns.newton_schulz_cluster,
                                                                cluster=c)))
                resident[c] = clusters
        for label, k in kernels:
            max_abs, _, ok = chip_smoke._errors((k(x, iters, out=out),), (want,),
                                                chip_smoke.NS_TOL)
            if not ok:
                raise SystemExit(f"{label} at {(b, p, n)} disagrees: {max_abs:.3e}")
        calls = max(2, min(20, int(2000 / (b * p * n * 1e-6))))
        times = chip_smoke._time_rotating(
            [(functools.partial(k, x, iters, out=out), calls) for _, k in kernels], rounds)
        none = torch.zeros(b, dtype=torch.bool, device="cuda")
        idle = [chip_smoke._time_ms(functools.partial(k, x, iters, out=x, mask=none), 20)
                for _, k in kernels]
        planned = ops.plan_newton_schulz(p, n)
        print(f"ns readings {b}x({p},{n}), planned {planned}, own cluster "
              f"{ops.ns_cluster(p, n)}, resident clusters {resident}: " + ", ".join(
                  f"{label} {t:.4f} ms (idle {i:.4f})"
                  for (label, _), t, i in zip(kernels, times, idle)), flush=True)
        del x, want, out


# (label, [(old, new), ...]) edits of small_p.cu, cumulative, each expected
# in the source: the timing-only copies of --split.
NS_SPLITS = [
    ("full", []),
    ("local", [("v[k] = k == rank ? lds4(pub + e) : "
                "hopper::ld_peer4(hopper::map_peer(pub + e, k));", "v[k] = lds4(pub + e);")]),
    ("nobar", [("  hopper::cluster_sync();\n  ns_sum(set, G, PB * PB, c, rank);",
                "  __syncthreads();\n  ns_sum(set, G, PB * PB, c, rank);")]),
    ("nogram", [("  if (!act) return;\n  if (bj1 == bi)", "  return;\n  if (bj1 == bi)")]),
    ("noupdate", [("    float gy[KC] = {};\n    if (apply)",
                   "    float gy[KC] = {};\n    if (false)")]),
]


def _ns_libs(sources):
    """``{label: library}`` of ``(label, path)`` copies of small_p.cu, built
    at once (``checkout`` the checkout's own), each with its spill count."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from kernel_variants import OUT, _build
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs

    os.makedirs(OUT, exist_ok=True)

    def make(job):
        label, path = job
        if label == "checkout":
            return label, fs.cluster_lib()
        _, so, regs = _build(label, path, (), build, includes=(str(build.CSRC),))
        spills = [line for line in regs
                  if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"ptxas[{label}]: {len(spills)} of the build's kernels spill", flush=True)
        lib = ctypes.CDLL(so)
        lib.newton_schulz_cluster_c.argtypes = fs.cluster_lib().newton_schulz_cluster_c.argtypes
        lib.newton_schulz_cluster_c.restype = ctypes.c_int
        return label, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(make, sources))


def _ns_variants(args, shapes, gen, chip_smoke):
    """``--source`` builds of small_p.cu at each shape, or ``--split``'s
    timing-only copies at the paper's, in turns."""
    import functools

    import torch
    from kernel_variants import OUT
    from repro_torch.core import stiefel
    from repro_torch.kernels import build
    from repro_torch.kernels import ops, ref

    os.makedirs(OUT, exist_ok=True)
    sources = [tuple(v.split("=", 1)) for v in args.source]
    if args.split:
        src = (build.CSRC / "small_p.cu").read_text()
        sources = []
        for label, edits in NS_SPLITS:
            for old, new in edits:
                if old not in src:
                    raise SystemExit(f"small_p_readings: {label}'s edit {old!r} not in the source")
                src = src.replace(old, new)
            path = os.path.join(OUT, f"ns_split_{label}.cu")
            with open(path, "w") as f:
                f.write(src)
            sources.append((label, path))

    libs = _ns_libs(sources)
    iters = chip_smoke.NS_ITERS
    stream = torch.cuda.current_stream().cuda_stream
    for b, p, n in shapes:
        c = ops.ns_cluster(p, n)
        x = 1.5 * stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        x += 0.05 * torch.randn((b, p, n), generator=gen, device="cuda")
        out = torch.empty_like(x)
        want = ref.newton_schulz_ref(x, iters)

        def run(lib, k):
            err = lib.newton_schulz_cluster_c(x.data_ptr(), out.data_ptr(), None, None, b, p, n,
                                              k, c, stream)
            if err:
                raise SystemExit(f"newton_schulz_cluster variant failed: cudaError {err}")

        for label, lib in libs.items():
            if not args.split:
                run(lib, iters)
                max_abs, _, ok = chip_smoke._errors((out,), (want,), chip_smoke.NS_TOL)
                if not ok and not args.no_check:
                    raise SystemExit(f"{label} at {(b, p, n)} disagrees: {max_abs:.3e}")
        counts = (0, iters) if args.split else (iters,)
        fns = [(functools.partial(run, lib, k), 10) for lib in libs.values() for k in counts]
        times = chip_smoke._time_rotating(fns, args.rounds)
        print(f"ns variants {b}x({p},{n}), clusters of {c}:", flush=True)
        for i, label in enumerate(libs):
            t = times[len(counts) * i:len(counts) * (i + 1)]
            if args.split:
                print(f"  {label}: {t[0]:.4f} / {t[1]:.4f} ms at 0 / {iters} iterations, "
                      f"{(t[1] - t[0]) / iters:.4f} ms an iteration", flush=True)
            else:
                print(f"  {label}: {t[0]:.4f} ms", flush=True)
        del x, out, want


def _queued_ms(fn, calls=100, cycles=20_000_000):
    """The card's time a call of ``fn``: ``calls`` calls queued behind a
    kernel that sleeps ``cycles`` clocks (about 10 ms on an H100), so that
    the host has issued them all before the first runs; None when it had
    not (the host's work would show)."""
    import time

    import torch

    fn()
    before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    before.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if 1e3 * issued >= before.elapsed_time(start):
        return None
    return start.elapsed_time(end) / calls


def _ns_idle(args, shapes, gen, chip_smoke):
    """Row 9cl's idle repair (every matrix masked off, the watchdog's launch
    on every undrifted step) beside row 9's, at each shape: each launch
    alone on the card (``_queued_ms``, in turns, the median of
    ``--rounds``) for each ``--source`` build, and the repair through
    ``ops.newton_schulz_repair`` as ``chip_smoke.py`` times it
    (``_idle_in_turns``), with the planner's cache and without it, and the
    planner's host time."""
    import functools
    import statistics
    import timeit

    import torch
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops

    libs = _ns_libs([tuple(v.split("=", 1)) for v in args.source] or [("checkout", "")])
    iters = chip_smoke.NS_ITERS
    stream = torch.cuda.current_stream().cuda_stream
    for b, p, n in shapes:
        c = ops.ns_cluster(p, n)
        x = torch.randn((b, p, n), generator=gen, device="cuda")
        x0 = x.clone()
        none = torch.zeros(b, dtype=torch.bool, device="cuda")

        def launch(lib):
            err = lib.newton_schulz_cluster_c(x.data_ptr(), x.data_ptr(), none.data_ptr(), None,
                                              b, p, n, iters, c, stream)
            if err:
                raise SystemExit(f"newton_schulz_cluster failed: cudaError {err}")

        fns = [(label, functools.partial(launch, lib)) for label, lib in libs.items()]
        fns.append(("row 9", functools.partial(ns.newton_schulz_tiled, x, iters, out=x,
                                               tile_n=ops.ns_tiled_tile_n(p), mask=none)))
        device = {label: [] for label, _ in fns}
        for i in range(args.rounds):
            for label, fn in (fns if i % 2 == 0 else fns[::-1]):
                device[label].append(_queued_ms(fn))
        if not torch.equal(x, x0):
            raise SystemExit(f"an idle launch at {(b, p, n)} wrote a matrix")
        alone = ", ".join(
            f"{label} {statistics.median(t):.4f}" if None not in t else f"{label} not measured"
            for label, t in device.items())
        dist, thresh = torch.zeros(b, device="cuda"), torch.tensor(0.1, device="cuda")

        def idle_repair():
            ops.newton_schulz_repair(x, dist, thresh, iters)

        cached = chip_smoke._idle_in_turns(idle_repair, p)
        planner = ops.plan_newton_schulz
        ops.plan_newton_schulz = planner.__wrapped__
        try:
            uncached = chip_smoke._idle_in_turns(idle_repair, p)
            plan_us = 1e6 * min(timeit.repeat(lambda: ops.plan_newton_schulz(p, n), number=1000,
                                              repeat=5)) / 1000
        finally:
            ops.plan_newton_schulz = planner
        print(f"ns idle {b}x({p},{n}), clusters of {c}: the launch alone on the card (ms) "
              f"{alone}; through ops.newton_schulz_repair 9cl / row 9 {cached[0]:.4f} / "
              f"{cached[1]:.4f} ms, without the planner's cache {uncached[0]:.4f} / "
              f"{uncached[1]:.4f} ms (the planner {plan_us:.2f} us a call uncached)", flush=True)
        del x, x0


if __name__ == "__main__":
    sys.exit(main())
