#!/usr/bin/env python3
"""Time variants of the tensor-core fused step on the card, in one call.

    python3 benchmarks_torch/tc_variants.py [--source LABEL=PATH ...]
        [--shape B,P,N ...] [--reps 5] [--iters 50]

Builds each ``--source`` (a copy of ``csrc/fused_step_tc.cu``; default the
checkout's own), compiled against the checkout's headers, and runs POGO
over VAdam and Landing over trace(0.1) at each ``--shape`` (default
SmolLM-360M's 640 x (64, 960)) through each build, held against the plain
version (atol 3e-5 / rtol 1e-4), beside the checkout's CUDA-core tiled
kernel (``fused_step_tiled`` at the planner's tile for p, ``ops.tiled_tile_n``)
as a yardstick: the readings that set where ``ops.plan`` sends a p (a
source with the wide kernel, whose launcher takes a park, also runs
64 < p <= 128; one without it only p <= 64). Then
the two-stage entries (``pogo_update_tc``, ``landing_field_tc``; a source
without them is skipped there) at each shape, held against
``ref.pogo_update_ref`` / ``ref.landing_field_ref`` (atol 2e-5 / rtol
1e-4), beside the CUDA-core ``pogo_update_tiled`` / ``landing_field_tiled``
at their tile for p (``ops.two_stage_tile_n``; above p = 64 only a source
whose entries take the wide kernel's park): the readings that set
``ops.TC_MIN_P``, ``ops.TC_MAX_P`` and ``ops.LANDING_FIELD_TC_MIN_P``. With ``--ns-shape`` (repeatable), the
checkout's tensor-core Newton-Schulz kernel (``newton_schulz_tc``, 12
iterations on the watchdog's drifted input) at each shape beside the
CUDA-core kernel that planned there before it (whole or tiled), both held
against ``ref.newton_schulz_ref`` (atol 1e-6): the readings that set
``ops.NS_TC_MIN_P``; given without ``--shape``, only those. Prints
the median, least and most of ``--reps`` CUDA-event timings of
``--iters`` launches each (the builds take turns),
the ptxas register and spill lines, and the card's name and power limit.
Two sources compare fairly only inside one call: the card's clocks move
between calls. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import os
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import kernel_variants as kv  # noqa: E402  (the build and timing helpers)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a fused_step_tc.cu to build (repeatable)")
    ap.add_argument("--shape", action="append", default=[],
                    help="B,P,N of a stack to time (repeatable; default 640,64,960)")
    ap.add_argument("--ns-shape", action="append", default=[],
                    help="B,P,N of a Newton-Schulz stack to time (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50, help="launches per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tc_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import stiefel
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import pogo_update as pu

    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv._card(), flush=True)
    os.makedirs(kv.OUT, exist_ok=True)
    sources = [s.split("=", 1) for s in args.source] or [
        ("current", str(build.CSRC / "fused_step_tc.cu"))]

    def make(job):  # a copy elsewhere finds the checkout's headers through -I
        label, path = job
        return kv._build(label, path, (), build, includes=(str(build.CSRC),))

    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per build, together
        builds = list(ex.map(make, sources))
    entries, two_stage, wide, wide_field = {}, {}, set(), set()
    for (tag, so, regs), (_, path) in zip(builds, sources):
        lib = ctypes.CDLL(so)
        text = open(path).read()
        parks = "float* park" in text  # the wide kernel's scratch
        if parks:
            wide.add(tag)
        # the field's wide entry takes a park too
        field_parks = re.search(r"int landing_field_tc\([^)]*float\* park", text) is not None
        if field_parks:
            wide_field.add(tag)
        lib.fused_step_tc.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p] * (1 + parks)
        lib.fused_step_tc.restype = ctypes.c_int
        entries[tag] = lib.fused_step_tc
        if hasattr(lib, "pogo_update_tc"):  # sources from before them lack them
            for fn in (lib.pogo_update_tc, lib.landing_field_tc):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for fn, takes in ((lib.pogo_update_tc, parks),
                              (lib.landing_field_tc, field_parks)):
                if takes:
                    fn.argtypes = fn.argtypes[:-1] + [ctypes.c_void_p] * 2
            two_stage[tag] = lib
        print(tag, *regs, sep="\n  ", flush=True)

    def usable(tags, p, kernel="fused"):
        """The builds that take p: above 64 only those with the wide kernel
        (for the field, its wide entry)."""
        return [t for t in tags
                if p <= 64 or (t in (wide_field if kernel == "landing_field" else wide))]

    def timed(label, runs):
        times = {tag: [] for tag in runs}
        for _ in range(args.reps):  # builds in turns, so drift hits them alike
            for tag, run in runs.items():
                times[tag].append(kv._time_ms(run, args.iters))
        for tag, ts in times.items():
            print(f"{label} {tag}: ms median {statistics.median(ts):.4f} min {min(ts):.4f} "
                  f"max {max(ts):.4f}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape] or [(640, 64, 960)]
    bad = _ns_readings(args, gen, timed) if args.ns_shape else 0
    if args.ns_shape and not args.shape:
        return 1 if bad else 0
    for (b, p, n), (method, base, hyper) in itertools.product(
            shapes, (("pogo", "vadam", (0.9, 0.999, 1e-8)), ("landing", "trace", (0.1, False)))):
        x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        if method == "landing":
            x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
        mu = 0.1 * torch.randn((b, p, n), generator=gen, device="cuda")
        nu = torch.rand((b,), generator=gen, device="cuda")
        kw = dict(method=method, lam=0.5 if method == "pogo" else 1.0, base_kind=base,
                  hyper=hyper, post_scale=1.0, mu=mu, nu=nu if base == "vadam" else None,
                  count=torch.tensor(3, dtype=torch.int32, device="cuda"), pv=None)
        want = ref.fused_group_step_ref(x, g, 0.1, **kw)
        park = fs.park(x) if p > 64 else None
        extra = {tag: ((park.data_ptr() if park is not None else None),) if tag in wide else ()
                 for tag in entries}
        runs = {tag: functools.partial(fs._launch, entries[tag], x, g, 0.1, inplace=False,
                                       extra=extra[tag], **kw)
                for tag in usable(entries, p)}
        for tag, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            ok = all(torch.allclose(a, w, atol=3e-5, rtol=1e-4)
                     for a, w in zip(got[:4], want[:4]) if w is not None)
            bad += not ok
            err = max(float((a - w).abs().max()) for a, w in zip(got[:4], want[:4])
                      if w is not None)
            print(f"{method}+{base} {b}x({p},{n}) {tag}: max_abs {err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
        tile_n = ops.tiled_tile_n(p)
        runs[f"cuda-core fused_step_tiled tile {tile_n}"] = functools.partial(
            fs.fused_step_tiled, x, g, 0.1, tile_n=tile_n, **kw)
        timed(f"{method}+{base} {b}x({p},{n})", runs)
        del x, g, mu, nu, want, park

    for (b, p, n), name in itertools.product(shapes, ("pogo_update", "landing_field")):
        pogo = name == "pogo_update"
        x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
        eta, lam = (0.1, 0.5) if pogo else (0.0, 1.0)
        want = ref.pogo_update_ref(x, g, eta, lam) if pogo else ref.landing_field_ref(x, g, lam)
        out = torch.empty_like(x)
        park = fs.park(x, rows=pogo) if p > 64 else None
        takes_park = wide if pogo else wide_field
        runs = {tag: functools.partial(
                    pu.launch, f"{name}_tc", x, g, eta, lam, out,
                    *([park.data_ptr() if park is not None else None]
                      if tag in takes_park else []),
                    lib=lambda lib=two_stage[tag]: lib)
                for tag in usable(two_stage, p, name)}
        for tag, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            ok = torch.allclose(got, want, atol=2e-5, rtol=1e-4)
            bad += not ok
            print(f"{name} {b}x({p},{n}) {tag}: max_abs {float((got - want).abs().max()):.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
        tile_n = ops.two_stage_tile_n(
            p, ops.pogo_tiled_smem_bytes if pogo else ops.landing_tiled_smem_bytes)
        runs[f"cuda-core {name}_tiled tile {tile_n}"] = functools.partial(
            pu.pogo_update_tiled, x, g, eta, lam, tile_n=tile_n) if pogo else \
            functools.partial(lf.landing_field_tiled, x, g, lam, tile_n=tile_n)
        timed(f"{name} {b}x({p},{n})", runs)
        del x, g, want, out, park
    return 1 if bad else 0


def _ns_readings(args, gen, timed) -> int:
    """The tensor-core Newton-Schulz kernel beside the CUDA-core kernel the
    planner gave each ``--ns-shape`` before it; returns the mismatches."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops, ref

    bad = 0
    for b, p, n in (tuple(int(v) for v in s.split(",")) for s in args.ns_shape):
        x = 1.5 * stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        x += 0.05 * torch.randn(x.shape, generator=gen, device="cuda")
        want = ref.newton_schulz_ref(x, 12)
        out = torch.empty_like(x)
        if ops.ns_whole_smem_bytes(p, n) <= ops.SMEM_LIMIT_BYTES:
            label, cc = "cuda-core whole", ns.newton_schulz_whole
        else:
            tile = ops.ns_tiled_tile_n(p)
            label, cc = f"cuda-core tiled tile {tile}", functools.partial(
                ns.newton_schulz_tiled, tile_n=tile)
        runs = {f"tensor-core cluster {ops.ns_tc_cluster(n)}": ns.newton_schulz_tc, label: cc}
        for tag, fn in runs.items():
            got = fn(x, 12, out=out)
            torch.cuda.synchronize()
            ok = torch.allclose(got, want, atol=1e-6, rtol=0)
            bad += not ok
            print(f"newton_schulz {b}x({p},{n}) {tag}: max_abs "
                  f"{float((got - want).abs().max()):.3e} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
        timed(f"newton_schulz {b}x({p},{n})",
              {tag: functools.partial(fn, x, 12, out=out) for tag, fn in runs.items()})
        del x, want, out
    return bad


if __name__ == "__main__":
    sys.exit(main())
