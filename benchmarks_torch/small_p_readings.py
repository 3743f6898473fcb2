#!/usr/bin/env python3
"""The cluster kernel of ``csrc/small_p.cu`` on the card, its four entries
beside the routes below them, in one call.

    python3 benchmarks_torch/small_p_readings.py [--shape B,P,N ...]
        [--rounds 3] [--check-only] [--source LABEL=PATH ...]

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
and power limit. Needs one CUDA card; exits 2 without one.
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


if __name__ == "__main__":
    sys.exit(main())
