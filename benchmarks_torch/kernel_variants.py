#!/usr/bin/env python3
"""Time variants of the fused-step kernels on the card, one call each.

    python3 benchmarks_torch/kernel_variants.py [--source LABEL=PATH ...]
        [--caps W,T ...] [--tiles 32,64] [--reps 5] [--iters 50]

Builds each ``--source`` (default: the checkout's ``csrc/fused_step.cu``;
one from before the Landing branches, without their ``method`` argument,
builds and runs as well)
once per ``--caps`` pair, where ``W,T`` rewrites the source's
``kWholeBlocksPerSm`` / ``kTiledBlocksPerSm`` register caps (``-`` keeps
the source's own; a source without those constants is built as it is).
Every build runs ``fused_step_whole`` at 2048 x (16, 256) and
``fused_step_tiled`` at 640 x (64, 960) with each ``--tiles`` width, base
``trace(0.9)``, held against the plain version, and prints the median,
least and most of ``--reps`` CUDA-event timings of ``--iters`` launches
each (the builds take turns), the ptxas register and spill lines, and the
card's name and power limit. Comparing two sources in one call is the only
fair comparison: the card's clocks move between calls.
Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "kernel_variants")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _build(label, path, caps, build, includes=()):
    """Compile ``path`` with the register caps ``caps`` into a library;
    headers are looked up beside ``path``, then in ``includes``."""
    src = open(path).read()
    for const, value in zip(("kWholeBlocksPerSm", "kTiledBlocksPerSm"), caps):
        if value != "-":
            src = re.sub(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", src)
    tag = f"{label}_{'_'.join(caps)}"
    cu, so = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run(  # -I: the headers beside the original source
        [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         f"-I{os.path.dirname(os.path.abspath(path))}", *(f"-I{d}" for d in includes),
         "-o", so, cu],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {tag}:\n{res.stderr}")
    regs = [line.strip() for line in res.stderr.splitlines()
            if "Used" in line or "spill" in line or "C75" in line]
    return tag, so, regs


def _entries(so, src):
    """``(whole, tiled)`` entry points of a build, called as this tree's
    ``fused_step._launch`` calls them. A source from before the Landing
    branches takes no ``method`` argument; its entries drop it (POGO)."""
    lib = ctypes.CDLL(so)
    has_method = re.search(r"int nesterov,\s*int method", src) is not None
    common = [ctypes.c_void_p] * 10 + [ctypes.c_int] * (6 if has_method else 5)
    lib.fused_step_whole.argtypes = common + [ctypes.c_void_p]
    lib.fused_step_tiled.argtypes = common + [ctypes.c_int, ctypes.c_void_p]
    lib.fused_step_whole.restype = lib.fused_step_tiled.restype = ctypes.c_int
    if has_method:
        return lib.fused_step_whole, lib.fused_step_tiled

    def drop_method(entry):  # the method is the 16th argument of _launch's call
        return lambda *a: entry(*a[:15], *a[16:])

    return drop_method(lib.fused_step_whole), drop_method(lib.fused_step_tiled)


def _time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a fused_step.cu to build (repeatable)")
    ap.add_argument("--caps", action="append", default=[],
                    help="W,T register caps (blocks per SM), '-' keeps the source's")
    ap.add_argument("--tiles", default="32,64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50, help="launches per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import stiefel
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fused_step as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(_card(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    sources = [s.split("=", 1) for s in args.source] or [
        ("current", str(build.CSRC / "fused_step.cu"))]
    caps = [tuple(c.split(",")) for c in args.caps] or [("-", "-")]
    jobs = [(label, path, c) for label, path in sources for c in caps]
    with ThreadPoolExecutor(len(jobs)) as ex:  # one nvcc per build, together
        builds = list(ex.map(lambda j: _build(*j, build), jobs))
    srcs = {label: open(path).read() for label, path in sources}
    entries = {tag: _entries(so, srcs[label])
               for (tag, so, _), (label, _, _) in zip(builds, jobs)}
    for tag, _, regs in builds:
        print(tag, *regs, sep="\n  ", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    cases = [("whole", 2048, 16, 256, 0)] + [
        ("tiled", 640, 64, 960, int(t)) for t in args.tiles.split(",")]
    for kind, b, p, n, tile_n in cases:
        x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
        g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
        mu = 0.1 * torch.randn((b, p, n), generator=gen, device="cuda")
        kw = dict(method="pogo", lam=0.5, base_kind="trace", hyper=(0.9, False),
                  post_scale=1.0, mu=mu, nu=None, count=None, pv=None)
        want = ref.fused_group_step_ref(x, g, 0.1, **kw)
        runs = {}
        for tag, _, _ in builds:
            entry = entries[tag][0 if kind == "whole" else 1]
            extra = () if kind == "whole" else (tile_n,)
            runs[tag] = functools.partial(fs._launch, entry, x, g, 0.1, inplace=False,
                                          extra=extra, **kw)
            got = runs[tag]()
            torch.cuda.synchronize()
            ok = all(torch.allclose(a, w, atol=3e-5, rtol=1e-4)
                     for a, w in zip(got[:2], want[:2]))
            bad += not ok
            err = max(float((a - w).abs().max()) for a, w in zip(got[:2], want[:2]))
            print(f"{kind} {b}x({p},{n}) tile_n {tile_n} {tag}: max_abs {err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
        times = {tag: [] for tag in runs}
        for _ in range(args.reps):  # builds in turns, so drift hits them alike
            for tag, run in runs.items():
                times[tag].append(_time_ms(run, args.iters))
        for tag, ts in times.items():
            print(f"{kind} {b}x({p},{n}) tile_n {tile_n} {tag}: ms median "
                  f"{statistics.median(ts):.4f} min {min(ts):.4f} max {max(ts):.4f}",
                  flush=True)
        del x, g, mu, want
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
