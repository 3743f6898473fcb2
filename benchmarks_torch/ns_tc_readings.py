#!/usr/bin/env python3
"""The tensor-core Newton-Schulz kernels of ``csrc/newton_schulz_tc.cu`` on
the card: the two kernels where both take p, where an iteration's time
goes, and copies of the source, in one call.

    python3 benchmarks_torch/ns_tc_readings.py [--shape B,P,N ...]
        [--split] [--source LABEL=PATH ...] [--stream] [--rounds 3]

By default, at each ``--shape`` (default the trainer's 640 x (64, 960),
512 x (32, 2048) and 576 x (64, 2048), where p <= 64 and n fits both
kernels' clusters): ``newton_schulz_tc`` (row 9tc, planned there) and
``newton_schulz_tc128`` (row 9w), each held against the plain version on
the watchdog's drifted input (atol 1e-6), timed in turns (12 iterations),
then each as the idle repair (every matrix masked off), with each
kernel's cluster size and the clusters the card keeps resident. Row 9 and
the large route beside row 9w at p > 64 are ``chip_smoke.py``'s
``phase_large_crossovers``. ``--split`` times timing-only copies of the
source instead (never on the main path; their results are not checked):
``newton_schulz_tc`` (p <= 64) at 640 x (64, 960) and
``newton_schulz_tc128`` at 576 x (128, 2048), each in turns with
* ``full``: the source as it is;
* ``local``: every partner's partial gram read from the CTA's own shared
  memory instead of over distributed shared memory;
* ``nobar``: ``local`` with the exchange's cluster barriers made CTA
  barriers;
* ``nosplit``: ``nobar`` with the TF32 hi / lo splits of the register
  operands taken out (the products stay);
* ``sweep``: the exchange taken out (the sweeps' products, operand loads
  and tile updates alone);
so that the differences are the distributed shared memory reads, the
cluster barriers, the splits, the rest of the exchange and the sweep.
``--source`` (copies of ``csrc/newton_schulz_tc.cu``, built with ``-I`` of
the checkout's ``csrc``; the label ``checkout`` is the checkout's own)
times each build's ``newton_schulz_tc128`` at each ``--shape`` (default
576 x (128, 2048)) in turns instead, each held against the plain version.
``--stream`` reads row 9s (``newton_schulz_stream``) at each ``--shape``
(default starcoder2-15b's q/k, 2080 x (128, 6144), 576 x (128, 4096) and
576 x (65, 2112), the lower edge of its class) beside row 9 (the tiled
kernel, the route there before): both held against the plain version,
then timed in turns on the drift step (every matrix repaired) and as the
idle repair (every matrix masked off), with the bounds and the peak
device memory: the readings behind the ``"stream"`` route. With
``--source`` it times each build's ``newton_schulz_stream`` instead, each
held against the plain version.
Builds go through ``kernel_variants.py``'s, one ``nvcc`` each, all at
once. Prints ptxas's lines and the card's name and power limit. Needs one
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, [(old, new), ...]) edits, cumulative, each expected in the source.
_PEER = ("hopper::ld_peer4(hopper::map_peer(at, k))",
         "*reinterpret_cast<const float4*>(at)")
_PEER128 = [("hopper::ld_peer4(hopper::map_peer(at, owner))",
             "*reinterpret_cast<const float4*>(at)")]
SPLITS = [
    ("full", []),
    ("local", [_PEER, *_PEER128]),
    ("nobar", [("  hopper::cluster_sync();\n  float4 sum[4];", "  __syncthreads();\n  float4 sum[4];"),
               ("  hopper::cluster_sync();  // every CTA's P is published",
                "  __syncthreads();"),
               ("  hopper::cluster_sync();  // every slice is summed; no CTA reads P any more",
                "  __syncthreads();")]),
    ("nosplit", [("split(tc_at(tile, 8 * kk + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);",
                  "hi = lo = tc_at(tile, 8 * kk + k0 + 4 * (r >> 1), m0 + 8 * (r & 1));"),
                 ("split(n8_at(tile, 32 * h + 8 * k4 + k0 + 4 * (r >> 1), m0 + 8 * (r & 1)), hi, lo);",
                  "hi = lo = n8_at(tile, 32 * h + 8 * k4 + k0 + 4 * (r >> 1), m0 + 8 * (r & 1));"),
                 ("__float_as_uint(0.5f * tf32_trunc(v))", "__float_as_uint(v)"),
                 ("__float_as_uint(trunc_lo(v))", "__float_as_uint(v)")]),
    ("sweep", [("    if (gram) cluster_gram(u, us, pub + ((it + 1) & 1) * kNtPub, c, rank, g, "
                "last ? nullptr : gh, gl);", ""),
               ("      n8_exchange<false>(u, gh, gl, slice, red, c, rank, p, !last, "
                "last ? dst : nullptr);", "")]),
]


def _split_sources(build, kv):
    """``(label, path)`` of the cumulative timing-only copies of
    ``newton_schulz_tc.cu``, written beside ``kernel_variants.py``'s
    builds."""
    src = (build.CSRC / "newton_schulz_tc.cu").read_text()
    out = []
    for label, edits in SPLITS:
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"ns_tc_readings: {label}'s edit {old!r} not in the source")
            src = src.replace(old, new)
        path = os.path.join(kv.OUT, f"ns_split_{label}.cu")
        with open(path, "w") as f:
            f.write(src)
        out.append((label, path))
    return out


def _libs(build, kv, ns, sources):
    """``{label: CDLL}`` of ``(label, path)`` copies of
    ``newton_schulz_tc.cu`` (``checkout``: the checkout's own), built
    together, printing each build's ptxas lines."""
    def make(job):
        label, path = job
        if label == "checkout":
            return label, ns.tc_lib()
        _, so, regs = kv._build(label, path, (), build, includes=(str(build.CSRC),))
        for line in regs:
            print(f"ptxas[{label}] {line}", flush=True)
        lib = ctypes.CDLL(so)
        for entry in ("newton_schulz_tc", "newton_schulz_tc128", "newton_schulz_stream"):
            if not hasattr(lib, entry):  # a source from before the entry
                continue
            getattr(lib, entry).argtypes = getattr(ns.tc_lib(), entry).argtypes
            getattr(lib, entry).restype = ctypes.c_int
        return label, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(make, sources))


def _pair(shape, chip_smoke, gen, rounds, tc_lib):
    """Rows 9tc and 9w at one p <= 64 shape: checked, then timed in turns
    on the drift step and as the idle repair."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops, ref

    b, p, n = shape
    x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
    x += 0.05 * torch.randn(shape, generator=gen, device="cuda")
    kernels = {"9tc": ns.newton_schulz_tc, "9w": ns.newton_schulz_tc128}
    want = ref.newton_schulz_ref(x, chip_smoke.NS_ITERS)
    errs = {k: chip_smoke._errors((fn(x, chip_smoke.NS_ITERS),), (want,), chip_smoke.NS_TOL)
            for k, fn in kernels.items()}
    out = torch.empty_like(x)
    times = chip_smoke._time_rotating(
        [(functools.partial(fn, x, chip_smoke.NS_ITERS, out=out), 5) for fn in kernels.values()],
        rounds)
    y, none = x.clone(), torch.zeros(b, dtype=torch.bool, device="cuda")
    idle = chip_smoke._time_rotating(
        [(functools.partial(fn, y, chip_smoke.NS_ITERS, out=y, mask=none), 20)
         for fn in kernels.values()], rounds)
    if not torch.equal(y, x):
        raise SystemExit(f"ns_tc_readings {shape}: an idle repair wrote a matrix")
    print(f"9tc vs 9w {b}x({p},{n}), planned {ops.plan_newton_schulz(p, n)[0]}; clusters "
          f"9tc {ops.ns_tc_cluster(n)} CTAs, 9w {ops.ns_tc128_cluster(n)} CTAs (resident "
          f"{tc_lib.ns_tc128_max_clusters(n)}):", flush=True)
    for k, (label, (max_abs, _, ok)) in enumerate(errs.items()):
        print(f"  {label}: {times[k]:.4f} ms, idle repair {idle[k]:.4f} ms, max_abs "
              f"{max_abs:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    del x, y, out, want
    return all(ok for _, _, ok in errs.values())


STREAM_SHAPES = [(2080, 128, 6144), (576, 128, 4096), (576, 65, 2112)]


def _stream(shape, chip_smoke, gen, rounds, tc_lib):
    """Row 9s beside row 9 at ``shape``: checked, then timed in turns on
    the drift step and as the idle repair."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops

    b, p, n = shape
    iters = chip_smoke.NS_ITERS
    torch.cuda.reset_peak_memory_stats()
    x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
    x += 0.05 * torch.randn(shape, generator=gen, device="cuda")
    routes = {"row 9": functools.partial(ns.newton_schulz_tiled, tile_n=ops.ns_tiled_tile_n(p)),
              "9s": ns.newton_schulz_stream}
    want = chip_smoke._plain_ns(x)
    out = torch.empty_like(x)
    errs = {}
    for label, fn in routes.items():
        out.fill_(float("nan"))
        fn(x, iters, out=out)
        errs[label] = chip_smoke._errors((out,), (want,), chip_smoke.NS_TOL)
    del want
    times = chip_smoke._time_rotating(
        [(functools.partial(fn, x, iters, out=out), 2 if label == "row 9" else 5)
         for label, fn in routes.items()], rounds)
    y, none = x.clone(), torch.zeros(b, dtype=torch.bool, device="cuda")
    idle = chip_smoke._time_rotating(
        [(functools.partial(fn, y, iters, out=y, mask=none), 20) for fn in routes.values()],
        rounds)
    if not torch.equal(y, x):
        raise SystemExit(f"ns_tc_readings {shape}: an idle repair wrote a matrix")
    flops = p * p * n * b * iters
    tf32 = 1e3 * 10 * flops / chip_smoke.TF32_TC_FLOP_PER_S
    fp32 = 1e3 * chip_smoke.NS_FLOPS * flops / chip_smoke.FP32_FLOP_PER_S
    hbm = 1e3 * 4 * b * p * n / chip_smoke.HBM_BYTES_PER_S
    print(f"9s vs row 9 {b}x({p},{n}), {iters} iterations, planned "
          f"{ops.plan_newton_schulz(p, n)}; bounds: 3xTF32 tensor work {tf32:.4f} ms, fp32 "
          f"CUDA cores {fp32:.4f}, 2 HBM passes {2 * hbm:.4f}, {2 * iters + 1} passes "
          f"{(2 * iters + 1) * hbm:.4f}; 9s's grid {tc_lib.ns_stream_max_clusters()} CTAs; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for k, (label, (max_abs, _, good)) in enumerate(errs.items()):
        print(f"  {label}: drift step {times[k]:.4f} ms, idle repair {idle[k]:.4f} ms, "
              f"max_abs {max_abs:.3e} {'ok' if good else 'MISMATCH'}", flush=True)
    takes = times[1] < times[0] and idle[1] <= idle[0] + 0.1
    print(f"  the rule (faster drift step, idle within 0.1 ms of row 9's) takes "
          f"{'9s' if takes else 'row 9'}", flush=True)
    del x, y, out
    return all(good for _, _, good in errs.values())


def _split(libs, chip_smoke, gen, rounds):
    import torch

    from repro_torch.core import stiefel

    for entry, shape in (("newton_schulz_tc", (640, 64, 960)),
                         ("newton_schulz_tc128", (576, 128, 2048))):
        x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
        x += 0.05 * torch.randn(shape, generator=gen, device="cuda")
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib, iters):
            err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), None, None, *shape,
                                      iters, stream)
            if err:
                raise SystemExit(f"{entry} variant failed: cudaError {err}")

        fns = [(functools.partial(run, lib, it), 10) for lib in libs.values()
               for it in (0, chip_smoke.NS_ITERS)]
        times = chip_smoke._time_rotating(fns, rounds)
        b, p, n = shape
        work = (2 + 3) * 2 * p * p * n * b / chip_smoke.TF32_TC_FLOP_PER_S * 1e3
        print(f"split {entry} {b}x({p},{n}): ms at 0 and {chip_smoke.NS_ITERS} iterations, "
              f"per iteration; 3xTF32 tensor work an iteration {work:.4f} ms", flush=True)
        for k, label in enumerate(libs):
            t0, t12 = times[2 * k], times[2 * k + 1]
            print(f"  {label}: {t0:.4f} / {t12:.4f} ms, "
                  f"{(t12 - t0) / chip_smoke.NS_ITERS:.4f} ms an iteration", flush=True)
        del x, out


def _sources(libs, shapes, entry, chip_smoke, gen, rounds):
    """Each build's ``entry`` (``newton_schulz_tc128`` or
    ``newton_schulz_stream``) at each shape, checked against the plain
    version, timed in turns."""
    import torch

    from repro_torch.core import stiefel

    ok = True
    for shape in shapes:
        x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
        x += 0.05 * torch.randn(shape, generator=gen, device="cuda")
        out = torch.empty_like(x)
        want = chip_smoke._plain_ns(x)
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), None, None, *shape,
                                      chip_smoke.NS_ITERS, stream)
            if err:
                raise SystemExit(f"{entry} build failed: cudaError {err}")

        errs = {}
        for label, lib in libs.items():
            out.fill_(float("nan"))
            run(lib)
            errs[label] = chip_smoke._errors((out,), (want,), chip_smoke.NS_TOL)
        times = chip_smoke._time_rotating([(functools.partial(run, lib), 3)
                                           for lib in libs.values()], rounds)
        print(f"{entry} sources {shape[0]}x{shape[1:]}: " + "; ".join(
            f"{label} {t:.4f} ms, max_abs {e[0]:.3e} {'ok' if e[2] else 'MISMATCH'}"
            for (label, e), t in zip(errs.items(), times)), flush=True)
        ok &= all(e[2] for e in errs.values())
        del x, out, want
    return ok


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", default=[],
                    help="B,P,N (repeatable); default 640 x (64, 960), 512 x (32, 2048), "
                         "576 x (64, 2048) (with --source 576 x (128, 2048))")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a copy of csrc/newton_schulz_tc.cu (repeatable)")
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ns_tc_readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmarks_torch"))
    import chip_smoke
    import kernel_variants as kv
    from repro_torch.kernels import build
    from repro_torch.kernels import newton_schulz as ns

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke._card()
    print(card, flush=True)
    tc_lib = ns.tc_lib()
    for line in build.PTXAS_LOG.get("newton_schulz_tc", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas[newton_schulz_tc] {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    os.makedirs(kv.OUT, exist_ok=True)
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shape]
    ok = True
    if args.stream and args.source:
        srcs = [("checkout", "")] + [s.split("=", 1) for s in args.source]
        ok = _sources(_libs(build, kv, ns, srcs), shapes or STREAM_SHAPES[:1],
                      "newton_schulz_stream", chip_smoke, gen, args.rounds)
    elif args.stream:
        ok = all([_stream(s, chip_smoke, gen, args.rounds, tc_lib)
                  for s in shapes or STREAM_SHAPES])
    elif args.split:
        _split(_libs(build, kv, ns, _split_sources(build, kv)), chip_smoke, gen, args.rounds)
    elif args.source:
        srcs = [("checkout", "")] + [s.split("=", 1) for s in args.source]
        ok = _sources(_libs(build, kv, ns, srcs), shapes or [chip_smoke.WIDE_SHAPE],
                      "newton_schulz_tc128", chip_smoke, gen, args.rounds)
    else:
        ok = all([_pair(s, chip_smoke, gen, args.rounds, tc_lib) for s in
                  shapes or [(640, 64, 960), (512, 32, 2048), (576, 64, 2048)]])
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
