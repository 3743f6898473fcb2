#!/usr/bin/env python3
"""The TP step's kernels on the card: the tensor-core ones (rows 3tc and
4tc, ``csrc/tp_step_tc.cu``) beside the CUDA-core ones (rows 3 and 4,
``csrc/tp_step.cu``), in one call.

    python3 benchmarks_torch/tp_tc_readings.py [--shape B,P,N ...]
        [--crossover P,P,...] [--crossover-b 2048] [--crossover-n 480]
        [--reps 3] [--iters 10] [--check-only] [--alg-phases]

A shape is a rank's block ``(B, p, n_local)``: the payload is the sum of
its half's and the other half's partials, as the all-reduce makes it. At
each ``--shape`` (default SmolLM-360M's q/k at width 2, 640 x (64, 480),
and the single-device schedule's 640 x (64, 240) and 640 x (64, 960)),
POGO over trace, Landing over VAdam, POGO over VAdam and Landing over
trace: ``tp_gram_tc`` and ``tp_apply_tc`` held against the plain versions
(atol 3e-5 / rtol 1e-4), then timed in turns with rows 3 and 4 (tc, CUDA
cores, CUDA cores, tc, ...), with their bounds; at the first shape, a
``torch.profiler`` split of ``tp_apply_tc`` into its two launches (the
algebra and the sweep). The crossover: at ``--crossover-b`` x (p,
``--crossover-n``) for each p (default 16, 24, 29, 32, 48, 64), POGO over
VAdam and Landing over trace, the same turns (``ops.TP_TC_MIN_P`` is read
from them). ``--alg-phases`` instead builds a copy of the source with
``%globaltimer`` stamps and prints where POGO's algebra kernel spends a
CTA's time, phase by phase. Prints the median, least and most of ``--reps`` CUDA-event
timings of ``--iters`` calls, the ptxas lines of ``tp_step_tc.cu``, the
kernels' shared memory, the distance beside ``||X' X'^T - I||`` formed
from the kernel's X' at the first shape, and the card's name and power
limit. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=3e-5, rtol=1e-4)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
LR = 0.1
COMBOS = (("trace", (0.9, False), "pogo"), ("vadam", (0.9, 0.999, 1e-8), "landing"),
          ("vadam", (0.9, 0.999, 1e-8), "pogo"), ("trace", (0.1, False), "landing"))


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


def bounds(b, p, n, base_kind, method):
    """``{kernel: (ms, by)}``: ``tp_gram`` moves read X, g (and mu), write
    Gb (and mu') and the payload row, for A (p^2 n, symmetric), B and S
    (2 p^2 n each); ``tp_apply`` reads X, Gb and the payload and writes
    X', for three p x p x n products (6 p^2 n) and the (p, p) algebra (20
    p^3 for POGO, 26 for Landing); the 3xTF32 form counts the same
    operations three times."""
    k = 3 * p * p + (base_kind == "vadam")
    out = {}
    for name, passes, flops in (
            ("tp_gram", 5 if base_kind != "none" else 3, 5 * p * p * n),
            ("tp_apply", 3, 6 * p * p * n + (20 if method == "pogo" else 26) * p ** 3)):
        t_bytes = (passes * p * n + k) * b * 4 / HBM_BYTES_PER_S
        out[name] = dict(bytes=1e3 * t_bytes, fp32=1e3 * flops * b / FP32_FLOP_PER_S,
                         tf32=1e3 * 3 * flops * b / TF32_FLOP_PER_S)
    return out


def _operands(gen, b, p, n):
    """A rank's half of a (B, p, 2 n) stack near the manifold, its
    gradient and moments, and the other half's payload."""
    import torch

    from repro_torch.core import stiefel

    x = stiefel.random_stiefel(gen, (b, p, 2 * n), device="cuda")
    x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
    g = 5e-4 * torch.randn(x.shape, generator=gen, device="cuda")
    mu = 5e-4 * torch.randn(x.shape, generator=gen, device="cuda")
    nu = torch.rand(b, generator=gen, device="cuda") * 1e-6
    half = {k: v[..., :n].contiguous() for k, v in (("x", x), ("g", g), ("mu", mu))}
    return half, (x[..., n:].contiguous(), g[..., n:].contiguous(), mu[..., n:].contiguous()), nu


def run_shape(gen, b, p, n, combos, reps, iters, check_only, split=False):
    """Check and time the four kernels at one shape; returns ``{(base,
    method): {label: median ms}}``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tp_step as tp

    out = {}
    for base, hyper, method in combos:
        h, other, nu = _operands(gen, b, p, n)
        gkw = dict(base_kind=base, hyper=hyper, post_scale=1.0, mu=h["mu"])
        got = tp.tp_gram_tc(h["x"], h["g"], **gkw)
        want = ref.tp_partial_ref(h["x"], h["g"], **gkw)
        err_g = max(float((a - w).abs().max()) for a, w in zip(got, want) if w is not None)
        ok = all(torch.allclose(a, w, **TOL) for a, w in zip(got, want) if w is not None)
        payload = want[0] + ref.tp_partial_ref(*other[:2], base_kind=base, hyper=hyper,
                                               mu=other[2])[0]
        scl = None
        if base == "vadam":
            scl = ref.tp_scale_ref(payload, p, hyper=hyper, post_scale=1.0, nu=nu,
                                   count=torch.tensor(3, device="cuda"))[0].contiguous()
        akw = dict(method=method, lam=0.5 if method == "pogo" else 1.0)
        got_a = tp.tp_apply_tc(h["x"], want[1], payload, LR, scl, **akw)
        want_a = ref.tp_apply_ref(h["x"], want[1], payload, LR, scl, **akw)
        err_a = [float((a - w).abs().max()) for a, w in zip(got_a, want_a)]
        ok = ok and all(torch.allclose(a, w, **TOL) for a, w in zip(got_a, want_a))
        torch.cuda.synchronize()
        print(f"check {b}x({p},{n}) {method}+{base}: tp_gram_tc max_abs {err_g:.3e}; "
              f"tp_apply_tc x' {err_a[0]:.3e} dist {err_a[1]:.3e} (distance "
              f"{float(got_a[1].max()):.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit("a tensor-core TP kernel disagrees with its plain version")
        if check_only:
            continue
        gtile = ops.plan_tp("tp_gram", p, ops.tp_gram_smem_bytes)
        atile = ops.plan_tp("tp_apply", p, ops.tp_apply_smem_bytes)
        runs = {
            "tp_gram_tc": lambda: tp.tp_gram_tc(h["x"], h["g"], **gkw),
            "tp_gram": lambda: tp.tp_gram(h["x"], h["g"], tile_n=gtile, **gkw),
            "tp_apply_tc": lambda: tp.tp_apply_tc(h["x"], want[1], payload, LR, scl, **akw),
            "tp_apply": lambda: tp.tp_apply(h["x"], want[1], payload, LR, scl, tile_n=atile,
                                            **akw),
        }
        times = _in_turns(runs, reps, iters)
        bd = bounds(b, p, n, base, method)
        for label, ts in times.items():
            bk = bd[label.removesuffix("_tc")]
            print(f"  {label} {b}x({p},{n}) {method}+{base}: {_stats(ts)} ms; bound bytes "
                  f"{bk['bytes']:.4f}, 3xTF32 {bk['tf32']:.4f}, fp32 {bk['fp32']:.4f}",
                  flush=True)
        out[(base, method)] = {k: statistics.median(v) for k, v in times.items()}
        if split:
            _split(lambda: tp.tp_apply_tc(h["x"], want[1], payload, LR, scl, **akw),
                   f"tp_apply_tc {b}x({p},{n}) {method}+{base}")
        del h, other, got, want, got_a, want_a, payload
    return out


def direct_check(gen, b, p, n):
    """One shard holding the whole (B, p, 2 n) matrix: the tensor-core
    kernels' distance beside ||X' X'^T - I||_F formed in fp64 from the
    kernel's own X' (the gram identity is exact, so they differ by
    rounding alone), and the plain version's own gap, on the manifold
    (gradients of 5e-4) and 1e-2 off it."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import ref
    from repro_torch.kernels import tp_step as tp

    eye = torch.eye(p, dtype=torch.float64, device="cuda")

    def gap(x2, dist):
        xd = x2.double()
        direct = torch.linalg.matrix_norm(xd @ xd.transpose(-1, -2) - eye)
        return float((dist.double() - direct).abs().max())

    for off in (0.0, 0.01):
        for base, hyper, method in COMBOS[:2]:
            x = stiefel.random_stiefel(gen, (b, p, 2 * n), device="cuda")
            x += off * torch.randn(x.shape, generator=gen, device="cuda")
            g = 5e-4 * torch.randn(x.shape, generator=gen, device="cuda")
            mu = torch.zeros_like(x)
            nu = torch.zeros(b, device="cuda")
            payload, gb, _ = tp.tp_gram_tc(x, g, base_kind=base, hyper=hyper, mu=mu)
            scl = None
            if base == "vadam":
                scl = ref.tp_scale_ref(payload, p, hyper=hyper, post_scale=1.0, nu=nu,
                                       count=torch.tensor(3, device="cuda"))[0].contiguous()
            akw = dict(method=method, lam=0.5 if method == "pogo" else 1.0)
            x2, dist = tp.tp_apply_tc(x, gb, payload, LR, scl, **akw)
            print(f"direct {b}x({p},{2 * n}) {method}+{base}, x {off} off the manifold: "
                  f"distance max {float(dist.max()):.3e}, |kernel - direct fp64| max "
                  f"{gap(x2, dist):.3e}, the plain version's "
                  f"{gap(*ref.tp_apply_ref(x, gb, payload, LR, scl, **akw)):.3e}", flush=True)


# Where POGO's algebra kernel (tp_alg_kernel<0>) spends a CTA's time: a
# copy of tp_step_tc.cu with %globaltimer stamps written by each CTA's
# thread 0 after each of these phases.
PHASES = ("load", "U and V", "R R^T", "E", "E^2 and E A", "E B and E^3", "distance")
_STAMP_AFTER = (
    "  float* op_q = op_p + pp;\n",
    "  // U = S A - B^T B^T (d1) and V = A B^T - B A = 2 R X^T (d2).\n",
    "  // 4 R R^T = U^T A - V B^T (d1).\n",
    "  const float e2 = 0.25f * (eta * eta);  // R R^T's coefficient\n",
    "    // E^2 (d1) and E A (d2): P' = (I - lam E) P = -(c/2) (A - lam E A).\n",
    "    // (E B)^T = B^T E (d1, B^T read from B's tile) and E^3 = E^2 E (d2):\n",
    "  float acc = 0.f;\n",
    "  if (tid == 0) dist[b] = sqrtf(tot);\n",
)


def alg_phases(gen, sizes=(132, 264, 640), p=64, n=480):
    """Build the stamped copy under build/, run POGO's tp_apply_tc at B x
    (p, n) for each B (132: one CTA an SM, 264: two) and print each
    phase's mean microseconds a CTA."""
    import ctypes

    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import tp_step as tp

    src = open(os.path.join(str(build.CSRC), "tp_step_tc.cu")).read()
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_t[8 * 4096];\n", 1)
    for k, mark in enumerate(_STAMP_AFTER):
        assert src.count(mark) >= 1, mark
        stamp = ("  if (threadIdx.x == 0) { unsigned long long t; asm volatile(\"mov.u64 %0, "
                 f"%globaltimer;\" : \"=l\"(t)); g_t[blockIdx.x * 8 + {k}] = t; }}\n")
        src = src.replace(mark, mark + stamp if k != 6 else stamp + mark, 1)
    src += ('\nextern "C" int read_stamps(unsigned long long* out, int b) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_t, 8 * 8 * b);\n}\n")
    out = os.path.join(ROOT, "build", "tp_tc_readings")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "tp_step_tc_stamped.cu"), os.path.join(out, "libstamped.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", f"-I{build.CSRC}", "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.tp_apply_tc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tp_apply_tc.restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for b in sizes:
        h, other, _ = _operands(gen, b, p, n)
        kw = dict(base_kind="trace", hyper=(0.9, False), mu=h["mu"])
        want = ref.tp_partial_ref(h["x"], h["g"], **kw)
        payload = want[0] + ref.tp_partial_ref(*other[:2], base_kind="trace", hyper=(0.9, False),
                                               mu=other[2])[0]
        scal = tp.tp_scal("none", (), 1.0, eta=LR, lam=0.5, device="cuda")
        x2, dist = torch.empty_like(h["x"]), torch.empty(b, device="cuda")
        ops = torch.empty((b, 2, p, p), device="cuda")
        for _ in range(3):
            err = lib.tp_apply_tc(h["x"].data_ptr(), want[1].data_ptr(), payload.data_ptr(),
                                  None, scal.data_ptr(), None, x2.data_ptr(), dist.data_ptr(),
                                  ops.data_ptr(), b, p, n, payload.shape[1], 0,
                                  torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"the stamped tp_apply_tc returned {err}")
        stamps = (ctypes.c_ulonglong * (8 * b))()
        lib.read_stamps(stamps, b)
        t = torch.tensor(list(stamps), dtype=torch.float64).view(b, 8)
        us = ((t[:, 1:] - t[:, :-1]) / 1e3).mean(0)
        print(f"alg phases {b}x({p},{n}) pogo, us a CTA: " + ", ".join(
            f"{name} {float(v):.2f}" for name, v in zip(PHASES, us)) +
            f"; a CTA {float(((t[:, 7] - t[:, 0]) / 1e3).mean()):.2f}, the launch "
            f"{float((t[:, 7].max() - t[:, 0].min()) / 1e3):.2f}", flush=True)


def _split(fn, label, calls=20):
    """Device time of each CUDA kernel of ``calls`` calls, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev and "tp_" in ev.key:
            parts.append(f"{ev.key} {dev / calls / 1e3:.4f} ms x {ev.count // calls}")
    print(f"  split {label}: " + ("; ".join(parts) or "no device time in the trace"),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_tc_readings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import tp_step as tp

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--crossover", default="16,24,29,32,48,64")
    ap.add_argument("--crossover-b", type=int, default=2048)
    ap.add_argument("--crossover-n", type=int, default=480)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--alg-phases", action="store_true",
                    help="only the algebra kernel's phases, from a stamped copy")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    tp.lib()
    lib = tp.tc_lib()
    for line in build.PTXAS_LOG.get("tp_step_tc", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas[tp_step_tc] {line.strip()}", flush=True)
    print(f"smem bytes: gram {lib.tp_gram_tc_smem_bytes()}, sweep "
          f"{lib.tp_apply_tc_smem_bytes()}, algebra {lib.tp_alg_smem_bytes()} (ops.py: "
          f"{ops.tp_gram_tc_smem_bytes()}, {ops.tp_apply_tc_smem_bytes()}, "
          f"{ops.tp_alg_smem_bytes()})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.alg_phases:
        alg_phases(gen)
        print(card, flush=True)
        return 0
    shapes = [tuple(int(v) for v in s.split(",")) for s in (args.shape or [
        "640,64,480", "640,64,240", "640,64,960"])]
    for i, (b, p, n) in enumerate(shapes):
        run_shape(gen, b, p, n, COMBOS if i == 0 else COMBOS[:2], args.reps, args.iters,
                  args.check_only, split=i == 0)
    direct_check(gen, *shapes[0])
    if args.crossover and not args.check_only:
        for p in (int(v) for v in args.crossover.split(",")):
            res = run_shape(gen, args.crossover_b, p, args.crossover_n,
                            (COMBOS[2], COMBOS[3]), args.reps, args.iters, False)
            for (base, method), t in res.items():
                print(f"crossover {args.crossover_b}x({p},{args.crossover_n}) {method}+{base}: "
                      f"gram tc / row 3 {t['tp_gram_tc']:.4f} / {t['tp_gram']:.4f}; apply tc "
                      f"/ row 4 {t['tp_apply_tc']:.4f} / {t['tp_apply']:.4f}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
