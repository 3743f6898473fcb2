#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path — ``orthogonal("pogo", use_kernel=True, base_optimizer=
chain(trace(0.9)))`` + ``constraint_step`` — at the full width of
SmolLM-360M's constrained q/k projections (one 640 x (64, 960) stack), and
at the many-matrices shape 2048 x (16, 256). Any failure exits non-zero.
The second-to-last line is a JSON record of every kernel (launches on the
main path, error against the plain version, times and bounds); the last
line is the device record. Without a CUDA card it exits 2 and prints no
result.
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
LR = 0.1
GRAD_SCALE = 5e-4  # per-entry gradient std: keeps eta ||R|| near 1e-2
SMOLLM_STEPS = 10


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


def _bound(b, p, n, base_kind):
    """Least time for one fused step: 5 HBM passes of the (B, p, n) fp32
    operands (read X, g, mu; write X', mu') plus the per-matrix scalars,
    against six p x p x n products (12 p^2 n flops per matrix)."""
    passes = 5 if base_kind != "none" else 3
    scalars = (3 if base_kind == "vadam" else 1) * b * 4
    bytes_ = passes * b * p * n * 4 + scalars
    flops = 12 * p * p * n * b
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _operands(gen, b, p, n):
    import torch

    from repro_torch.core import stiefel

    x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
    g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
    mu = 0.1 * torch.randn((b, p, n), generator=gen, device="cuda")
    nu = torch.rand((b,), generator=gen, device="cuda")
    return x, g, mu, nu


def phase_kernels(gen):
    """Each kernel against the plain version at the main-path shapes."""
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


def drive_main_path(gen, shapes, label, steps, card):
    """orthogonal(...) + constraint_step on a ConstraintSet of random
    Stiefel leaves: 2 warm-up steps, then ``steps`` counted steps. Returns
    the launches of each kernel during the counted steps."""
    import torch

    from repro_torch.core import api, stiefel
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ref
    from repro_torch.optim import chain, trace

    params = {k: stiefel.random_stiefel(gen, s, device="cuda") for k, s in shapes.items()}
    cs = api.ConstraintSet.from_tree(params)
    del params
    opt = api.orthogonal("pogo", learning_rate=LR, use_kernel=True,
                         base_optimizer=chain(trace(0.9)))
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

    # Hold the first counted step against the plain version at full width.
    x0 = [s.clone() for s in cs.stacks]
    mu0 = [s.clone() for s in state.base_state[0].momentum.stacks]

    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
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
        if not bool(health.finite) or not dist <= 1e-5:
            raise SystemExit(f"{label} step {i}: finite={bool(health.finite)} "
                             f"max_distance={dist}")
        if i == 0:
            for x, mu, xs, ms, g in zip(x0, mu0, cs.stacks,
                                        state.base_state[0].momentum.stacks,
                                        gs.stacks):
                want = ref.fused_group_step_ref(x, g, LR, method="pogo", lam=0.5,
                                                base_kind="trace",
                                                hyper=(0.9, False), mu=mu)
                max_abs, _, ok = _errors((xs, ms), want[:2], TILED_TOL)
                print(f"{label} step 0 vs plain: max_abs {max_abs:.3e} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    raise SystemExit(f"{label}: main path disagrees with plain")
            del x0, mu0
    launches = {"fused_step_whole": fs.fused_step_whole.launches,
                "fused_step_tiled": fs.fused_step_tiled.launches}
    for s in cs.stacks:
        if not bool(torch.isfinite(s).all()):
            raise SystemExit(f"{label}: non-finite stack")
    times.sort()
    print(f"{label}: {steps} steps, median step {times[len(times) // 2]:.4f} ms, "
          f"max_distance per step {[f'{d:.2e}' for d in dists]}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"launches {launches} [{card}]", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import smollm_360m
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs
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
    for name in sources:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = phase_kernels(gen)

    shapes = ortho.orthogonal_leaf_shapes(smollm_360m.config())
    smollm = drive_main_path(gen, shapes, "smollm-360m q/k", SMOLLM_STEPS, card)
    if smollm["fused_step_tiled"] != SMOLLM_STEPS:
        raise SystemExit(f"tiled kernel launched {smollm['fused_step_tiled']} times "
                         f"in {SMOLLM_STEPS} steps")
    many = drive_main_path(gen, {"w": (2048, 16, 256)}, "2048x(16,256)", 10, card)
    if many["fused_step_whole"] != 10:
        raise SystemExit(f"whole kernel launched {many['fused_step_whole']} times")

    sources_of = "src/repro_torch/kernels/csrc/fused_step.cu"
    kernels = [
        dict(name="fused_step_whole", route="cuda", source=sources_of,
             replaces="src/repro/kernels/fused_step.py:175",
             launches=many["fused_step_whole"], library_ms=None,
             **records["fused_step_whole"]),
        dict(name="fused_step_tiled", route="cuda", source=sources_of,
             replaces="src/repro/kernels/fused_step.py:608",
             launches=smollm["fused_step_tiled"], library_ms=None,
             **records["fused_step_tiled"]),
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
