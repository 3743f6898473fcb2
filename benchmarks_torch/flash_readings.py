#!/usr/bin/env python3
"""Time the fp32 flash-attention kernels on the card, in turns, one call.

    python3 benchmarks_torch/flash_readings.py [--shape B,S,H,KV,HD ...]
        [--source LABEL=PATH ...] [--timing LABEL=PATH ...] [--no-causal]
        [--rounds 3] [--prefill]

At each ``--shape`` (default: SmolLM-360M's prefill, (4, 2048, 15, 5,
64), and internlm2-1.8b's heads, (1, 2048, 16, 8, 128)), fp32, causal
unless ``--no-causal``: the 3xTF32 kernel (``flash_attention_tf32``), each
``--source`` copy of ``csrc/flash_attention_tf32.cu`` (built beside the
checkout's headers, called as the wrapper calls the checkout's), the
CUDA-core kernel (``flash_attention_fp32``), the plain version and
PyTorch's SDPA, timed in turns whose order reverses every round (medians
of ``--rounds``), each held against the plain version at atol 2e-5 / rtol
1e-4. A ``--timing`` copy (one with a part of its work taken out, to see
where the time goes) is timed the same way and its error printed, not
held. Prints the 3xTF32 bound, the ptxas lines of every build and the
card's name and power limit. ``--prefill`` instead times SmolLM-360M's
full-width ``transformer.prefill`` on 4 x 2048 tokens in fp32 compute as
planned (32 launches of the 3xTF32 kernel) and with
``flash_attention.plan`` sending fp32 to the CUDA-core kernel (the route
before the 3xTF32 kernel), calls in turns (medians of 5 each, CUDA
events around each call), with each route's launches. Needs one CUDA
card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "benchmarks_torch"))

SHAPES = [(4, 2048, 15, 5, 64), (1, 2048, 16, 8, 128)]
TOL = dict(atol=2e-5, rtol=1e-4)


def _copy_kernel(label, path):
    """A ``flash_attention_tf32``-like call of a built copy of the source,
    and its ptxas lines."""
    import kernel_variants
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    os.makedirs(kernel_variants.OUT, exist_ok=True)
    _, so, regs = kernel_variants._build(label, path, ("-", "-"), build,
                                         includes=(str(build.CSRC),))
    lib = ctypes.CDLL(so)
    lib.flash_attention_tf32_fwd.argtypes = fa.tf32_lib().flash_attention_tf32_fwd.argtypes
    lib.flash_attention_tf32_fwd.restype = ctypes.c_int

    def run(q, k, v, *, causal, window):
        import torch

        out = torch.empty_like(q)
        hd = q.shape[-1]
        err = lib.flash_attention_tf32_fwd(
            *fa._launch_args(q, k, v, out), hd, int(causal), int(window or 0),
            float(hd**-0.5), torch.cuda.current_stream().cuda_stream)
        fa._raise_on(err, label, q, k)
        return out

    return run, regs


def _prefill(card, rounds=5):
    """The fp32 prefill's ms a call, planned and on the CUDA-core kernel."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("smollm-360m"), compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tfm.init_params(gen, cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen, device="cuda")
    planner = fa.plan

    def call(cuda_core):
        fa.plan = (lambda dtype, hd: "flash_attention_fp32") if cuda_core else planner
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            logits = tfm.prefill(params, cfg, tokens)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end), logits
        finally:
            fa.plan = planner

    times = {False: [], True: []}
    for i in range(rounds + 1):
        for cuda_core in ((False, True) if i % 2 == 0 else (True, False)):
            ops.reset_launches()
            ms, logits = call(cuda_core)
            launches = {k: v for k, v in ops.launches().items() if v}
            if i:  # the first round warms up
                times[cuda_core].append(ms)
            else:
                print(f"prefill fp32, {'the CUDA-core kernel' if cuda_core else 'as planned'}: "
                      f"launches {launches}", flush=True)
    a, b = (statistics.median(times[k]) for k in (False, True))
    print(f"prefill fp32 smollm-360m 4 x 2048: ms a call as planned {a:.4f}, on the "
          f"CUDA-core kernel {b:.4f} (medians of {rounds}, in turns) [{card}]", flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_readings: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--timing", action="append", default=[])
    ap.add_argument("--no-causal", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shape] or SHAPES
    causal = not args.no_causal
    card = cs._card()
    print(card, flush=True)
    if args.prefill:
        _prefill(card)
        return 0
    fa.tf32_lib()
    fa.lib()
    for line in build.PTXAS_LOG["flash_attention_tf32"].splitlines():
        if "Used" in line or "spill" in line or "C75" in line:
            print(f"ptxas[checkout] {line.strip()}", flush=True)
    kernels = [("tf32", fa.flash_attention_tf32)]
    timing_only = set()
    for spec in args.source + args.timing:
        label, path = spec.split("=", 1)
        if spec in args.timing:
            timing_only.add(label)
        run, regs = _copy_kernel(label, path)
        for line in regs:
            print(f"ptxas[{label}] {line}", flush=True)
        kernels.append((label, run))
    kernels.append(("cuda-core", fa.flash_attention_fp32))

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in shapes:
        q, k, v = cs._flash_inputs(gen, shape, torch.float32)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kw = dict(causal=causal, window=None)
        want = fa.run_plain(q, k, v, **kw)
        for label, fn in kernels:
            d = (fn(q, k, v, **kw) - want).abs()
            ok = bool(torch.all(d <= TOL["atol"] + TOL["rtol"] * want.abs()))
            verdict = "not held" if label in timing_only else "ok" if ok else "MISMATCH"
            print(f"{label} {shape}: max_abs {float(d.max()):.3e} {verdict}", flush=True)
            if not ok and label not in timing_only:
                return 1
        del want, d
        fns = [(lambda fn=fn: fn(q, k, v, **kw), 20 if label != "cuda-core" else 10)
               for label, fn in kernels]
        fns.append((lambda: fa.run_plain(q, k, v, **kw), 5))
        fns.append((lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 10))
        times = cs._time_rotating(fns, args.rounds)
        bound, _ = cs._flash_bound(shape, causal, 4, cs.TF32_TC_FLOP_PER_S, pv_passes=3,
                                   qk_passes=3)
        line = ", ".join(f"{label} {t:.4f}" for (label, _), t in zip(kernels, times))
        print(f"{shape} fp32 causal {causal}: ms {line}, plain {times[-2]:.4f}, sdpa "
              f"{times[-1]:.4f}; 3xTF32 bound {bound:.4f} [{card}]", flush=True)
        del q, k, v, qt, kt, vt
    return 0


if __name__ == "__main__":
    sys.exit(main())
