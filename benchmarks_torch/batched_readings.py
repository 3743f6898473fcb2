#!/usr/bin/env python3
"""The batched whole-matrix kernels on the card (``csrc/batched_whole.cu``:
rows 1b, 1Lb and 5b, a thread a matrix) beside the old whole kernels they
replace on the planner's route at p <= n <= 4 (rows 1, 1L and 5,
``csrc/fused_step.cu`` and ``csrc/two_stage.cu``), in one call.

    python3 benchmarks_torch/batched_readings.py [--check-only] [--shapes]
        [--no-phase]

Builds the three sources, prints ptxas's lines for ``batched_whole.cu``
(registers, spills) and runs ``chip_smoke.py``'s ``phase_batched_whole``:
each entry held against its plain version at the paper's 218,624 x (3, 3)
and at the edge cases (tail groups, every p <= n <= 4, a misaligned view,
in place, ragged rows, every base), timed in turns with the old kernel and
the plain version (rotating through copies of the inputs past L2, and
warm) and their device times; ``--check-only`` holds them without timing,
``--no-phase`` skips the phase. ``--shapes`` reads each entry's and the old
kernel's device time a launch, warm (``chip_smoke._device_us``,
``torch.profiler``), at ``SHAPES``: every p <= n <= 4, which the planner
sends to the batched kernel (``ops.BATCHED_MAX_N``). Prints the card's name and power limit. Needs one
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# (B, p, n): every p <= n <= 4 at the paper's count of CNN kernels.
SHAPES = [(218624, p, n) for n in range(1, 5) for p in range(1, n + 1)]


def _device_times(cs, gen, card, shapes, calls=5):
    """Each batched entry and the old whole kernel at ``shapes``: device
    microseconds a launch (``chip_smoke._device_us``)."""
    for shape in shapes:
        x, g, mu, nu = cs._operands(gen, *shape)
        for name in ("fused_step_batched", "fused_step_batched_landing", "pogo_update_batched"):
            base, hyper = ("none", ()) if name.startswith("pogo") else ("trace", (0.9, False))
            run, _, _ = cs._batched_entry(name, x, g, mu, nu, base, hyper)
            old = cs._batched_old(name)
            for label, fn in (("batched", lambda: run(x, g, mu, nu)),
                              ("old", lambda: run(x, g, mu, nu, wrapper=old))):
                print(f"device {name} ({label}) {shape}: "
                      f"{cs._us(cs._device_us(fn, calls))} a launch [{card}]", flush=True)
        del x, g, mu, nu


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batched_readings: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--shapes", action="store_true")
    parser.add_argument("--no-phase", action="store_true")
    args = parser.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import pogo_update as pu

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card()
    print(card, flush=True)
    for name in ("batched_whole", "fused_step", "two_stage"):
        build.load(name)
    fs._lib(), fs.batched_lib(), pu.lib()
    for line in build.PTXAS_LOG["batched_whole"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas[batched_whole] {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.no_phase:
        cs.phase_batched_whole(gen, card, timed=not args.check_only)
    if args.shapes:
        _device_times(cs, gen, card, SHAPES)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
