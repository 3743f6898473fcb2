#!/usr/bin/env python3
"""Where one training step's time goes on the card.

    python3 benchmarks_torch/profile_train.py [--steps 3] [--layers 32]

Builds ``chip_smoke.py``'s trainer (SmolLM-360M at full width, batch
8 x 512, POGO's fused kernel over VAdam on the q/k group, AdamW elsewhere,
the watchdog on) through ``make_train_step``, runs two warm-up steps,
times the step's phases (forward and backward, the optimizer update,
applying the updates) over ``--steps`` steps, then traces ``--steps``
steps with ``torch.profiler``. Prints the phases' times, the wall time per
step, the device's busy share (kernel time over wall time), the device
time by category (bf16 and fp32 matrix products, the port's kernels,
elementwise and reduction kernels, copies) and the 15 kernels that take
the most device time. Needs one CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _category(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("fused_whole_kernel", "fused_tiled_kernel",
                            "two_stage_", "ns_tiled_kernel", "ns_whole_kernel")):
        return "port kernels"
    if any(k in n for k in ("gemm", "sm90_xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reductions"
    return "elementwise and other"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRAIN_BATCH, TRAIN_POGO_LR, TRAIN_SEQ, _card
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models import ortho
    from repro_torch.models import transformer as tfm
    from repro_torch import optim
    from repro_torch.train.train_step import TrainConfig, loss_and_grads, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    cfg = get_config("smollm-360m", num_layers=args.layers)
    tc = TrainConfig(pogo_learning_rate=TRAIN_POGO_LR, pogo_use_kernel=True,
                     ortho_watchdog=api.WatchdogConfig(), warmup_steps=2,
                     decay_steps=args.steps + 2)
    step_fn, opt = make_train_step(cfg, tc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ortho.project_init(tfm.init_params(gen, cfg, "cuda"), cfg)
    state = opt.init(params)
    data = DataIterator(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                        device="cuda")
    for _ in range(2):
        params, state, m = step_fn(params, state, next(data))
    torch.cuda.synchronize()
    # The step's phases, as train_step runs them, each bracketed by CUDA
    # events and the host clock (a synchronize after each phase).
    phases = defaultdict(list)
    for _ in range(args.steps):
        batch = next(data)
        marks = []

        def mark():
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((time.perf_counter(), ev))

        mark()
        loss, grads = loss_and_grads(params, cfg, batch)
        mark()
        updates, state = opt.update(grads, state, params)
        mark()
        params = optim.apply_updates(params, updates)
        mark()
        for name, (a, b) in zip(("forward + backward", "optimizer update",
                                 "apply updates"), zip(marks, marks[1:])):
            phases[name].append((1e3 * (b[0] - a[0]), a[1].elapsed_time(b[1])))
    for name, runs in phases.items():
        print(f"  phase {name:20s} wall {statistics.median(r[0] for r in runs):9.3f} ms, "
              f"events {statistics.median(r[1] for r in runs):9.3f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, state, m = step_fn(params, state, next(data))
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    by_name = defaultdict(lambda: [0, 0.0])
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            by_name[evt.key][0] += evt.count
            by_name[evt.key][1] += evt.self_device_time_total / 1e3 / args.steps
    device_ms = sum(t for _, t in by_name.values())
    by_cat = defaultdict(float)
    for name, (_, t) in by_name.items():
        by_cat[_category(name)] += t
    print(f"trainer {cfg.name} {cfg.num_layers} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"wall {wall_ms:.2f} ms/step, device {device_ms:.2f} ms/step, busy "
          f"{device_ms / wall_ms:.3f}, kernels launched per step "
          f"{sum(c for c, _ in by_name.values()) // args.steps} [{card}]")
    for cat, t in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {t:9.3f} ms/step ({t / device_ms:.3f})")
    for name, (count, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {t:9.3f} ms/step  {count // args.steps:5d} x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
