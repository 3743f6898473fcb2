#!/usr/bin/env python3
"""Where one constraint step's time goes on the card.

    python3 benchmarks_torch/profile_step.py [--steps 5] [--seed 0]

Runs each of the port's main paths (``--paths``, all by default) with
``constraint_step`` on the SmolLM-360M q/k stack (640 x (64, 960)) and on
2048 x (16, 256). The paths and their optimizers are ``chip_smoke.py``'s
(``chip_smoke.make_opt``): ``fused`` (the fused group step),
``pogo_adam`` (the two-stage step through the POGO update kernels),
``landing`` (the paper's Landing: the landing-field kernels and the safe
step) and ``landing_fused`` (fixed-step Landing on the fused kernels'
Landing branches). ``tp`` is the tensor-parallel schedule on one card
(``ops.fused_group_step_tp``, POGO over VAdam, two shards: two
``tp_gram`` launches, the payload sum, one ``tp_apply``); the two-rank
route of ``chip_smoke.py`` adds one gloo all-reduce to it.

It traces ``--steps`` steps after three warm-up steps with
``torch.profiler`` and prints, per path and shape, the wall time per
step, the device time of every kernel by name, and the device's busy
share (kernel time over wall time). Needs one CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(path, shapes, label, steps, seed):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from chip_smoke import GRAD_SCALE, make_opt
    from repro_torch.core import api, stiefel

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {k: stiefel.random_stiefel(gen, s, device="cuda") for k, s in shapes.items()}
    cs = api.ConstraintSet.from_tree(params)
    if path == "tp":
        step, state = _tp_step(cs)
    else:
        opt = make_opt(path)
        state = opt.init(cs)
        step = api.constraint_step(opt)
    grads = [api.ConstraintSet(cs.plan, [GRAD_SCALE * torch.randn(s.shape, generator=gen,
                                                            device="cuda")
                                         for s in cs.stacks])
             for _ in range(steps + 3)]
    for gs in grads[:3]:
        cs, state, health = step(cs, state, gs)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for gs in grads[3:]:
            cs, state, health = step(cs, state, gs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name[evt.name]
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    if not bool(health.finite):
        raise SystemExit(f"{label}: non-finite step")
    device_us = sum(us for _, us in by_name.values())
    print(f"{label}: {steps} steps, wall {wall_us / steps:.1f} us/step, device "
          f"{device_us / steps:.1f} us/step, busy share "
          + (f"{device_us / wall_us:.3f}" if device_us else "not measured"), flush=True)
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / steps:10.1f} us/step  {count // steps:3d}x/step  {name[:90]}",
              flush=True)


def _tp_step(cs):
    """A ``constraint_step``-shaped step of the single-device TP schedule
    (POGO over VAdam, two shards) on a one-stack set, and its state."""
    import torch

    from chip_smoke import LR
    from repro_torch.core import api
    from repro_torch.health import from_residual
    from repro_torch.kernels import ops

    x = cs.stacks[0]

    def step(cs, state, gs):
        mu, nu, count = state
        x2, mu2, nu2, dist, _ = ops.fused_group_step_tp(
            cs.stacks[0], gs.stacks[0], LR, method="pogo", lam=0.5, base_kind="vadam",
            hyper=(0.9, 0.999, 1e-8), mu=mu, nu=nu, count=count, tp_shards=2)
        return api.ConstraintSet(cs.plan, [x2]), (mu2, nu2, count + 1), \
            from_residual(dist.max())

    state = (torch.zeros_like(x), torch.zeros(x.shape[0], device=x.device),
             torch.zeros((), dtype=torch.int32, device=x.device))
    return step, state


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default="fused,pogo_adam,landing,landing_fused,tp")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]  # the package; chip_smoke's paths
    from repro_torch.configs import smollm_360m
    from repro_torch.models import ortho

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    shapes = ortho.orthogonal_leaf_shapes(smollm_360m.config())
    for path in args.paths.split(","):
        profile(path, shapes, f"{path} smollm-360m q/k 640x(64,960)", args.steps,
                args.seed)
        profile(path, {"w": (2048, 16, 256)}, f"{path} 2048x(16,256)", args.steps,
                args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
