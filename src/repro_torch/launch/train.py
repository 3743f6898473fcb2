"""Training launcher of the port (``repro.launch.train``).

  python -m repro_torch.launch.train --arch smollm-360m --steps 8 \\
      --pogo-kernel --watchdog [--checkpoint-dir D --rollback]

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU (tests, ``--smoke``). Without a card and without
``--device cpu`` it raises. The sharded schedules (``--mesh``,
``--fake-devices``, ``--distributed``) and padded megagroups are not
ported and raise.
"""

from __future__ import annotations

import argparse
import ast
import logging
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--learning-rate", type=float, default=3e-4)
    ap.add_argument("--pogo-lr", type=float, default=0.5)
    ap.add_argument("--orthoptimizer", default="pogo",
                    help="pogo or landing (the ported methods)")
    ap.add_argument("--ortho-kwarg", action="append", default=[], metavar="K=V",
                    help="method-specific kwarg, e.g. find_root=True (repeatable)")
    ap.add_argument("--pogo-kernel", action="store_true")
    ap.add_argument("--ortho-grouping", default="auto",
                    choices=["auto", "per_leaf", "padded"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--watchdog", action="store_true",
                    help="feasibility watchdog + in-step Newton-Schulz drift repair")
    ap.add_argument("--watchdog-soft", type=float, default=1e-3)
    ap.add_argument("--watchdog-hard", type=float, default=1e-1)
    ap.add_argument("--rollback", action="store_true",
                    help="on a non-finite loss/StepHealth, restore the newest "
                         "valid checkpoint and skip the poison batch "
                         "(requires --checkpoint-dir)")
    ap.add_argument("--max-rollbacks", type=int, default=8)
    ap.add_argument("--fake-devices", type=int, default=None)
    ap.add_argument("--mesh", default="none", choices=["none", "test", "test-multipod"])
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for tests")
    args = ap.parse_args(argv)

    if args.mesh != "none" or args.fake_devices or args.distributed:
        raise NotImplementedError(
            "--mesh, --fake-devices and --distributed are not ported yet "
            "(ROADMAP: sharded schedules)")
    if args.ortho_grouping == "padded":
        raise NotImplementedError(
            "--ortho-grouping padded is not ported yet (ROADMAP: ragged megagroups)")
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")

    import torch

    from .._device import resolve_device
    from ..configs import get_config
    from ..core import api as core
    from ..data.pipeline import DataConfig, DataIterator
    from ..models import ortho
    from ..models import transformer as tfm
    from ..train.loop import LoopConfig, train
    from ..train.train_step import TrainConfig, make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = ortho.project_init(tfm.init_params(gen, cfg, device), cfg)

    ortho_kwargs = {}
    for kv in args.ortho_kwarg:
        k, _, v = kv.partition("=")
        try:
            ortho_kwargs[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            ortho_kwargs[k] = v
    train_cfg = TrainConfig(
        learning_rate=args.learning_rate,
        pogo_learning_rate=args.pogo_lr,
        microbatches=args.microbatches,
        orthoptimizer=args.orthoptimizer,
        ortho_kwargs=ortho_kwargs,
        ortho_grouping=args.ortho_grouping,
        pogo_use_kernel=args.pogo_kernel,
        warmup_steps=min(20, args.steps // 5 + 1),
        decay_steps=args.steps,
        ortho_watchdog=(core.WatchdogConfig(soft=args.watchdog_soft,
                                            hard=args.watchdog_hard)
                        if args.watchdog else None),
    )
    step_fn, optimizer = make_train_step(cfg, train_cfg)
    opt_state = optimizer.init(params)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                   global_batch=args.global_batch, seed=args.seed),
                        device=device)
    loop_cfg = LoopConfig(total_steps=args.steps, save_every=args.save_every,
                          checkpoint_dir=args.checkpoint_dir, rollback=args.rollback,
                          max_rollbacks=args.max_rollbacks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, opt_state, step, history = train(step_fn, params, opt_state, data, loop_cfg)
    final = history[-1][1] if history else {}
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**20
        print(f"peak device memory: {peak:.1f} MiB ({torch.cuda.get_device_name(device)})")
    summary = core.watchdog_summary(opt_state)
    if summary is not None:
        print(f"watchdog: {summary}")
    print(f"done: step={step} metrics={final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
