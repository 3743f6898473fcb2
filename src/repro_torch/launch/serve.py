"""Serving launcher of the port (``repro.launch.serve``): paged continuous
batching over a synthetic request stream, with the orthogonal constraint
stacks folded into the serving params first.

  python -m repro_torch.launch.serve --arch smollm-360m --requests 32 \\
      --min-prompt-len 8 --prompt-len 48 --max-new 16 --slots 8 \\
      --blocks 128 --block-size 16

runs on the CUDA card; ``--device cpu`` runs on the CPU (tests,
``--smoke``). Without a card and without ``--device cpu`` it raises.
Prompt lengths are ``--prompt-len`` tokens, or drawn uniformly from
``[--min-prompt-len, --prompt-len]`` when the minimum is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="draw each prompt's length from [this, --prompt-len]")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=64,
                    help="KV pool size in blocks (block 0 is reserved)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per KV block")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--no-fold", action="store_true",
                    help="skip the constraint-set fold (serve raw params)")
    ap.add_argument("--preemption", choices=["off", "swap", "kill"],
                    default="off",
                    help="evict a victim when the queue head starves: "
                    "'swap' keeps it restorable host-side, 'kill' fails it")
    ap.add_argument("--preempt-after", type=int, default=4,
                    help="consecutive starved ticks before preempting")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request deadline (engine ticks); expired "
                    "requests get terminal state EXPIRED")
    ap.add_argument("--ttft-budget-ticks", type=int, default=None,
                    help="per-request first-token budget (engine ticks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for tests")
    return ap


def run(argv=None) -> dict:
    """Build, fold, fill and drain an engine as :func:`main` does; returns
    ``engine``, ``params``, ``cfg``, ``requests``, ``terminal``,
    ``seconds`` (the drain's wall time) and ``fold`` (the FoldResult or
    None)."""
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..configs import get_config
    from ..models import ortho
    from ..models import transformer as tfm
    from ..serve import (
        Request,
        RequestState,
        ServeEngine,
        extract_constraint_set,
        fold_constraint_set,
    )

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = ortho.project_init(tfm.init_params(gen, cfg, device), cfg)

    fold = None
    if not args.no_fold:
        cs = extract_constraint_set(params, cfg)
        fold = fold_constraint_set(params, cfg, cs)
        params = fold.params
        print(f"folded {fold.n_leaves} constrained leaves "
              f"(max off-manifold distance {fold.max_distance:.2e})")

    engine = ServeEngine(
        params, cfg, n_slots=args.slots, n_blocks=args.blocks,
        block_size=args.block_size, prefill_chunk=args.prefill_chunk,
        preemption=args.preemption, preempt_after_ticks=args.preempt_after,
    )
    rng = np.random.default_rng(args.seed)
    requests = []
    for uid in range(args.requests):
        plen = args.prompt_len
        if args.min_prompt_len is not None:
            plen = int(rng.integers(args.min_prompt_len, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)
        req = Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                      deadline_ticks=args.deadline_ticks,
                      ttft_budget_ticks=args.ttft_budget_ticks)
        engine.submit(req)
        requests.append(req)

    t0 = time.perf_counter()
    terminal = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    done = [r for r in terminal if r.state is RequestState.FINISHED]
    n_tokens = sum(len(r.out_tokens) for r in done)
    s = engine.stats
    print(
        f"served {len(done)}/{len(terminal)} requests, {n_tokens} tokens "
        f"in {dt:.2f}s ({n_tokens / max(dt, 1e-9):.1f} tok/s; "
        f"{s['n_prefill_dispatches']} prefill chunks, "
        f"{s['n_decode_dispatches']} decode steps, "
        f"{s['preemptions']} preemptions, {s['expired']} expired)"
    )
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out_tokens[:8]}...")
    return dict(engine=engine, params=params, cfg=cfg, requests=requests,
                terminal=terminal, seconds=dt, fold=fold)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
