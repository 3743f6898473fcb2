#!/usr/bin/env python3
"""Where serving's time goes on the card: a decode tick of the paged
engine, one prefill chunk, and a full-width prefill.

    python3 benchmarks_torch/profile_serve.py [--ticks 8] [--layers 32]

Builds SmolLM-360M at full width (bf16 compute, random weights from a
seed) and ``chip_smoke.py``'s serving geometry: an engine of 8 slots over
128 blocks of 16, prefill chunks of 16. Fills the 8 slots with 32-token
prompts and traces ``--ticks`` decode ticks (8 active rows), then
``--ticks`` prefill-chunk dispatches of one request, then one
``transformer.prefill`` of 4 x 2048 tokens (the flash kernel in every
layer), each with ``torch.profiler`` after a warm-up. Prints for each the
wall time per call, the device time, the device's busy share (kernel time
over wall time), kernel launches per call, the device time by category
and the 10 kernels that take the most device time. Needs one CUDA card;
exits 2 without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _category(name: str) -> str:
    n = name.lower()
    if "flash_tc_kernel" in n or "flash_fwd_kernel" in n:
        return "flash kernel (port)"
    if any(k in n for k in ("gemm", "sm90_xmma", "cutlass", "nvjet", "gemv")):
        return "matrix products (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather/scatter (pool)"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies"
    if "reduce" in n or "softmax" in n or "norm" in n or "argmax" in n:
        return "reductions"
    return "elementwise and other"


def _profile(label, fn, calls, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    by_name = defaultdict(lambda: [0, 0.0])
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            by_name[evt.key][0] += evt.count
            by_name[evt.key][1] += evt.self_device_time_total / 1e3 / calls
    device_ms = sum(t for _, t in by_name.values())
    by_cat = defaultdict(float)
    for name, (_, t) in by_name.items():
        by_cat[_category(name)] += t
    print(f"{label}: wall {wall_ms:.3f} ms/call, device {device_ms:.3f} ms/call, busy "
          f"{device_ms / wall_ms:.3f}, kernels per call "
          f"{sum(c for c, _ in by_name.values()) // calls} [{card}]", flush=True)
    for cat, t in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {t:9.3f} ms/call ({t / max(device_ms, 1e-9):.3f})")
    for name, (count, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {t:9.3f} ms/call  {count // calls:5d} x  {name[:100]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)

    from chip_smoke import PREFILL_BATCH, PREFILL_SEQ, _card
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    cfg = get_config("smollm-360m", num_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(gen, cfg, "cuda")
    rng = np.random.default_rng(0)

    def engine(n_requests, max_new):
        eng = ServeEngine(params, cfg, n_slots=8, n_blocks=128, block_size=16,
                          prefill_chunk=16)
        for uid in range(n_requests):
            eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, 32),
                               max_new_tokens=max_new))
        return eng

    eng = engine(8, 4 * args.ticks + 8)
    while not all(st == "decode" for st in eng.slot_state):
        eng.step()
    _profile(f"decode tick, {cfg.num_layers} layers, 8 rows", eng._decode_tick,
             args.ticks, card)

    eng = engine(1, 1)
    eng._admit()
    req = eng.slot_req[0]
    table = eng._on_device(eng.tables.array[:1])
    tokens = eng._on_device(np.asarray(req.prompt[None, :16], np.int64))
    _profile("prefill chunk of 16 tokens",
             lambda: eng._prefill_fn(params, tokens, eng.caches, table, 0, 16, 0),
             args.ticks, card)

    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ), generator=gen,
                         device="cuda")
    _profile(f"prefill {PREFILL_BATCH} x {PREFILL_SEQ}",
             lambda: tfm.prefill(params, cfg, toks), 2, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
