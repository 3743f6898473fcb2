#!/usr/bin/env python3
"""Readings behind the bf16 parity limits of serving: how far a sound path
and a planted fault read from their reference at SmolLM-360M's full width.

    python3 benchmarks_torch/parity_readings.py [--cpu-fp32]

Prefill (4 x 2048 tokens, bf16, 32 layers): the largest difference of the
last-position logits from the same call with the plain version of the
flash kernel in ``ops.flash_attention``'s place, over the largest |logit|,
and the argmax agreement, for
  * the kernel (the sound path),
  * the training path's attention, ``_flash_attend``, which rounds the
    probabilities to bf16 before ``p @ v`` (a lower-precision control),
  * two planted faults in the plain version: the first 64-key tile dropped
    for every row past it, and key 0 dropped for the last row only.

Engine (``chip_smoke.py``'s serving geometry: 8 slots, 128 blocks of 16,
prefill chunks of 16, folded q/k; 8 prompts of 8-48 tokens, 16 new
tokens each): the largest logit difference from
``generate_reference`` over the tokens both share (up to and including the
first that differs), per request, for
  * the engine as it is,
  * a cache off by about a bf16 ulp: the request's K blocks of the first
    layer scaled by 1 + 2^-7 once its prefill ends,
  * a decode position off by one: every decode dispatch gets lengths + 1.

``--cpu-fp32`` takes the engine's readings alone on the CPU, at the smoke
config in fp32 with 4 prompts and 6 new tokens each, the setting of the
CPU tests.

The limits in ``repro_torch/serve/parity.py`` (``LOGIT_LIMITS``) and
``chip_smoke.py`` (``PREFILL_REL_TOL``) sit between the sound readings and
the faults'. Needs one CUDA card without ``--cpu-fp32``; exits 2 without
one.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masked_plain(drop):
    """The plain attention with the extra mask ``drop(q_pos, k_pos)``."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def attend(q, k, v, *, causal=True, window=None):
        b, sq, h, hd = q.shape
        groups = h // k.shape[2]
        qf = fa._heads_first(q).float()
        kf, vf = (fa._heads_first(t.repeat_interleave(groups, dim=2)).float()
                  for t in (k, v))
        s = (qf @ kf.transpose(1, 2)) * hd**-0.5
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = (kp <= qp) & ~drop(qp, kp)
        s = torch.where(keep[None], s, ref.NEG_INF)
        out = (torch.softmax(s, dim=-1) @ vf).to(q.dtype)
        return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3)
    return attend


def prefill_readings(card):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    cfg = get_config("smollm-360m")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tfm.init_params(gen, cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen, device="cuda")

    def through(fn):
        kernel = ops.flash_attention
        ops.flash_attention = fn
        try:
            out = tfm.prefill(params, cfg, tokens).float()
            torch.cuda.synchronize()
            return out
        finally:
            ops.flash_attention = kernel

    plain = through(lambda q, k, v, *, causal=True, window=None: fa.run_plain(
        q, k, v, causal=causal, window=window))
    top = float(plain.abs().max())
    variants = {
        "kernel (sound)": ops.flash_attention,
        "p in bf16 (_flash_attend, control)":
            lambda q, k, v, *, causal=True, window=None: attention._flash_attend(
                q, k, v, causal=causal, window=window),
        "first key tile dropped (fault)": _masked_plain(lambda qp, kp: (kp < 64) & (qp >= 64)),
        "key 0 dropped for the last row (fault)":
            _masked_plain(lambda qp, kp: (kp == 0) & (qp == tokens.shape[1] - 1)),
    }
    for name, fn in variants.items():
        got = through(fn)
        err = float((got - plain).abs().max())
        agree = int((got.argmax(-1) == plain.argmax(-1)).sum())
        print(f"prefill {name}: max_abs {err:.4e}, relative {err / top:.4e} "
              f"(max |logit| {top:.4f}), argmax agrees {agree}/{got.shape[0]} [{card}]",
              flush=True)
    del params


def engine_readings(card, device="cuda", smoke=False):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ortho
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import (Request, ServeEngine, extract_constraint_set,
                                   fold_constraint_set, generate_reference, parity)

    cfg = get_config("smollm-360m", smoke=smoke)
    if smoke:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    n_requests, new = (4, 6) if smoke else (8, 16)
    gen = torch.Generator(device=device).manual_seed(0)
    params = ortho.project_init(tfm.init_params(gen, cfg, device), cfg)
    params = fold_constraint_set(params, cfg, extract_constraint_set(params, cfg)).params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(rng.integers(8, 49)),))
               .astype(np.int32) for _ in range(n_requests)]
    refs = []
    for p in prompts:
        logits: list = []
        refs.append((generate_reference(params, cfg, p, new, logits=logits), logits))

    def cache_ulp(eng):
        base = eng._prefill_fn

        def run(params_, tokens, caches, block_table, start, n_valid, slot):
            res = base(params_, tokens, caches, block_table, start, n_valid, slot)
            if start + n_valid >= len(eng.slot_req[slot].prompt):
                blocks = torch.as_tensor(eng.tables.owned(slot), device=device)
                k = res[1]["unit"][0].k
                k[0, blocks] = k[0, blocks] * (1 + 2.0**-7)
            return res
        eng._prefill_fn = run

    def position(eng):
        base = eng._decode_fn

        def run(params_, tokens, caches, block_tables, lengths, mask, *poison):
            return base(params_, tokens, caches, block_tables, lengths + mask.long(),
                        mask, *poison)
        eng._decode_fn = run

    for name, plant in (("engine (sound)", None), ("cache off by a bf16 ulp (fault)",
                        cache_ulp), ("decode position + 1 (fault)", position)):
        eng = ServeEngine(params, cfg, n_slots=8, n_blocks=128, block_size=16,
                          prefill_chunk=16)
        if plant is not None:
            plant(eng)
        rec = parity.record_logits(eng)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        errs, parts = [], 0
        for r, (ref, ref_logits) in zip(reqs, refs):
            c = parity.compare_tokens(r.out_tokens, ref, ref_logits, rec[r.uid],
                                      limit=float("inf"))
            errs.append(c["err"])
            parts += not c["identical"]
        print(f"{name}: logit error per request {[f'{e:.4e}' for e in errs]}, max "
              f"{max(errs):.4e}, min {min(errs):.4e}, {parts}/{len(reqs)} part from the "
              f"oracle (limit in use {parity.LOGIT_LIMITS[cfg.compute_dtype]}) [{card}]",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-fp32", action="store_true",
                    help="the engine's readings on the CPU, smoke config in fp32")
    args = ap.parse_args(argv)
    import torch

    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    if args.cpu_fp32:
        engine_readings("CPU", device="cpu", smoke=True)
        return 0
    if not torch.cuda.is_available():
        print("parity_readings: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import _card

    card = _card()
    with torch.no_grad():
        prefill_readings(card)
    engine_readings(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
