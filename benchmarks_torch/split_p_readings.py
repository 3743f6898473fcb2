#!/usr/bin/env python3
"""How many bf16 pieces of p the tensor-core flash kernel needs.

    python3 benchmarks_torch/split_p_readings.py [--device cpu|cuda] [--seed 0]

The bf16 flash kernel (``csrc/flash_attention_tc.cu``) runs PV on bf16
pieces of the fp32 p: each piece the bf16 rounding of what the pieces
before it leave. For 1, 2 and 3 pieces, this runs a plain attention that
does the same (fp32 scores, exp, row sums, products in fp32) against the
same attention with the fp32 p, both rounded once to bf16, and counts the
outputs outside the kernel's per-element check (atol 1e-6, rtol 1/64: one
output ulp, ``chip_smoke.FLASH_BF16_TOL``), causal, one batch row of each
shape: SmolLM-360M's prefill heads (15 over 2048 keys, hd 64),
internlm2-1.8b's (16, hd 128) and the windowed S = 2000 case. Inputs are
bf16 draws of a standard normal from ``--seed``. Prints one line per
shape and piece count.
"""

from __future__ import annotations

import argparse

import torch

NEG_INF = -(2.0**30)
SHAPES = [  # (heads, S, hd, window)
    (15, 2048, 64, None),
    (16, 2048, 128, None),
    (15, 2000, 64, 256),
]


def attention(q, k, v, window, pieces):
    """Causal attention on ``(H, S, hd)``; p in ``pieces`` bf16 pieces, or
    fp32 when ``pieces`` is 0; the output rounded to bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s_len, hd = q.shape[1], q.shape[2]
    s = (qf @ kf.transpose(-1, -2)) * hd**-0.5
    i = torch.arange(s_len, device=q.device)[:, None]
    j = torch.arange(s_len, device=q.device)[None]
    mask = j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if pieces == 0:
        out = p @ vf
    else:
        out = torch.zeros_like(qf)
        for _ in range(pieces):
            piece = p.bfloat16().float()
            out += piece @ vf
            p = p - piece
    return (out / l).bfloat16().float()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    for h, s_len, hd, window in SHAPES:
        q, k, v = (torch.randn((h, s_len, hd), generator=gen, device=args.device).bfloat16()
                   for _ in range(3))
        want = attention(q, k, v, window, 0)
        for pieces in (1, 2, 3):
            got = attention(q, k, v, window, pieces)
            d = (got - want).abs()
            missed = int((d > 1e-6 + want.abs() / 64).sum())
            print(f"heads {h} S {s_len} hd {hd} window {window}: {pieces} piece(s) miss "
                  f"{missed} of {d.numel()} outputs ({missed / d.numel():.3e}), max abs "
                  f"{float(d.max()):.3e} [{args.device}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
