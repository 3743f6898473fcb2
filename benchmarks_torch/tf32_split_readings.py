#!/usr/bin/env python3
"""How many TF32 pieces the tensor-core fused step needs for fp32 results.

    python3 benchmarks_torch/tf32_split_readings.py [--device cpu|cuda] [--seed 0]
        [--batch 32] [--steps 10]

The tensor-core fused step (``csrc/fused_step_tc.cu``) runs every product
on TF32 tensor cores, which read an fp32 operand's 10 top mantissa bits
only. This runs the plain fused POGO step over VAdam
(``ref.fused_group_step_ref``'s arithmetic) with each of its products in
emulated TF32 and compares with the same step in fp32:

* 1xTF32: both operands as the tensor cores read fp32 values, the low 13
  bits dropped (a kernel without lo pieces);
* 2xTF32: hi.hi + hi.lo, with hi = tf32(x) and lo = tf32(x - hi) rounded
  to nearest (cvt.rna.tf32.f32);
* 3xTF32: hi.hi + hi.lo + lo.hi (lo.lo dropped);
* 3xTF32 trunc: the same with hi = x as the tensor cores read it, its low
  13 bits dropped, and lo = tf32(x - hi): the kernel's split, where a
  tile that holds x is its own hi.

The products of TF32 values are summed in float64, so the readings show
the operand split alone. At (B, p, n) = (``--batch``, 64, 960), SmolLM-
360M's q/k width: one step's max abs and max relative error of X', mu',
nu' and the distance against fp32 (the kernels' tiled tolerance is atol
3e-5 / rtol 1e-4), and after ``--steps`` steps at lr 0.05 the largest
reported distance and the largest true ``||X X^T - I||_F`` (float64).
Inputs are Stiefel matrices and gradients drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import ref  # noqa: E402

TILED_TOL = dict(atol=3e-5, rtol=1e-4)
HYPER = (0.9, 0.999, 1e-8)  # VAdam's (b1, b2, eps)
LR, LAM = 0.05, 0.5
TERMS = {"fp32": 0, "1xTF32": 1, "2xTF32": 2, "3xTF32": 3, "3xTF32 trunc": 4}


def tf32(x: torch.Tensor, rna: bool) -> torch.Tensor:
    """x with its low 13 mantissa bits dropped (``rna``: rounded to nearest,
    ties away from zero, first)."""
    u = x.contiguous().view(torch.int32)
    if rna:
        u = u + 0x1000
    return (u & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """``a @ b`` in fp32 (``terms`` 0), through ``terms`` TF32 products, or
    (4) three with hi truncated."""
    if terms == 0:
        return a @ b
    if terms == 1:
        return (tf32(a, False).double() @ tf32(b, False).double()).float()
    ah, bh = tf32(a, terms != 4), tf32(b, terms != 4)
    al, bl = tf32(a - ah, True), tf32(b - bh, True)
    out = ah.double() @ bh.double() + ah.double() @ bl.double()
    if terms >= 3:
        out = out + al.double() @ bh.double()
    return out.float()


def pogo_vadam_step(x, g, mu, nu, count, terms: int):
    """``ref.fused_group_step_ref(method="pogo", base_kind="vadam")`` with its
    products through :func:`product`: returns (X', mu', nu', dist)."""
    def mm(a, b):
        return product(a, b, terms)

    b1, b2, eps = HYPER
    t = float(count + 1)
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * torch.sum(g * g, dim=(-2, -1))
    geff = (mu2 / (1.0 - b1**t)) / (torch.sqrt(nu2 / (1.0 - b2**t)) + eps)[..., None, None]
    xt = x.transpose(-1, -2)
    a, bm = mm(x, xt), mm(x, geff.transpose(-1, -2))
    m = x - LR * (0.5 * (mm(a, geff) - mm(bm, x)))
    c = mm(m, m.transpose(-1, -2))
    x2 = (1.0 + LAM) * m - LAM * mm(c, m)
    c2 = mm(c, c)
    w = (1.0 + LAM) ** 2 * c - 2.0 * LAM * (1.0 + LAM) * c2 + LAM**2 * mm(c2, c)
    eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    dist = torch.sqrt(torch.sum((w - eye) ** 2, dim=(-2, -1)))
    return x2, mu2, nu2, dist


def inputs(batch: int, p: int, n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((batch, n, p)))
    x = np.swapaxes(q, -1, -2)
    g = 0.01 * rng.standard_normal((batch, p, n))
    mu = 0.01 * rng.standard_normal((batch, p, n))
    nu = np.abs(rng.standard_normal(batch)) * 1e-2
    return [torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
            for a in (x, g, mu, nu)]


def true_distance(x: torch.Tensor) -> torch.Tensor:
    xd = x.double()
    eye = torch.eye(x.shape[-2], dtype=torch.float64, device=x.device)
    return torch.linalg.matrix_norm(xd @ xd.transpose(-1, -2) - eye)


def readings(batch=32, p=64, n=960, steps=10, seed=0, device="cpu"):
    """{name: dict(max_abs, max_rel, within_tol, dist_after, true_dist_after)}
    for each product mode of :data:`TERMS`."""
    x, g, mu, nu = inputs(batch, p, n, seed, device)
    rng = np.random.default_rng(seed + 1)
    grads = [torch.tensor(0.01 * rng.standard_normal((batch, p, n)), dtype=torch.float32,
                          device=device) for _ in range(steps)]
    want = ref.fused_group_step_ref(x, g, LR, method="pogo", lam=LAM, base_kind="vadam",
                                    hyper=HYPER, mu=mu, nu=nu, count=torch.tensor(0))
    out = {}
    for name, terms in TERMS.items():
        got = pogo_vadam_step(x, g, mu, nu, 0, terms)
        max_abs = max_rel = 0.0
        ok = True
        for a, b in zip(got, want[:4]):
            d = (a - b).abs()
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float(d.max() / b.abs().max()))
            ok &= bool(torch.all(d <= TILED_TOL["atol"] + TILED_TOL["rtol"] * b.abs()))
        xs, ms, ns = x, mu, nu
        dist = None
        for k in range(steps):
            xs, ms, ns, dist = pogo_vadam_step(xs, grads[k], ms, ns, k, terms)
        out[name] = dict(max_abs=max_abs, max_rel=max_rel, within_tol=ok,
                         dist_after=float(dist.max()),
                         true_dist_after=float(true_distance(xs).max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = readings(args.batch, 64, 960, args.steps, args.seed, args.device)
    for name, r in res.items():
        print(f"{name}: one step vs fp32 max_abs {r['max_abs']:.3e} max_rel "
              f"{r['max_rel']:.3e} within atol 3e-5 / rtol 1e-4 {r['within_tol']}; after "
              f"{args.steps} POGO steps over VAdam at lr {LR}: reported distance "
              f"{r['dist_after']:.3e}, true distance {r['true_dist_after']:.3e} "
              f"[(B, p, n) = ({args.batch}, 64, 960), {args.device}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
