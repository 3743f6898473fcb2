"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and what ``chip_smoke.py``
holds the kernel against on the card, and mirrors ``repro.kernels.ref``
(the JAX oracle) line for line, in fp32:

* ``fused_group_step_ref``: both kernels of ``csrc/fused_step.cu``;
* ``pogo_update_ref``: ``pogo_update_whole``/``_tiled`` of ``csrc/two_stage.cu``;
* ``landing_field_ref``: ``landing_field``/``_tiled`` of ``csrc/two_stage.cu``;
* ``manifold_distance_ref``: the telemetry of the two-stage step;
* ``newton_schulz_ref``: both kernels of ``csrc/newton_schulz.cu``.
"""

from __future__ import annotations

import torch

from ..core import stiefel


def _bt(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def pogo_update_ref(x: torch.Tensor, g: torch.Tensor, eta, lam) -> torch.Tensor:
    """POGO update, fp32 accumulation, ``(..., p, n)`` batched.

    A = X X^T; B = X G^T; R = 1/2 (A G - B X); M = X - eta R
    C = M M^T; X' = (1 + lam) M - lam C M
    """
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    eta = torch.as_tensor(eta, dtype=torch.float32, device=xf.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xf.device)
    a = xf @ _bt(xf)
    b = xf @ _bt(gf)
    r = 0.5 * (a @ gf - b @ xf)
    m = xf - eta * r
    c = m @ _bt(m)
    out = (1.0 + lam) * m - lam * (c @ m)
    return out.to(x.dtype)


def landing_field_ref(x: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """Landing field: ``Lambda = 1/2 (A G - B X) + lam (A - I) X``."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    a = xf @ _bt(xf)
    b = xf @ _bt(gf)
    r = 0.5 * (a @ gf - b @ xf)
    eye = torch.eye(x.shape[-2], dtype=torch.float32, device=xf.device)
    n_field = (a - eye) @ xf
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xf.device)
    return (r + lam * n_field).to(x.dtype)


def manifold_distance_ref(x: torch.Tensor) -> torch.Tensor:
    """``||X X^T - I||_F`` per matrix."""
    xf = x.to(torch.float32)
    eye = torch.eye(x.shape[-2], dtype=torch.float32, device=xf.device)
    r = xf @ _bt(xf) - eye
    return torch.sqrt(torch.sum(r * r, dim=(-2, -1)))


def newton_schulz_ref(x: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Batched Newton-Schulz polar projection: ``Y = X / ||X||_F``, then
    ``iters`` times ``Y <- 1.5 Y - 0.5 (Y Y^T) Y``."""
    xf = x.to(torch.float32)
    fro = torch.sqrt(torch.sum(xf * xf, dim=(-2, -1), keepdim=True))
    y = xf / torch.clamp_min(fro, 1e-30)
    for _ in range(iters):
        y = 1.5 * y - 0.5 * ((y @ _bt(y)) @ y)
    return y.to(x.dtype)


def pogo_gram_identity_ref(c: torch.Tensor, lam) -> torch.Tensor:
    """``X' X'^T`` from the land-stage gram ``C = M M^T``:
    ``(1+lam)^2 C - 2 lam (1+lam) C^2 + lam^2 C^3`` (no re-read of X')."""
    lam = torch.as_tensor(lam, dtype=c.dtype, device=c.device)
    c2 = c @ c
    c3 = c2 @ c
    return (1.0 + lam) ** 2 * c - 2.0 * lam * (1.0 + lam) * c2 + lam**2 * c3


def _residual_norm(w: torch.Tensor, pv: torch.Tensor | None = None) -> torch.Tensor:
    """``||W - I||_F`` per matrix; ``pv`` (per-matrix valid-row counts)
    masks the identity's padded diagonal."""
    p = w.shape[-1]
    if pv is None:
        eye = torch.eye(p, dtype=w.dtype, device=w.device)
    else:
        eye = stiefel.masked_eye(p, pv, w.dtype)
    r = w - eye
    return torch.sqrt(torch.sum(r.abs() ** 2, dim=(-2, -1)))


def fused_group_step_ref(
    x: torch.Tensor,
    g: torch.Tensor,
    eta,
    *,
    method: str,
    lam,
    base_kind: str = "none",
    hyper: tuple = (),
    post_scale: float = 1.0,
    mu: torch.Tensor | None = None,
    nu: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
    pv: torch.Tensor | None = None,
):
    """One fused group step on a ``(B, p, n)`` stack, fp32 accumulation.

    Base optimizer (``none`` | ``trace`` (+nesterov) | ``vadam`` with the
    bias correction from ``count + 1``), POGO direction, leap and land, and
    the per-matrix distance ``||X' X'^T - I||_F`` from the land gram.
    Returns ``(x_next_f32, mu', nu', dist, finite)`` with ``None`` for a
    moment the base does not have and ``finite = isfinite(dist)``.
    """
    if method != "pogo":
        raise NotImplementedError(
            f"fused method {method!r} is not ported yet (ROADMAP: Landing's "
            "fused branches)"
        )
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    mu_out = nu_out = None
    if base_kind == "none":
        geff = gf
    elif base_kind == "trace":
        decay, nesterov = hyper
        mu2 = decay * mu.to(torch.float32) + gf
        geff = decay * mu2 + gf if nesterov else mu2
        mu_out = mu2.to(mu.dtype)
    elif base_kind == "vadam":
        b1, b2, eps = hyper
        t = (count + 1).to(torch.float32)
        mu2 = b1 * mu.to(torch.float32) + (1.0 - b1) * gf
        sq = torch.sum(gf * gf, dim=(-2, -1))
        nu2 = b2 * nu.to(torch.float32) + (1.0 - b2) * sq
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        denom = torch.sqrt(nu2 / c2) + eps
        geff = (mu2 / c1) / denom[..., None, None]
        mu_out = mu2.to(mu.dtype)
        nu_out = nu2.to(nu.dtype)
    else:
        raise ValueError(f"unknown base kind {base_kind!r}")
    if post_scale != 1.0:
        geff = post_scale * geff

    eta = torch.as_tensor(eta, dtype=torch.float32, device=xf.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xf.device)
    a = xf @ _bt(xf)
    b = xf @ _bt(geff)
    r = 0.5 * (a @ geff - b @ xf)
    m = xf - eta * r
    c = m @ _bt(m)
    x2 = (1.0 + lam) * m - lam * (c @ m)
    dist = _residual_norm(pogo_gram_identity_ref(c, lam), pv).to(torch.float32)
    return x2, mu_out, nu_out, dist, torch.isfinite(dist)
