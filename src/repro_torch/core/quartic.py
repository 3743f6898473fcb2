"""Closed-form, branch-free quartic root solver (Ferrari via the resolvent
cubic), batched on tensors.

Port of the part of ``repro.core.quartic`` that Landing's exact safe step
(``core.api._safe_eta``) needs: ``_cbrt``, ``solve_cubic`` and
``solve_quartic``. Everything is complex arithmetic with no
data-dependent control flow, so the solve stays on the device and never
syncs with the host. Integer powers are written as products, as XLA
computes ``x ** k`` for a Python integer ``k``.
"""

from __future__ import annotations

import torch

_CBRT_UNITY = (
    1.0 + 0.0j,
    -0.5 + 0.8660254037844386j,
    -0.5 - 0.8660254037844386j,
)


def _cbrt(z: torch.Tensor) -> torch.Tensor:
    """Principal complex cube root (branch-free)."""
    r = z.abs()
    theta = torch.angle(z)
    return (r ** (1.0 / 3.0)) * torch.exp(1j * theta / 3.0)


def _where(cond, a, b):
    """``torch.where`` with Python-number branches cast to ``b``'s type."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return torch.where(cond, a, b)


def solve_cubic(a, b, c, d) -> torch.Tensor:
    """All three roots of ``a x^3 + b x^2 + c x + d`` (complex, batched).

    Returns shape ``(..., 3)``. ``a`` must be nonzero (guarded by caller).
    """
    cdt = torch.complex128 if a.dtype == torch.complex128 else torch.complex64
    a, b, c, d = (t.to(cdt) for t in (a, b, c, d))
    # Depressed cubic t^3 + p t + q with x = t - b/(3a)
    p = (3 * a * c - b * b) / (3 * a * a)
    q = (2 * (b * b * b) - 9 * a * b * c + 27 * a * a * d) / (27 * (a * a * a))
    q2, p3 = q / 2, p / 3
    disc = q2 * q2 + p3 * p3 * p3
    sq = torch.sqrt(disc)
    # Choose the Cardano branch further from cancellation.
    u3_plus = -q / 2 + sq
    u3_minus = -q / 2 - sq
    u3 = torch.where(u3_plus.abs() >= u3_minus.abs(), u3_plus, u3_minus)
    u = _cbrt(u3)
    # Guard u == 0 (triple root at 0): then t = 0 for all roots.
    zero_u = u.abs() < 1e-30
    safe_u = _where(zero_u, 1.0, u)
    roots = []
    for w in _CBRT_UNITY:
        uw = safe_u * w
        t = uw - p / (3 * uw)
        t = _where(zero_u, 0.0, t)
        roots.append(t - b / (3 * a))
    return torch.stack(roots, dim=-1)


def solve_quartic(a, b, c, d, e) -> torch.Tensor:
    """All four roots of ``a x^4 + b x^3 + c x^2 + d x + e`` (batched).

    Ferrari's method through the resolvent cubic; returns shape
    ``(..., 4)`` complex roots. ``a`` is clamped away from zero, as in the
    JAX package.
    """
    cdt = torch.complex128 if a.dtype == torch.float64 else torch.complex64
    a, b, c, d, e = (torch.as_tensor(t).to(cdt) for t in (a, b, c, d, e))
    a = _where(a.abs() < 1e-30, 1e-30 + 0j, a)
    # Normalize: x^4 + B x^3 + C x^2 + D x + E
    B, C, D, E = b / a, c / a, d / a, e / a
    B2 = B * B
    # Depressed quartic y^4 + p y^2 + q y + r with x = y - B/4
    p = C - 3 * B2 / 8
    q = D - B * C / 2 + B2 * B / 8
    r = E - B * D / 4 + B2 * C / 16 - 3 * (B2 * B2) / 256
    # Resolvent cubic: 8 m^3 + 8 p m^2 + (2 p^2 - 8 r) m - q^2 = 0
    ones = torch.ones_like(p)
    m_roots = solve_cubic(8 * ones, 8 * p, 2 * p * p - 8 * r, -q * q)
    # Pick the root with the largest magnitude (avoids sqrt of ~0).
    idx = torch.argmax(m_roots.abs(), dim=-1, keepdim=True)
    m = torch.gather(m_roots, -1, idx)[..., 0]
    sqrt_2m = torch.sqrt(2 * m)
    safe_sqrt_2m = _where(sqrt_2m.abs() < 1e-30, 1e-30 + 0j, sqrt_2m)
    # Biquadratic fallback when q ~ 0: y^4 + p y^2 + r = 0
    is_biquad = q.abs() < 1e-12 * (1 + p.abs() + r.abs())
    # Ferrari quadratics: y^2 + sgn sqrt(2m) y + (p/2 + m - sgn q/(2 sqrt(2m)))
    t1 = p / 2 + m
    t2 = q / (2 * safe_sqrt_2m)
    roots = []
    for sgn_lin in (+1.0, -1.0):
        bb = sgn_lin * sqrt_2m
        cc = t1 - sgn_lin * t2
        disc = torch.sqrt(bb * bb - 4 * cc)
        roots.append((-bb + disc) / 2)
        roots.append((-bb - disc) / 2)
    y = torch.stack(roots, dim=-1)
    disc_b = torch.sqrt(p * p - 4 * r)
    z1 = torch.sqrt((-p + disc_b) / 2)
    z2 = torch.sqrt((-p - disc_b) / 2)
    y_biquad = torch.stack([z1, -z1, z2, -z2], dim=-1)
    y = torch.where(is_biquad[..., None], y_biquad, y)
    return y - (B / 4)[..., None]
