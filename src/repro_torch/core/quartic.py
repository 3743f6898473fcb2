"""Closed-form, branch-free quartic root solver (Ferrari via the resolvent
cubic), batched on tensors.

Port of ``repro.core.quartic``: the Ferrari solve (``solve_cubic``,
``solve_quartic``) behind Landing's exact safe step
(``core.api._safe_eta``), and the landing polynomial of Lemma 3.1 with its
minimising lambda (``landing_poly_coeffs[_from_gram]``, ``eval_quartic``,
``optimal_lambda[_from_gram]``) behind POGO's ``find_root`` and the
feasibility watchdog's blended land. There is no data-dependent control
flow, so the solve stays on the device and never syncs with the host.
Integer powers are written as products, as XLA computes ``x ** k`` for a
Python integer ``k``.
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


def min_distance_real_root(roots: torch.Tensor) -> torch.Tensor:
    """Paper's selection: real part of the root with least |imag| (batched)."""
    idx = torch.argmin(roots.imag.abs(), dim=-1, keepdim=True)
    return torch.gather(roots, -1, idx)[..., 0].real


def _ip(x, y):
    """Real Frobenius inner product ``<x, y>`` per matrix."""
    return torch.sum((x.conj() * y).real, dim=(-2, -1))


def landing_poly_coeffs(m: torch.Tensor, pv: torch.Tensor | None = None):
    """Coefficients ``(a4, .., a0)`` of the landing polynomial
    ``P(lam) = ||C + D lam + E lam^2||^2`` at M (Lemma 3.1, exact
    expansion), with ``C = M M^H - I``, ``B = -C M``, ``D = M B^H + B M^H``,
    ``E = B B^H``. ``pv`` masks the identity of zero-padded rows."""
    from . import stiefel

    p = m.shape[-2]
    if pv is None:
        eye = torch.eye(p, dtype=m.dtype, device=m.device)
    else:
        eye = stiefel.masked_eye(p, pv, m.dtype)
    mh = m.transpose(-1, -2).conj()
    cmat = m @ mh - eye
    bmat = -(cmat @ m)
    bh = bmat.transpose(-1, -2).conj()
    dmat = m @ bh + bmat @ mh
    emat = bmat @ bh
    return (_ip(emat, emat), 2.0 * _ip(dmat, emat),
            _ip(dmat, dmat) + 2.0 * _ip(cmat, emat), 2.0 * _ip(cmat, dmat),
            _ip(cmat, cmat))


def landing_poly_coeffs_from_gram(cmat: torch.Tensor):
    """The same coefficients from ``C = M M^H - I`` alone: ``D = -2 (C^2 +
    C)`` and ``E = C^3 + C^2``, so each coefficient is a trace of a power of
    C (two (p, p) products instead of three (p, n) ones)."""
    c2 = cmat @ cmat
    c3 = c2 @ cmat
    t2 = _ip(cmat, cmat)
    t3 = _ip(cmat, c2)
    t4 = _ip(c2, c2)
    t5 = _ip(c2, c3)
    t6 = _ip(c3, c3)
    a4 = t6 + 2.0 * t5 + t4
    a3 = -4.0 * (t5 + 2.0 * t4 + t3)
    a2 = 4.0 * (t4 + 2.0 * t3 + t2) + 2.0 * (t4 + t3)
    a1 = -4.0 * (t3 + t2)
    return a4, a3, a2, a1, t2


def eval_quartic(coeffs, lam):
    a4, a3, a2, a1, a0 = coeffs
    return (((a4 * lam + a3) * lam + a2) * lam + a1) * lam + a0


def optimal_lambda(m: torch.Tensor, fallback: float = 0.5, newton_iters: int = 4,
                   pv: torch.Tensor | None = None) -> torch.Tensor:
    """``argmin_lam P(lam)`` per matrix of M: the four Ferrari roots of the
    scale-normalised polynomial and the fallback, each polished by damped
    Newton steps, the one of least ``|P|`` kept, clamped to [-0.5, 2]."""
    return _optimal_lambda_from_coeffs(
        landing_poly_coeffs(m, pv), fallback, newton_iters)


def optimal_lambda_from_gram(cmat: torch.Tensor, fallback: float = 0.5,
                             newton_iters: int = 4) -> torch.Tensor:
    """:func:`optimal_lambda` from ``C = M M^H - I`` directly."""
    return _optimal_lambda_from_coeffs(
        landing_poly_coeffs_from_gram(cmat), fallback, newton_iters)


def _optimal_lambda_from_coeffs(coeffs, fallback: float, newton_iters: int):
    a4, a3, a2, a1, a0 = coeffs
    scale = torch.maximum(
        torch.maximum(torch.maximum(a4.abs(), a3.abs()),
                      torch.maximum(a2.abs(), a1.abs())),
        torch.clamp_min(a0.abs(), 1e-30),
    )
    norm = tuple(c / scale for c in coeffs)
    roots = solve_quartic(*norm)
    real = roots.real
    fb = torch.full((*real.shape[:-1], 1), fallback, dtype=real.dtype,
                    device=real.device)
    cands = torch.cat([real, fb], dim=-1)
    cands = _where(torch.isfinite(cands), cands, torch.full_like(cands, fallback))
    n4, n3, n2, n1, n0 = (c[..., None] for c in norm)

    def p_of(lam):
        return (((n4 * lam + n3) * lam + n2) * lam + n1) * lam + n0

    def dp_of(lam):
        return ((4 * n4 * lam + 3 * n3) * lam + 2 * n2) * lam + n1

    for _ in range(newton_iters):
        dp = dp_of(cands)
        tiny = torch.where(dp >= 0, torch.full_like(dp, 1e-20),
                           torch.full_like(dp, -1e-20))
        dp = torch.where(dp.abs() < 1e-20, tiny, dp)
        cands = cands - torch.clamp(p_of(cands) / dp, -1.0, 1.0)
    cands = torch.where(torch.isfinite(cands), cands, torch.full_like(cands, fallback))
    # the unpolished fallback stays a candidate: never worse than lam = 1/2
    cands = torch.cat([cands, fb.to(cands.dtype)], dim=-1)
    idx = torch.argmin(p_of(cands).abs(), dim=-1, keepdim=True)
    lam = torch.gather(cands, -1, idx)[..., 0]
    on_manifold = a0 < 1e-18 * torch.clamp_min(scale, 1.0)
    lam = torch.where(on_manifold | ~torch.isfinite(lam),
                      torch.full_like(lam, fallback), lam)
    return torch.clamp(lam, -0.5, 2.0)
