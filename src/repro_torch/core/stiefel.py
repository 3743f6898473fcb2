"""Stiefel-manifold primitives on tensors, batched over leading dims.

``St(p, n) = {X : X X^T = I_p}`` with ``p <= n`` (row-orthonormal wide
matrices), as in ``repro.core.stiefel``. Random draws come from a
``torch.Generator``; they cannot reproduce JAX's threefry streams, so they
are checked by property (``X X^T = I``), never elementwise.
"""

from __future__ import annotations

import torch

from .._device import resolve_device


def _ht(x: torch.Tensor) -> torch.Tensor:
    """Batched conjugate (Hermitian) transpose of the last two dims."""
    return x.transpose(-1, -2).conj()


def sym(a: torch.Tensor) -> torch.Tensor:
    """Hermitian part: ``Sym(A) = (A + A^H)/2``."""
    return 0.5 * (a + _ht(a))


def skew(a: torch.Tensor) -> torch.Tensor:
    """Skew-Hermitian part: ``Skew(A) = (A - A^H)/2``."""
    return 0.5 * (a - _ht(a))


def gram(x: torch.Tensor) -> torch.Tensor:
    """``X X^H`` — the (p, p) Gram matrix of the rows."""
    return x @ _ht(x)


def gram_residual(x: torch.Tensor) -> torch.Tensor:
    """``X X^H - I_p`` — zero exactly on St(p, n)."""
    g = gram(x)
    return g - torch.eye(x.shape[-2], dtype=g.dtype, device=g.device)


def manifold_distance(x: torch.Tensor) -> torch.Tensor:
    """Frobenius distance ``||X X^H - I||_F`` per batched matrix."""
    r = gram_residual(x)
    return torch.sqrt(torch.sum(r.abs() ** 2, dim=(-2, -1)))


def penalty_grad(x: torch.Tensor) -> torch.Tensor:
    """``grad N(X) = (X X^H - I) X`` — the normal-direction field."""
    return gram_residual(x) @ x


def riemannian_gradient(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``X Skew(X^H G) = 1/2 (X X^H G - X G^H X)`` without the (n, n)
    matrix: two (p, p) gram-type products, then two (p, p) x (p, n)."""
    a = x @ _ht(g)  # (p, p):  X G^H
    b = gram(x)  # (p, p):  X X^H
    return 0.5 * (b @ g - a @ x)


def tangent_project(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Euclidean-metric projection of an ambient direction ``v`` onto the
    tangent space at ``x``: ``P_X(V) = V - Sym(V X^H) X``."""
    return v - sym(v @ _ht(x)) @ x


def masked_eye(p: int, pv: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``I_{pv}`` embedded in a padded ``(..., p, p)`` block: rows at or
    beyond ``pv`` (valid-row counts, any leading shape) hold zero."""
    pv = torch.as_tensor(pv)
    eye = torch.eye(p, dtype=dtype, device=pv.device)
    row = torch.arange(p, device=pv.device)
    mask = row < pv[..., None]  # (..., p)
    return eye * mask[..., None].to(dtype)


def manifold_distance_masked(x: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """``||X X^H - I_{pv}||_F`` per matrix of a zero-padded ragged batch."""
    g = gram(x)
    r = g - masked_eye(x.shape[-2], pv.to(g.device), g.dtype)
    return torch.sqrt(torch.sum(r.abs() ** 2, dim=(-2, -1)))


def project_qr(x: torch.Tensor) -> torch.Tensor:
    """Project onto St(p, n) via QR of X^H (row-orthonormalize)."""
    q, r = torch.linalg.qr(_ht(x))
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    phase = d / torch.where(d.abs() == 0, torch.ones_like(d), d.abs())
    return _ht(q * phase.conj()[..., None, :])


def project_polar(x: torch.Tensor) -> torch.Tensor:
    """Polar projection ``(X X^H)^{-1/2} X``, the closest point on St, via
    the eigendecomposition of the small (p, p) Hermitian gram."""
    w, v = torch.linalg.eigh(gram(x))
    w = torch.clamp_min(w, 1e-12)
    inv_sqrt = (v * (w ** -0.5)[..., None, :].to(v.dtype)) @ _ht(v)
    return inv_sqrt.to(x.dtype) @ x


def project_newton_schulz(x: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Polar projection via Newton-Schulz (matmul only):
    ``Y <- 1.5 Y - 0.5 (Y Y^H) Y`` from ``Y = X / ||X||_F`` (the Frobenius
    prescale bounds the spectral norm by 1, so the iteration contracts).
    The plain version of the kernels in ``csrc/newton_schulz.cu`` and
    ``csrc/newton_schulz_tc.cu``."""
    fro = torch.sqrt(torch.sum(x.abs() ** 2, dim=(-2, -1), keepdim=True))
    y = x / torch.clamp_min(fro, 1e-30)
    for _ in range(iters):
        y = 1.5 * y - 0.5 * (gram(y) @ y)
    return y


def random_stiefel(
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Haar sample from St(p, n) via QR of a Gaussian; ``shape`` is
    ``(..., p, n)`` with ``p <= n``. The Gaussian is drawn on the
    generator's device and the sample lands on ``device``."""
    *batch, p, n = shape
    if p > n:
        raise ValueError(f"St(p,n) requires p <= n, got {(p, n)}")
    device = resolve_device(device)
    a = torch.randn((*batch, n, p), generator=generator, dtype=dtype,
                    device=generator.device).to(device)
    q, r = torch.linalg.qr(a)  # q: (..., n, p) column-orthonormal
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    phase = d / torch.where(d.abs() == 0, torch.ones_like(d), d.abs())
    q = q * phase.conj()[..., None, :]
    return q.transpose(-1, -2).conj().contiguous()


def random_stiefel_stacked(
    generators: list[torch.Generator],
    shape: tuple[int, ...],
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """One independent Haar draw per stacked matrix: ``shape`` is
    ``(B, p, n)`` and ``generators`` holds ``B`` generators, so the sample
    a matrix sees does not depend on how the batch was assembled."""
    b = shape[0]
    if len(generators) != b:
        raise ValueError(f"{len(generators)} generators for a batch of {b}")
    return torch.stack(
        [random_stiefel(gen, shape[1:], dtype, device) for gen in generators]
    )
