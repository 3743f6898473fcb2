"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and what ``chip_smoke.py``
holds the kernel against on the card, and mirrors ``repro.kernels.ref``
(the JAX oracle) line for line, in fp32:

* ``fused_group_step_ref``: the kernels of ``csrc/fused_step.cu``, POGO
  and Landing branches;
* ``tp_partial_ref`` and ``tp_apply_ref``: the two kernels of
  ``csrc/tp_step.cu``; ``tp_finish_ref`` the step after the all-reduce and
  ``fused_group_step_tp_ref`` the single-device TP schedule;
* ``pogo_update_ref``: ``pogo_update_whole``/``_tiled`` of ``csrc/two_stage.cu``
  and ``pogo_update_tc`` of ``csrc/fused_step_tc.cu``;
* ``landing_field_ref``: ``landing_field``/``_tiled`` of ``csrc/two_stage.cu``
  and ``landing_field_tc`` of ``csrc/fused_step_tc.cu``;
* ``manifold_distance_ref``: the telemetry of the two-stage step;
* ``newton_schulz_ref``: both kernels of ``csrc/newton_schulz.cu`` and
  ``csrc/newton_schulz_tc.cu``;
* ``flash_attention_fwd_ref``: ``csrc/flash_attention.cu`` (fp32) and
  ``csrc/flash_attention_tc.cu`` (bf16).
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
    bias correction from ``count + 1``), then POGO's direction, leap and
    land with the distance ``||X' X'^T - I||_F`` from the land gram, or
    Landing's fixed step ``X' = X - eta (R + lam (A X - X))`` with the
    distance from the direct gram of X'. Returns ``(x_next_f32, mu', nu',
    dist, finite)`` with ``None`` for a moment the base does not have and
    ``finite = isfinite(dist)``.
    """
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
    if method == "pogo":
        m = xf - eta * r
        c = m @ _bt(m)
        x2 = (1.0 + lam) * m - lam * (c @ m)
        dist = _residual_norm(pogo_gram_identity_ref(c, lam), pv)
    elif method == "landing":
        normal = a @ xf - xf  # (A - I) X
        x2 = xf - eta * (r + lam * normal)
        dist = _residual_norm(x2 @ _bt(x2), pv)
    else:
        raise ValueError(f"unknown fused method {method!r}")
    dist = dist.to(torch.float32)
    return x2, mu_out, nu_out, dist, torch.isfinite(dist)


# ------------------------------------------------- tensor-parallel group step
#
# The TP schedule (``repro/kernels/ref.py:174-205``) splits a group's
# (B, p, n) stack over n. The step reads the matrix only through three
# (p, p) grams, A = X X^T, B = X Geff^T, S = Geff Geff^T, each a sum of
# per-shard partials: a local partial stage, ONE all-reduce of the stacked
# payload, then a column-local finish from gram algebra alone:
#   R = 1/2 (A Geff - B X) needs only the full A and B;
#   C = M M^T = A + eta^2 R R^T (tangency), with
#   R R^T = 1/4 (A S A - A B^T B^T - B B A + B A B^T);
#   Landing: X' X'^T = A - 2 eta lam (A^2 - A) + eta^2 F F^T, with
#   F F^T = R R^T + lam (R N^T + N R^T) + lam^2 (A^3 - 2 A^2 + A) and
#   R N^T = (R X^T) A - R X^T, R X^T = 1/2 (A B^T - B A).
# These differ from the single-device step's literal M M^T by float
# rounding, so the TP step is held against fused_group_step_tp_ref.


def tp_payload_width(p: int, base_kind: str) -> int:
    """Width of the all-reduced payload ``[A | B | S (| sum g^2)]``: three
    flattened (p, p) grams and, for vadam, the raw sum of squares."""
    return 3 * p * p + (1 if base_kind == "vadam" else 0)


def tp_partial_ref(x, g, *, base_kind: str = "none", hyper: tuple = (),
                   post_scale: float = 1.0, mu=None):
    """Local stage of the TP step on a shard's ``(B, p, n_local)`` columns
    (``repro/kernels/ref.py:216``): the base moments and the shard's
    payload. vadam's grams are over the UNSCALED first moment: its scalar
    needs the full ``sum g^2``, known only after the all-reduce, and
    commutes with the grams. Returns ``(payload (B, K), gbase (B, p,
    n_local), mu')``."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    mu_out = None
    if base_kind == "none":
        gbase = gf if post_scale == 1.0 else post_scale * gf
    elif base_kind == "trace":
        decay, nesterov = hyper
        mu2 = decay * mu.to(torch.float32) + gf
        gbase = decay * mu2 + gf if nesterov else mu2
        if post_scale != 1.0:
            gbase = post_scale * gbase
        mu_out = mu2.to(mu.dtype)
    elif base_kind == "vadam":
        b1 = hyper[0]
        mu2 = b1 * mu.to(torch.float32) + (1.0 - b1) * gf
        gbase = mu2
        mu_out = mu2.to(mu.dtype)
    else:
        raise ValueError(f"unknown base kind {base_kind!r}")
    bsz = x.shape[0]
    a = xf @ _bt(xf)
    b = xf @ _bt(gbase)
    s = gbase @ _bt(gbase)
    parts = [a.reshape(bsz, -1), b.reshape(bsz, -1), s.reshape(bsz, -1)]
    if base_kind == "vadam":
        parts.append(torch.sum(gf * gf, dim=(-2, -1))[:, None])
    return torch.cat(parts, dim=-1), gbase, mu_out


def tp_scale_ref(payload, p: int, *, hyper: tuple, post_scale: float, nu,
                 count):
    """vadam's deferred per-matrix scalar from the all-reduced payload:
    ``(scl (B,), nu')``, ``scl = post_scale / (c1 (sqrt(nu' / c2) + eps))``
    with the bias corrections from ``count + 1``."""
    b1, b2, eps = hyper
    t = (count + 1).to(torch.float32)
    nu2 = b2 * nu.to(torch.float32) + (1.0 - b2) * payload[:, 3 * p * p]
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    denom = torch.sqrt(nu2 / c2) + eps
    return post_scale / (c1 * denom), nu2.to(nu.dtype)


def tp_apply_ref(x, gbase, payload, eta, scl=None, *, method: str, lam,
                 pv=None):
    """The plain version of the ``tp_apply`` kernel: on the full payload,
    ``scl`` (vadam's ``(B,)`` scalar, else ``None``) scales Geff, B and S;
    then the shard's columns of POGO's or Landing's step, and the distance
    from (p, p) products alone. Returns ``(x2_f32, dist)``."""
    xf = x.to(torch.float32)
    bsz, p = x.shape[0], x.shape[-2]
    pp = p * p
    a = payload[:, :pp].reshape(bsz, p, p)
    b = payload[:, pp:2 * pp].reshape(bsz, p, p)
    s = payload[:, 2 * pp:3 * pp].reshape(bsz, p, p)
    geff = gbase
    if scl is not None:
        geff = scl[:, None, None] * gbase
        b = scl[:, None, None] * b
        s = (scl * scl)[:, None, None] * s
    eta = torch.as_tensor(eta, dtype=torch.float32, device=xf.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=xf.device)
    bt = _bt(b)
    r = 0.5 * (a @ geff - b @ xf)  # local columns of R
    rr = 0.25 * (a @ s @ a - a @ bt @ bt - b @ b @ a + b @ a @ bt)
    if method == "pogo":
        m = xf - eta * r
        c = a + (eta * eta) * rr  # C = M M^T by tangency
        x2 = (1.0 + lam) * m - lam * (c @ m)
        dist = _residual_norm(pogo_gram_identity_ref(c, lam), pv)
    elif method == "landing":
        x2 = xf - eta * (r + lam * (a @ xf - xf))
        a2 = a @ a
        rx = 0.5 * (a @ bt - b @ a)  # R X^T
        rn = rx @ a - rx  # R N^T with N = (A - I) X
        nn = a2 @ a - 2.0 * a2 + a  # N N^T = A^3 - 2 A^2 + A
        fft = rr + lam * (rn + _bt(rn)) + (lam * lam) * nn
        w = a - 2.0 * eta * lam * (a2 - a) + (eta * eta) * fft
        dist = _residual_norm(w, pv)
    else:
        raise ValueError(f"unknown fused method {method!r}")
    return x2, dist.to(torch.float32)


def tp_finish_ref(x, gbase, payload, eta, *, method: str, lam,
                  base_kind: str = "none", hyper: tuple = (),
                  post_scale: float = 1.0, nu=None, count=None, pv=None):
    """Column-local finish of the TP step after the all-reduce
    (``repro/kernels/ref.py:267``): vadam's deferred scalar, then
    :func:`tp_apply_ref`. ``dist`` depends on the replicated payload only,
    so every shard gets the same. Returns ``(x2_f32, nu', dist, finite)``."""
    scl = nu_out = None
    if base_kind == "vadam":
        scl, nu_out = tp_scale_ref(payload, x.shape[-2], hyper=hyper,
                                   post_scale=post_scale, nu=nu, count=count)
    x2, dist = tp_apply_ref(x, gbase, payload, eta, scl, method=method,
                            lam=lam, pv=pv)
    return x2, nu_out, dist, torch.isfinite(dist)


def fused_group_step_tp_ref(x, g, eta, *, method: str, lam,
                            base_kind: str = "none", hyper: tuple = (),
                            post_scale: float = 1.0, mu=None, nu=None,
                            count=None, pv=None, tp_shards: int = 1):
    """Single-device oracle of the TP step (``repro/kernels/ref.py:337``):
    ``n`` split into ``tp_shards`` contiguous chunks, the payloads
    left-folded in shard order, the finish on the full matrix
    (column-local, so the same as each shard finishing its own columns).
    Returns :func:`fused_group_step_ref`'s 5-tuple."""
    n = x.shape[-1]
    if n % tp_shards:
        raise ValueError(f"n={n} does not split into {tp_shards} shards")
    loc = n // tp_shards
    total = None
    gbs, mus = [], []
    for k in range(tp_shards):
        sl = slice(k * loc, (k + 1) * loc)
        pay, gb, mo = tp_partial_ref(
            x[..., sl], g[..., sl], base_kind=base_kind, hyper=hyper,
            post_scale=post_scale, mu=None if mu is None else mu[..., sl])
        total = pay if total is None else total + pay
        gbs.append(gb)
        mus.append(mo)
    x2, nu_out, dist, finite = tp_finish_ref(
        x, torch.cat(gbs, dim=-1), total, eta, method=method, lam=lam,
        base_kind=base_kind, hyper=hyper, post_scale=post_scale, nu=nu,
        count=count, pv=pv)
    mu_out = None if mu is None else torch.cat(mus, dim=-1)
    return x2, mu_out, nu_out, dist, finite


NEG_INF = -(2.0**30)  # the attention masks' finite sentinel (models/attention.py)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window=None):
    """Attention forward on ``(BH, S, hd)`` queries and ``(BH, Sk, hd)``
    keys and values, all in fp32, out in q's dtype
    (``repro.kernels.ref.flash_attention_fwd_ref``). Query and key
    positions count from 0. ``Sk`` is the true key length: unlike the JAX
    wrapper, nothing here pads the keys, so no padding takes softmax
    weight. Masked scores are the finite ``NEG_INF``, as in the kernel."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = (qf @ _bt(kf)) * hd**-0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None], s, NEG_INF)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)
