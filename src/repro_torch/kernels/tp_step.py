"""Wrappers of the tensor-parallel group-step kernels (``csrc/tp_step.cu``).

``tp_gram`` replaces ``repro/kernels/fused_step.py:304`` (``tp_gram_whole``,
body ``_tp_gram_kernel`` :266): on a rank's ``(B, p, n_local)`` columns,
the base moments, the gram operand ``gb`` and the rank's payload row
``[A | B | S (| sum g^2)]``. ``tp_apply`` replaces
``repro/kernels/fused_step.py:417`` (``tp_apply_whole``, body
``_tp_apply_kernel`` :360): after the all-reduce, POGO's or Landing's step
on the rank's columns and the distance from the replicated grams. Both run
one CTA per matrix swept over n tiles, IEEE fp32 on the CUDA cores.
``tp_gram_tc`` and ``tp_apply_tc`` (``csrc/tp_step_tc.cu``) compute the
same on the tensor cores (3xTF32 ``wgmma`` fed by a TMA ring, one
persistent CTA per SM; ``tp_apply_tc`` first forms the (p, p) algebra in a
launch of its own) for p <= 64 at n % 4 == 0; ``ops.plan_tp_route``
chooses between the two.

On a CPU tensor each wrapper runs its plain version (``ref.tp_partial_ref``,
``ref.tp_apply_ref``); on a CUDA tensor it checks device, dtype, shape and
contiguity, launches on the current stream and raises if the launch fails.
There is no fallback. ``inplace=True`` writes mu' over ``mu``
(``tp_gram``) or X' over ``x`` (``tp_apply``). Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .fused_step import check_operand, pack_scal

_BASE_KINDS = {"none": 0, "trace": 1, "vadam": 2}
_METHODS = {"pogo": 0, "landing": 1}
TC_P = 64  # the tensor-core kernels' rows: one 64-row wgmma tile
_P = ctypes.c_void_p
_I = ctypes.c_int


def lib() -> ctypes.CDLL:
    lib_ = build.load("tp_step")
    if not getattr(lib_, "_typed", False):
        lib_.tp_gram.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        lib_.tp_apply.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib_.tp_gram_smem_bytes.argtypes = [_I, _I]
        lib_.tp_apply_smem_bytes.argtypes = [_I, _I]
        for fn in (lib_.tp_gram, lib_.tp_apply, lib_.tp_gram_smem_bytes,
                   lib_.tp_apply_smem_bytes):
            fn.restype = _I
        lib_._typed = True
    return lib_


def tc_lib() -> ctypes.CDLL:
    """The loaded ``tp_step_tc.cu`` library, built on first use."""
    lib_ = build.load("tp_step_tc")
    if not getattr(lib_, "_typed", False):
        lib_.tp_gram_tc.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        lib_.tp_apply_tc.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib_.tp_alg_blocks_per_sm.argtypes = [_I]
        for fn in (lib_.tp_gram_tc, lib_.tp_apply_tc, lib_.tp_gram_tc_smem_bytes,
                   lib_.tp_apply_tc_smem_bytes, lib_.tp_alg_smem_bytes,
                   lib_.tp_alg_blocks_per_sm):
            fn.restype = _I
        lib_._typed = True
    return lib_


def tp_scal(base_kind, hyper, post_scale, eta=0.0, lam=0.0, device="cpu"):
    """The kernels' fp32 scalar vector ``[eta, lam, post_scale, h0, 0 ...]``
    (``repro/kernels/ops.py:483 _tp_scal``): ``h0`` is trace's decay or
    vadam's b1, packed as ``fused_step.pack_scal`` packs trace's decay."""
    if base_kind in ("trace", "vadam"):
        return pack_scal(eta, lam, base_kind="trace", hyper=(hyper[0], False),
                         post_scale=post_scale, count=None, device=device)
    return pack_scal(eta, lam, base_kind="none", hyper=(), post_scale=post_scale,
                     count=None, device=device)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check(err, what, shape):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed for (B, p, n) = {shape}: "
                           f"cudaError {err}")


def _check_tc(p, n, tensors):
    """The tensor-core kernels' shapes: p <= 64, TMA's row stride (n % 4 ==
    0) and 16-byte aligned rows."""
    if p > TC_P or n % 4 or any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError(f"the tensor-core TP kernels take p <= {TC_P} at n % 4 == 0 "
                         f"with 16-byte aligned operands, got (p, n) = ({p}, {n})")


def _gram(x, g, base_kind, hyper, post_scale, mu, inplace, tile_n):
    """The checks, outputs and launch of ``tp_gram`` (``tile_n``) or
    ``tp_gram_tc`` (``tile_n`` None) on a CUDA stack; the plain version on
    a CPU one."""
    if x.device.type == "cpu":
        payload, gb, mu2 = ref.tp_partial_ref(x, g, base_kind=base_kind,
                                              hyper=hyper, post_scale=post_scale,
                                              mu=mu)
        if inplace and mu2 is not None:
            mu2 = mu.copy_(mu2)
        return payload, gb, mu2
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if base_kind not in _BASE_KINDS:
        raise ValueError(f"unknown base kind {base_kind!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be a (B, p, n) stack, got {tuple(x.shape)}")
    dev = x.device
    bsz, p, n = x.shape
    check_operand("x", x, (bsz, p, n), torch.float32, dev)
    check_operand("g", g, (bsz, p, n), torch.float32, dev)
    has_mu = base_kind != "none"
    if has_mu:
        check_operand("mu", mu, (bsz, p, n), torch.float32, dev)
    nesterov = bool(hyper[1]) if base_kind == "trace" else False
    scal = tp_scal(base_kind, hyper, post_scale, device=dev)
    payload = torch.empty((bsz, ref.tp_payload_width(p, base_kind)),
                          dtype=torch.float32, device=dev)
    gb = torch.empty_like(x)
    mu_out = (mu if inplace else torch.empty_like(mu)) if has_mu else None
    if tile_n is None:
        _check_tc(p, n, (x, g, mu if has_mu else None, gb, mu_out))
    args = (_ptr(x), _ptr(g), _ptr(mu) if has_mu else None, _ptr(scal), _ptr(payload),
            _ptr(gb), _ptr(mu_out), bsz, p, n, _BASE_KINDS[base_kind], int(nesterov))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tile_n is None:
            err = tc_lib().tp_gram_tc(*args, stream)
        else:
            err = lib().tp_gram(*args, int(tile_n), stream)
    _check(err, "tp_gram" if tile_n else "tp_gram_tc", (bsz, p, n))
    return payload, gb, mu_out


def tp_gram(x, g, *, base_kind="none", hyper=(), post_scale=1.0, mu=None,
            inplace=False, tile_n=64):
    """Local stage of the TP step: returns ``(payload (B, K), gb, mu')``."""
    out = _gram(x, g, base_kind, hyper, post_scale, mu, inplace, tile_n)
    if x.device.type == "cuda":
        tp_gram.launches += 1
    return out


def tp_gram_tc(x, g, *, base_kind="none", hyper=(), post_scale=1.0, mu=None,
               inplace=False):
    """:func:`tp_gram` on the tensor cores (p <= 64, n % 4 == 0)."""
    out = _gram(x, g, base_kind, hyper, post_scale, mu, inplace, None)
    if x.device.type == "cuda":
        tp_gram_tc.launches += 1
    return out


def _apply(x, gb, payload, eta, scl, method, lam, pv, inplace, tile_n):
    """The checks, outputs and launch of ``tp_apply`` (``tile_n``) or
    ``tp_apply_tc`` (``tile_n`` None; the scratch of its sweep's (p, p)
    operators allocated here) on a CUDA stack; the plain version on a CPU
    one."""
    if x.device.type == "cpu":
        x2, dist = ref.tp_apply_ref(x, gb, payload, eta, scl, method=method,
                                    lam=lam, pv=pv)
        return (x.copy_(x2) if inplace else x2), dist
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if method not in _METHODS:
        raise ValueError(f"unknown fused method {method!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be a (B, p, n) stack, got {tuple(x.shape)}")
    dev = x.device
    bsz, p, n = x.shape
    check_operand("x", x, (bsz, p, n), torch.float32, dev)
    check_operand("gb", gb, (bsz, p, n), torch.float32, dev)
    if payload.dim() != 2 or payload.shape[1] < 3 * p * p:
        raise ValueError(f"payload must be (B, K >= 3 p^2), got {tuple(payload.shape)}")
    check_operand("payload", payload, (bsz, payload.shape[1]), torch.float32, dev)
    if scl is not None:
        check_operand("scl", scl, (bsz,), torch.float32, dev)
    if pv is not None:
        check_operand("pv", pv, (bsz,), torch.int32, dev)
    scal = tp_scal("none", (), 1.0, eta=eta, lam=lam, device=dev)
    x_out = x if inplace else torch.empty_like(x)
    dist = torch.empty((bsz,), dtype=torch.float32, device=dev)
    args = (_ptr(x), _ptr(gb), _ptr(payload), _ptr(scl), _ptr(scal), _ptr(pv),
            _ptr(x_out), _ptr(dist))
    dims = (bsz, p, n, payload.shape[1], _METHODS[method])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tile_n is None:
            _check_tc(p, n, (x, gb, x_out))
            ops = torch.empty((bsz, 2, p, p), dtype=torch.float32, device=dev)
            err = tc_lib().tp_apply_tc(*args, _ptr(ops), *dims, stream)
        else:
            err = lib().tp_apply(*args, *dims, int(tile_n), stream)
    _check(err, "tp_apply" if tile_n else "tp_apply_tc", (bsz, p, n))
    return x_out, dist


def tp_apply(x, gb, payload, eta, scl=None, *, method, lam, pv=None,
             inplace=False, tile_n=32):
    """Finish of the TP step on the full payload: returns ``(x', dist)``.
    ``scl`` is vadam's ``(B,)`` scalar (``ref.tp_scale_ref``), else None."""
    out = _apply(x, gb, payload, eta, scl, method, lam, pv, inplace, tile_n)
    if x.device.type == "cuda":
        tp_apply.launches += 1
    return out


def tp_apply_tc(x, gb, payload, eta, scl=None, *, method, lam, pv=None, inplace=False):
    """:func:`tp_apply` on the tensor cores (p <= 64, n % 4 == 0): the
    (p, p) algebra (a launch over the matrices), then the sweep."""
    out = _apply(x, gb, payload, eta, scl, method, lam, pv, inplace, None)
    if x.device.type == "cuda":
        tp_apply_tc.launches += 1
    return out


tp_gram.launches = 0
tp_apply.launches = 0
tp_gram_tc.launches = 0
tp_apply_tc.launches = 0
