"""Wrappers of the fused group-step kernels (``csrc/fused_step.cu``).

``fused_step_whole`` replaces ``repro/kernels/fused_step.py:175``
(``_fused_whole_kernel``): one CTA per matrix with X and the transformed
gradient resident in shared memory. ``fused_step_tiled`` replaces
``repro/kernels/fused_step.py:608`` (``_t1_kernel``, ``_t2_pogo_kernel``,
``pogo_update._phase3_kernel`` and the telemetry products left to XLA): one
CTA per matrix sweeping n-tiles three times, with the (p, p) grams in
shared memory. Both are IEEE fp32 on the CUDA cores. ``method="landing"``
launches their Landing branches, ``fused_step_whole_landing`` (the
Landing branch of ``_fused_whole_kernel``, :164-168) and
``fused_step_tiled_landing`` (``_t1_kernel`` + ``_t2_landing_kernel``,
:559): the fixed step ``X' = X - eta (R + lam (A X - X))`` and the
distance from the direct gram of X', the tiled one in two sweeps.

``fused_step_tiled_tc`` (``csrc/fused_step_tc.cu``) replaces the same TPU
kernels as ``fused_step_tiled`` on the tensor cores for p <= 64: 3xTF32
``wgmma`` products fed by a TMA ring, one persistent CTA per SM;
``fused_step_tiled_tc_landing`` is its Landing branch (the TPU kernel's
``_t2_landing_kernel``, :559). ``fused_step_tiled_tc128`` and
``fused_step_tiled_tc128_landing`` are the same source's wide kernel for
64 < p <= 128 (internlm2-1.8b's q/k): two consumer warpgroups, the (p, p)
operands in 64-row halves, M's rows 0..63 parked in a scratch of the
wrapper's. ``fused_step_tiled_tc`` hands p > 64 to them.
``fused_step_cluster`` (``csrc/small_p.cu``) replaces ``fused_step_tiled``'s
TPU kernels up to p = 24: one matrix a thread block cluster, X and Geu
TMA-loaded once into the CTAs' shared memory, the partial grams summed
over distributed shared memory, 5 HBM passes (IEEE fp32 on the CUDA cores;
n % 4 == 0); ``fused_step_cluster_landing`` is its Landing entry (the TPU
kernel's ``_t2_landing_kernel``, :559). ``ops.plan`` says which shapes
take which.
``fused_step_large`` and ``fused_step_large_landing`` (``csrc/large_p.cu``,
``large_p.py``) replace
``fused_step_tiled``'s TPU kernels for p > 128, where a matrix's (p, p)
grams outgrow a block: the TPU kernel's phases as gram-then-apply launches,
the grams between them in HBM and L2, IEEE fp32 on the CUDA cores; they
run where n % 4 != 0. ``fused_step_large_tc`` and
``fused_step_large_tc_landing`` are the same phases on the tensor cores
(3xTF32 ``wgmma`` fed by TMA, ``large_p.fused_tc``), the route for p > 128
at n % 4 == 0.
``fused_step_batched`` (``csrc/batched_whole.cu``) replaces the same TPU
kernel as ``fused_step_whole`` for stacks of many small matrices (the
planner's ``"batched"``, p <= n <= 4): a thread a matrix, persistent CTAs
walking groups of consecutive matrices fed by 1-D bulk async copies into a
ring of stages (IEEE fp32 on the CUDA cores); ``fused_step_batched_landing``
is its Landing branch.

The wrappers take the arguments of ``ref.fused_group_step_ref`` and return
its ``(x', mu', nu', dist, finite)``. On a CPU tensor they run that plain
version; on a CUDA tensor they check device, dtype, shape and contiguity,
launch on the current stream, and raise if the launch fails. There is no
fallback. ``inplace=True`` writes X' over ``x``, mu' over ``mu`` and nu'
over ``nu`` (safe: each CTA owns its matrix and never re-reads an element
it has overwritten). Each wrapper counts its launches in ``.launches``,
the Landing branches in their own.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build, large_p, ref

_BASE_KINDS = {"none": 0, "trace": 1, "vadam": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_step")
    if not getattr(lib, "_typed", False):
        common = [_P] * 10 + [_I] * 6
        lib.fused_step_whole.argtypes = common + [_P]
        lib.fused_step_tiled.argtypes = common + [_I, _P]
        lib.fused_whole_smem_bytes.argtypes = [_I, _I]
        lib.fused_tiled_smem_bytes.argtypes = [_I, _I]
        for fn in (lib.fused_step_whole, lib.fused_step_tiled,
                   lib.fused_whole_smem_bytes, lib.fused_tiled_smem_bytes):
            fn.restype = _I
        lib._typed = True
    return lib


def tc_lib() -> ctypes.CDLL:
    """The loaded ``fused_step_tc.cu`` library, built on first use."""
    lib = build.load("fused_step_tc")
    if not getattr(lib, "_typed", False):
        lib.fused_step_tc.argtypes = [_P] * 10 + [_I] * 6 + [_P, _P]
        # the two-stage entries; the last pointer but the stream is the
        # wide kernel's park
        lib.pogo_update_tc.argtypes = [_P] * 4 + [_I] * 3 + [_P, _P]
        lib.landing_field_tc.argtypes = [_P] * 4 + [_I] * 3 + [_P, _P]
        lib.fused_tc_smem_bytes.argtypes = [_I]
        lib.fused_tc_park_floats.argtypes = [_I]
        lib.tf32_probe.argtypes = [_P] * 3 + [_I, _P]
        for fn in (lib.fused_step_tc, lib.pogo_update_tc, lib.landing_field_tc,
                   lib.fused_tc_smem_bytes, lib.fused_tc_park_floats, lib.tf32_probe):
            fn.restype = _I
        lib._typed = True
    return lib


def batched_lib() -> ctypes.CDLL:
    """The loaded ``batched_whole.cu`` library (the fused step, POGO and
    Landing, and the two-stage POGO update over many matrices), built on
    first use."""
    lib = build.load("batched_whole")
    if not getattr(lib, "_typed", False):
        lib.fused_step_batched.argtypes = [_P] * 10 + [_I] * 6 + [_P]
        lib.pogo_update_batched.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        for fn in (lib.fused_step_batched, lib.pogo_update_batched):
            fn.restype = _I
        lib._typed = True
    return lib


def cluster_lib() -> ctypes.CDLL:
    """The loaded ``small_p.cu`` library (the cluster kernel's entries: the
    fused step, POGO and Landing, and the two-stage POGO update and landing
    field; and Newton-Schulz's cluster kernel), built on first use."""
    lib = build.load("small_p")
    if not getattr(lib, "_typed", False):
        lib.fused_step_cluster.argtypes = [_P] * 10 + [_I] * 7 + [_P]
        lib.pogo_update_cluster.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.landing_field_cluster.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.small_p_cluster.argtypes = [_I, _I]
        lib.small_p_smem_bytes.argtypes = [_I] * 3
        lib.newton_schulz_cluster.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.newton_schulz_cluster_c.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.ns_cluster.argtypes = [_I, _I]
        lib.ns_cluster_smem_bytes.argtypes = [_I] * 3
        lib.ns_cluster_max_clusters.argtypes = [_I] * 3
        for fn in (lib.fused_step_cluster, lib.pogo_update_cluster, lib.landing_field_cluster,
                   lib.small_p_cluster, lib.small_p_smem_bytes, lib.newton_schulz_cluster,
                   lib.newton_schulz_cluster_c, lib.ns_cluster, lib.ns_cluster_smem_bytes,
                   lib.ns_cluster_max_clusters):
            fn.restype = _I
        lib._typed = True
    return lib


# The tensor-core kernel for p <= TC_P; the wide kernel up to TC_WIDE_P.
TC_P = 64
TC_WIDE_P = 128
# Floats a block keeps past its parked rows (``kWKeep``): 80 a consumer
# thread, its blocks of A and B for the second output half and its
# columns of C00.
PARK_KEEP = 80 * 256


def park_floats(n: int) -> int:
    """The wide kernel's park a block (``fused_tc_park_floats``)."""
    return 64 * n + PARK_KEEP


def park(x, *, rows: bool = True) -> torch.Tensor:
    """The wide kernel's scratch, where each block parks rows 0..63 of M
    (or of Landing's X') of the matrix it is on, and keeps the sums it
    needs again later (``PARK_KEEP``): ``(min(B, SMs), park_floats(n))``
    fp32 on x's card; ``rows=False`` (the landing field, which parks no
    rows) the kept sums alone, ``(min(B, SMs), PARK_KEEP)``."""
    bsz, _, n = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return torch.empty((min(bsz, sms), park_floats(n) if rows else PARK_KEEP),
                       dtype=torch.float32, device=x.device)


def tf32_probe(a, b, *, a_regs: bool):
    """``a (64, 8) @ b (64, 8)^T`` through one TF32 ``wgmma`` on the card,
    ``a`` from shared memory or (``a_regs``) registers, the fp32 inputs as
    they are: what it returns shows how the tensor cores treat an
    operand's low 13 bits and round their sums, and whether the register
    fragment layout of ``csrc/hopper.cuh`` holds."""
    for name, t in (("a", a), ("b", b)):
        check_operand(name, t, (64, 8), torch.float32, a.device)
    if a.device.type != "cuda":
        raise ValueError("the TF32 probe runs on the card only")
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = tc_lib().tf32_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(), int(a_regs),
                                  torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32 probe launch failed: cudaError {err}")
    return d


def pack_scal(eta, lam, *, base_kind, hyper, post_scale, count, device):
    """The kernels' fp32 scalar vector ``[eta, lam, post_scale, h0..h4]``,
    packed as ``repro/kernels/ops.py:361-371`` packs it: ``h0 = decay``
    for trace, ``(b1, b2, eps, c1, c2)`` for vadam with the bias
    corrections from ``count + 1``. Python numbers travel in one
    non-blocking copy; a tensor ``eta`` and the vadam corrections are
    filled in on the device, so packing never waits for the card."""
    h = [0.0] * 5
    if base_kind == "trace":
        h[0] = float(hyper[0])
    elif base_kind == "vadam":
        h[:3] = [float(v) for v in hyper]
    eta_host = float(eta) if isinstance(eta, (int, float)) else 0.0
    host = torch.tensor([eta_host, float(lam), float(post_scale), *h],
                        dtype=torch.float32)
    scal = host.to(device, non_blocking=True)
    if not isinstance(eta, (int, float)):
        scal[0:1].copy_(torch.as_tensor(eta, dtype=torch.float32).reshape(1))
    if base_kind == "vadam":
        t = (count + 1).to(device=device, dtype=torch.float32)
        scal[6:8] = 1.0 - torch.pow(scal[3:5], t)
    return scal


def check_operand(name, t, shape, dtype, device):
    if t is None:
        raise ValueError(f"{name} is required for this base kind")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_plain(x, g, eta, *, inplace=False, **kw):
    """The plain version on any device, with the wrappers' ``inplace``."""
    out = ref.fused_group_step_ref(x, g, eta, **kw)
    if not inplace:
        return out
    x2, mu2, nu2, dist, finite = out
    x.copy_(x2)
    if mu2 is not None:
        kw["mu"].copy_(mu2)
    if nu2 is not None:
        kw["nu"].copy_(nu2)
    return x, kw["mu"] if mu2 is not None else None, \
        kw["nu"] if nu2 is not None else None, dist, finite


_METHODS = {"pogo": 0, "landing": 1}


def _check_operands(x, g, *, method, base_kind, mu, nu, count, pv):
    """The fused kernels' operand checks; returns x's ``(B, p, n)``."""
    if method not in _METHODS:
        raise ValueError(f"unknown fused method {method!r}")
    if base_kind not in _BASE_KINDS:
        raise ValueError(f"unknown base kind {base_kind!r}")
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be a (B, p, n) stack, got {tuple(x.shape)}")
    bsz, p, n = x.shape
    check_operand("x", x, (bsz, p, n), torch.float32, dev)
    check_operand("g", g, (bsz, p, n), torch.float32, dev)
    if base_kind != "none":
        check_operand("mu", mu, (bsz, p, n), torch.float32, dev)
    if base_kind == "vadam":
        check_operand("nu", nu, (bsz,), torch.float32, dev)
        if count is None:
            raise ValueError("count is required for the vadam base")
    if pv is not None:
        check_operand("pv", pv, (bsz,), torch.int32, dev)
    return bsz, p, n


def _launch(entry, x, g, eta, *, method, lam, base_kind, hyper, post_scale,
            mu, nu, count, pv, inplace, extra=()):
    bsz, p, n = _check_operands(x, g, method=method, base_kind=base_kind, mu=mu,
                                nu=nu, count=count, pv=pv)
    dev = x.device
    nesterov = bool(hyper[1]) if base_kind == "trace" else False
    scal = pack_scal(eta, lam, base_kind=base_kind, hyper=hyper,
                     post_scale=post_scale, count=count, device=dev)
    has_mu = base_kind != "none"
    has_nu = base_kind == "vadam"
    if inplace:
        x_out, mu_out, nu_out = x, mu, nu
    else:
        x_out = torch.empty_like(x)
        mu_out = torch.empty_like(mu) if has_mu else None
        nu_out = torch.empty_like(nu) if has_nu else None
    dist = torch.empty((bsz,), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            ptr(x), ptr(g), ptr(mu) if has_mu else None,
            ptr(nu) if has_nu else None, ptr(scal), ptr(pv), ptr(x_out),
            ptr(mu_out), ptr(nu_out), ptr(dist),
            bsz, p, n, _BASE_KINDS[base_kind], int(nesterov),
            _METHODS[method], *extra, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused step kernel launch failed for (B, p, n) = {(bsz, p, n)}: "
            f"cudaError {err}"
        )
    return x_out, mu_out, nu_out, dist, torch.isfinite(dist)


def _run(name, x, g, eta, *, inplace, extra=(), lib=_lib, counter=None, **kw):
    """The plain version on a CPU tensor; else launch ``name``'s entry and
    count it on the wrapper of the kernel that ran (``counter``'s, else
    ``name``'s)."""
    if x.device.type == "cpu":
        return run_plain(x, g, eta, inplace=inplace, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = _launch(getattr(lib(), name), x, g, eta, inplace=inplace,
                  extra=extra, **kw)
    _COUNTERS[counter or name, kw["method"]].launches += 1
    return out


def fused_step_whole(x, g, eta, *, method="pogo", lam, base_kind="none",
                     hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                     pv=None, inplace=False):
    """Whole-matrix fused step: one CTA per ``(p, n)`` matrix, X and the
    transformed gradient in shared memory (``ops.whole_smem_bytes``);
    ``method="landing"`` runs ``fused_step_whole_landing``."""
    return _run("fused_step_whole", x, g, eta, method=method, lam=lam,
                base_kind=base_kind, hyper=hyper, post_scale=post_scale, mu=mu,
                nu=nu, count=count, pv=pv, inplace=inplace)


def fused_step_batched(x, g, eta, *, method="pogo", lam, base_kind="none",
                       hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                       pv=None, inplace=False):
    """The whole-matrix fused step over many matrices of p <= n <= 4
    (``csrc/batched_whole.cu``): a thread a matrix, persistent CTAs walking
    groups of consecutive matrices fed by 1-D bulk copies through a ring of
    stages; ``method="landing"`` runs ``fused_step_batched_landing``."""
    return _run("fused_step_batched", x, g, eta, lib=batched_lib, method=method, lam=lam,
                base_kind=base_kind, hyper=hyper, post_scale=post_scale, mu=mu, nu=nu,
                count=count, pv=pv, inplace=inplace)


def fused_step_tiled(x, g, eta, *, method="pogo", lam, base_kind="none",
                     hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                     pv=None, inplace=False, tile_n=64):
    """Tiled fused step: one CTA per matrix sweeping ``tile_n``-wide column
    tiles (moments + A, Bp; then M + C; then X'), grams in shared memory
    (``ops.tiled_smem_bytes``); ``method="landing"`` runs
    ``fused_step_tiled_landing`` (moments + A, Bp; then X' + W)."""
    return _run("fused_step_tiled", x, g, eta, method=method, lam=lam,
                base_kind=base_kind, hyper=hyper, post_scale=post_scale, mu=mu,
                nu=nu, count=count, pv=pv, inplace=inplace,
                extra=(int(tile_n),))


def fused_step_tiled_tc(x, g, eta, *, method="pogo", lam, base_kind="none",
                        hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                        pv=None, inplace=False):
    """Tensor-core fused step for ``p <= 64``: one persistent CTA per SM
    walking the matrices, 64-column chunks in three sweeps (moments + A, Bp;
    M + C; X') through 3xTF32 ``wgmma`` on TMA-fed tiles
    (``ops.tc_smem_bytes``); ``method="landing"`` runs
    ``fused_step_tiled_tc_landing`` (moments + A, Bp; then X' + W). A CUDA
    stack with p > 64 goes to :func:`fused_step_tiled_tc128`."""
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=hyper,
              post_scale=post_scale, mu=mu, nu=nu, count=count, pv=pv, inplace=inplace)
    if x.device.type == "cuda" and x.dim() == 3 and x.shape[1] > TC_P:
        return fused_step_tiled_tc128(x, g, eta, **kw)
    return _run("fused_step_tc", x, g, eta, lib=tc_lib, extra=(None,), **kw)


def fused_step_tiled_tc128(x, g, eta, *, method="pogo", lam, base_kind="none",
                           hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                           pv=None, inplace=False):
    """The wide tensor-core fused step, ``64 < p <= 128``: two consumer
    warpgroups, 32-column chunks in sweep 1 (moments + A, Bp), sweep 2 once
    per 64-row half of M (M + C), then X', with M's rows 0..63 parked in
    :func:`park` (``ops.tc_smem_bytes``); ``method="landing"`` runs
    ``fused_step_tiled_tc128_landing`` (its X' + W in the two halves)."""
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=hyper,
              post_scale=post_scale, mu=mu, nu=nu, count=count, pv=pv, inplace=inplace)
    if x.device.type != "cuda":
        return _run("fused_step_tc", x, g, eta, lib=tc_lib, **kw)
    if x.dim() == 3 and x.shape[1] <= TC_P:
        raise ValueError(f"the wide kernel takes {TC_P} < p <= {TC_WIDE_P}, got p="
                         f"{x.shape[1]}: fused_step_tiled_tc runs it")
    scratch = park(x) if x.dim() == 3 else None
    return _run("fused_step_tc", x, g, eta, lib=tc_lib, counter="fused_step_tc128",
                extra=(None if scratch is None else scratch.data_ptr(),), **kw)


def fused_step_cluster(x, g, eta, *, method="pogo", lam, base_kind="none",
                       hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                       pv=None, inplace=False, cluster=None):
    """The fused step for small p with one matrix a thread block cluster
    (``csrc/small_p.cu``): the cluster's CTAs hold X and Geu whole in
    shared memory, TMA-loaded once, their partial grams summed over
    distributed shared memory, so X, g and mu are read once and X', mu'
    written once. ``cluster`` forces the cluster size (2, 4 or 8); by
    default the source's own (``ops.small_p_cluster``).
    ``method="landing"`` runs ``fused_step_cluster_landing`` (X' written
    over X in shared memory too, then W = X' X'^T for the distance)."""
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=hyper,
              post_scale=post_scale, mu=mu, nu=nu, count=count, pv=pv, inplace=inplace)
    return _run("fused_step_cluster", x, g, eta, lib=cluster_lib, extra=(int(cluster or 0),),
                **kw)


def fused_step_large(x, g, eta, *, method="pogo", lam, base_kind="none",
                     hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                     pv=None, inplace=False, runner=None):
    """The fused step for p > 128, where one matrix's (p, p) grams do not
    fit a block: the TPU tiled kernel's phases as gram-then-apply launches
    of ``csrc/large_p.cu`` through HBM and L2 (``large_p.fused``);
    ``method="landing"`` runs ``fused_step_large_landing``. ``runner``
    (a ``large_p.Runner``) launches elsewhere than on x's card: the CPU
    tests' emulated build."""
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=hyper,
              post_scale=post_scale, mu=mu, nu=nu, count=count, pv=pv)
    if runner is None and x.device.type == "cpu":
        return run_plain(x, g, eta, inplace=inplace, **kw)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_operands(x, g, method=method, base_kind=base_kind, mu=mu, nu=nu,
                    count=count, pv=pv)
    scal = pack_scal(eta, lam, base_kind=base_kind, hyper=hyper,
                     post_scale=post_scale, count=count, device=x.device)
    nesterov = base_kind == "trace" and bool(hyper[1])
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        out = large_p.fused(runner or large_p.runner(x), x, g, scal, method=method,
                            lam=float(lam), base_kind=base_kind, nesterov=nesterov,
                            mu=mu, nu=nu, pv=pv, inplace=inplace)
    _COUNTERS["fused_step_large", method].launches += 1
    return out


def fused_step_large_tc(x, g, eta, *, method="pogo", lam, base_kind="none",
                        hyper=(), post_scale=1.0, mu=None, nu=None, count=None,
                        pv=None, inplace=False, runner=None):
    """:func:`fused_step_large` on the tensor cores (``large_p.fused_tc``:
    3xTF32 ``wgmma`` grams and applies fed by TMA, n % 4 == 0);
    ``method="landing"`` runs ``fused_step_large_tc_landing``."""
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=hyper,
              post_scale=post_scale, mu=mu, nu=nu, count=count, pv=pv)
    if runner is None and x.device.type == "cpu":
        return run_plain(x, g, eta, inplace=inplace, **kw)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_operands(x, g, method=method, base_kind=base_kind, mu=mu, nu=nu,
                    count=count, pv=pv)
    scal = pack_scal(eta, lam, base_kind=base_kind, hyper=hyper,
                     post_scale=post_scale, count=count, device=x.device)
    nesterov = base_kind == "trace" and bool(hyper[1])
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        out = large_p.fused_tc(runner or large_p.runner(x), x, g, scal, method=method,
                               lam=float(lam), base_kind=base_kind, nesterov=nesterov,
                               mu=mu, nu=nu, pv=pv, inplace=inplace)
    _COUNTERS["fused_step_large_tc", method].launches += 1
    return out


def fused_step_whole_landing(x, g, eta, **kw):
    """``fused_step_whole(method="landing")``."""
    return fused_step_whole(x, g, eta, method="landing", **kw)


def fused_step_batched_landing(x, g, eta, **kw):
    """``fused_step_batched(method="landing")``."""
    return fused_step_batched(x, g, eta, method="landing", **kw)


def fused_step_tiled_landing(x, g, eta, **kw):
    """``fused_step_tiled(method="landing")``."""
    return fused_step_tiled(x, g, eta, method="landing", **kw)


def fused_step_tiled_tc_landing(x, g, eta, **kw):
    """``fused_step_tiled_tc(method="landing")``."""
    return fused_step_tiled_tc(x, g, eta, method="landing", **kw)


def fused_step_tiled_tc128_landing(x, g, eta, **kw):
    """``fused_step_tiled_tc128(method="landing")``."""
    return fused_step_tiled_tc128(x, g, eta, method="landing", **kw)


def fused_step_cluster_landing(x, g, eta, **kw):
    """``fused_step_cluster(method="landing")``."""
    return fused_step_cluster(x, g, eta, method="landing", **kw)


def fused_step_large_landing(x, g, eta, **kw):
    """``fused_step_large(method="landing")``."""
    return fused_step_large(x, g, eta, method="landing", **kw)


def fused_step_large_tc_landing(x, g, eta, **kw):
    """``fused_step_large_tc(method="landing")``."""
    return fused_step_large_tc(x, g, eta, method="landing", **kw)


_COUNTERS = {
    ("fused_step_whole", "pogo"): fused_step_whole,
    ("fused_step_tiled", "pogo"): fused_step_tiled,
    ("fused_step_whole", "landing"): fused_step_whole_landing,
    ("fused_step_batched", "pogo"): fused_step_batched,
    ("fused_step_batched", "landing"): fused_step_batched_landing,
    ("fused_step_tiled", "landing"): fused_step_tiled_landing,
    ("fused_step_tc", "pogo"): fused_step_tiled_tc,
    ("fused_step_tc", "landing"): fused_step_tiled_tc_landing,
    ("fused_step_tc128", "pogo"): fused_step_tiled_tc128,
    ("fused_step_tc128", "landing"): fused_step_tiled_tc128_landing,
    ("fused_step_cluster", "pogo"): fused_step_cluster,
    ("fused_step_cluster", "landing"): fused_step_cluster_landing,
    ("fused_step_large", "pogo"): fused_step_large,
    ("fused_step_large", "landing"): fused_step_large_landing,
    ("fused_step_large_tc", "pogo"): fused_step_large_tc,
    ("fused_step_large_tc", "landing"): fused_step_large_tc_landing,
}
for _k in _COUNTERS.values():
    _k.launches = 0
