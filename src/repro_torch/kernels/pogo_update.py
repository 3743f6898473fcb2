"""Wrappers of the two-stage POGO update kernels (``csrc/two_stage.cu``,
``csrc/fused_step_tc.cu``, ``csrc/small_p.cu``, ``csrc/large_p.cu``,
``csrc/batched_whole.cu``).

``pogo_update_whole`` replaces ``repro/kernels/pogo_update.py:64``
(``_pogo_whole_kernel``): one CTA per matrix with X and G resident in
shared memory. ``pogo_update_tiled`` replaces ``repro/kernels/
pogo_update.py:143`` (``_phase1/2/3_kernel``, three launches on the TPU):
one launch, one CTA per matrix sweeping its column tiles three times, M
parked in the output between the last two sweeps. Both are IEEE fp32 on
the CUDA cores. ``pogo_update_tiled_tc`` replaces the same TPU kernels on
the tensor cores for p <= 64 (the planner's range, ``ops.
plan_pogo_update``): the tensor-core fused step's kernel with no base
stage and no telemetry, 3xTF32 ``wgmma`` on TMA-fed 64-column chunks, one
persistent CTA per SM, the same three sweeps. ``pogo_update_tiled_tc128``
is the wide kernel's for 64 < p <= 128, sweep 2 once per 64-row half of
M, whose rows 0..63 wait in a scratch (``fused_step.park``);
``pogo_update_tiled_tc`` hands p > 64 to it. ``pogo_update_cluster``
(``csrc/small_p.cu``) replaces the tiled TPU kernels up to p = 24
(``ops.CLUSTER_MAX_P``) where a thread block cluster holds one matrix: X
and G read once, X' written once. ``pogo_update_large``
(``csrc/large_p.cu``) replaces the tiled TPU kernels for p > 128, where
one matrix's (p, p) grams outgrow a block: the TPU's three phases as
gram-then-apply launches, the grams between them in HBM and L2, on the
CUDA cores where n % 4 != 0; ``pogo_update_large_tc`` is the same on the
tensor cores (3xTF32 ``wgmma`` fed by TMA), the route at n % 4 == 0.
``pogo_update_batched`` (``csrc/batched_whole.cu``) replaces the TPU kernel
of ``pogo_update_whole`` for stacks of many matrices of p <= n <= 4: a
thread a matrix, persistent CTAs walking groups of consecutive matrices
fed by 1-D bulk copies.

All of them take a ``(B, p, n)`` fp32 stack ``x`` and transformed gradient ``g``
and return ``X' = (1 + lam) M - lam (M M^T) M`` with ``M = X - eta/2
(X X^T G - X G^T X)``. On a CPU tensor they run the plain version
``ref.pogo_update_ref``; on a CUDA tensor they check the operands, launch
on the current stream and raise if the launch fails. There is no
fallback. ``inplace=True`` writes X' over ``x``. Each wrapper counts its
launches in ``.launches``. The landing-field wrappers
(``landing_field.py``) share this module's launcher, and the CUDA-core
ones its library.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import build, fused_step, large_p, ref
from .fused_step import check_operand

_P = ctypes.c_void_p
_I = ctypes.c_int
METHODS = {"pogo": 0, "landing": 1}  # two_stage.cu's Method


def lib() -> ctypes.CDLL:
    """The loaded ``two_stage.cu`` library, built on first use."""
    lib_ = build.load("two_stage")
    if not getattr(lib_, "_typed", False):
        for fn in (lib_.pogo_update_whole, lib_.landing_field_whole):
            fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        for fn in (lib_.pogo_update_tiled, lib_.landing_field_tiled):
            fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib_.two_stage_whole_smem_bytes.argtypes = [_I] * 3
        lib_.two_stage_tiled_smem_bytes.argtypes = [_I] * 3
        for fn in (lib_.pogo_update_whole, lib_.pogo_update_tiled,
                   lib_.landing_field_whole, lib_.landing_field_tiled,
                   lib_.two_stage_whole_smem_bytes,
                   lib_.two_stage_tiled_smem_bytes):
            fn.restype = _I
        lib_._typed = True
    return lib_


@functools.lru_cache(maxsize=64)
def _scal(eta: float, lam: float, device: torch.device) -> torch.Tensor:
    """The kernels' fp32 scalar vector on ``device``, ``[eta, lam, 1, 0,
    0, 0, 0, 0]`` (the tensor-core kernel's ``scal[8]`` with post_scale 1;
    ``two_stage.cu`` reads the first two), made once per value, so that a
    step with a constant learning rate copies nothing to the card. The
    kernels only read it."""
    return torch.tensor([eta, lam, 1.0] + [0.0] * 5, dtype=torch.float32,
                        device=device)


def scalars(eta, lam, device) -> torch.Tensor:
    """:func:`_scal`'s vector for this call: ``eta`` a Python number, or a
    learning rate already on the card (one device op, no copy)."""
    if isinstance(eta, (int, float)):
        return _scal(float(eta), float(lam), device)
    eta = torch.as_tensor(eta, dtype=torch.float32, device=device).reshape(1)
    return torch.cat((eta, _scal(0.0, float(lam), device)[1:]))


def check_operands(x, g, out):
    """The two-stage kernels' operand checks: fp32 ``(B, p, n)`` stacks on
    x's device, contiguous, ``out`` not ``g``."""
    if x.dim() != 3:
        raise ValueError(f"x must be a (B, p, n) stack, got {tuple(x.shape)}")
    for name, t in (("x", x), ("g", g), ("out", out)):
        check_operand(name, t, tuple(x.shape), torch.float32, x.device)
    if out.data_ptr() == g.data_ptr():
        raise ValueError("out must not alias g")


def launch(entry: str, x, g, eta, lam, out, *extra, lib=lib) -> torch.Tensor:
    """Launch ``entry`` of ``lib()`` (``two_stage.cu``, or the two-stage
    entries of ``fused_step_tc.cu``) on CUDA tensors: ``out`` gets the
    result (it may be ``x``, never ``g``)."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_operands(x, g, out)
    dev = x.device
    shape = tuple(x.shape)
    scal = scalars(eta, lam, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib(), entry)(x.data_ptr(), g.data_ptr(), scal.data_ptr(),
                                    out.data_ptr(), *shape, *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry} kernel launch failed for (B, p, n) = {shape}: "
            f"cudaError {err}"
        )
    return out


def _update(entry, x, g, eta, lam, inplace, *extra, lib=lib):
    if x.device.type == "cpu":
        out = ref.pogo_update_ref(x, g, eta, lam)
        return x.copy_(out) if inplace else out
    return launch(entry, x, g, eta, lam, x if inplace else torch.empty_like(x),
                  *extra, lib=lib)


def pogo_update_whole(x, g, eta, lam, *, inplace=False):
    """Whole-matrix POGO update: one CTA per ``(p, n)`` matrix, X and G in
    shared memory (``ops.pogo_whole_smem_bytes``)."""
    out = _update("pogo_update_whole", x, g, eta, lam, inplace)
    if x.device.type == "cuda":
        pogo_update_whole.launches += 1
    return out


def pogo_update_batched(x, g, eta, lam, *, inplace=False):
    """The whole-matrix POGO update over many matrices of p <= n <= 4: a
    thread a matrix, persistent CTAs walking groups of consecutive
    matrices, each group's X and G one 1-D bulk copy a tensor into a ring
    of stages, X' written back the same way."""
    out = _update("pogo_update_batched", x, g, eta, lam, inplace, lib=fused_step.batched_lib)
    if x.device.type == "cuda":
        pogo_update_batched.launches += 1
    return out


def pogo_update_tiled(x, g, eta, lam, *, tile_n=64, inplace=False):
    """Tiled POGO update: one CTA per matrix sweeping ``tile_n``-wide column
    tiles (A, B; then M and C; then X'), grams in shared memory
    (``ops.pogo_tiled_smem_bytes``)."""
    out = _update("pogo_update_tiled", x, g, eta, lam, inplace, int(tile_n))
    if x.device.type == "cuda":
        pogo_update_tiled.launches += 1
    return out


def pogo_update_tiled_tc(x, g, eta, lam, *, inplace=False):
    """Tensor-core POGO update for ``p <= 64``: one persistent CTA per SM
    walking the matrices in 64-column chunks (A, B; then M, parked in the
    output, and C; then X') through 3xTF32 ``wgmma`` on TMA-fed tiles
    (``ops.tc_smem_bytes``). A CUDA stack with p > 64 goes to
    :func:`pogo_update_tiled_tc128`."""
    if x.device.type == "cuda" and x.dim() == 3 and x.shape[1] > fused_step.TC_P:
        return pogo_update_tiled_tc128(x, g, eta, lam, inplace=inplace)
    out = _update("pogo_update_tc", x, g, eta, lam, inplace, None, lib=fused_step.tc_lib)
    if x.device.type == "cuda":
        pogo_update_tiled_tc.launches += 1
    return out


def pogo_update_tiled_tc128(x, g, eta, lam, *, inplace=False):
    """The wide tensor-core POGO update, ``64 < p <= 128``: A, B over
    32-column chunks; M and C once per 64-row half of M (rows 0..63 parked
    in ``fused_step.park``, rows 64.. in the output); then X'."""
    if x.device.type != "cuda":
        return _update("pogo_update_tc", x, g, eta, lam, inplace)
    if x.dim() == 3 and x.shape[1] <= fused_step.TC_P:
        raise ValueError(f"the wide kernel takes {fused_step.TC_P} < p <= "
                         f"{fused_step.TC_WIDE_P}, got p={x.shape[1]}: "
                         "pogo_update_tiled_tc runs it")
    scratch = fused_step.park(x) if x.dim() == 3 else None
    out = _update("pogo_update_tc", x, g, eta, lam, inplace,
                  None if scratch is None else scratch.data_ptr(), lib=fused_step.tc_lib)
    pogo_update_tiled_tc128.launches += 1
    return out


def pogo_update_cluster(x, g, eta, lam, *, inplace=False, cluster=None):
    """The POGO update for small p (the kernel takes p <= 32) with one
    matrix a thread block cluster (``csrc/small_p.cu``): X and G held whole
    in the cluster's shared memory, read once, X' written once. ``cluster`` forces the cluster size
    (2, 4 or 8); by default the source's own (``ops.small_p_cluster``)."""
    out = _update("pogo_update_cluster", x, g, eta, lam, inplace, int(cluster or 0),
                  lib=fused_step.cluster_lib)
    if x.device.type == "cuda":
        pogo_update_cluster.launches += 1
    return out


def pogo_update_large(x, g, eta, lam, *, inplace=False, runner=None):
    """The POGO update for p > 128 (``csrc/large_p.cu``): A and BT, M into
    a scratch, C, then X', each a gram or an apply spread over many blocks
    (``large_p.pogo_update``). ``runner`` (a ``large_p.Runner``) launches
    elsewhere than on x's card: the CPU tests' emulated build."""
    if runner is None and x.device.type == "cpu":
        return _update(None, x, g, eta, lam, inplace)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = x if inplace else torch.empty_like(x)
    check_operands(x, g, out)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.pogo_update(runner or large_p.runner(x), x, g,
                            scalars(eta, lam, x.device), out)
    pogo_update_large.launches += 1
    return out


def pogo_update_large_tc(x, g, eta, lam, *, inplace=False, runner=None):
    """:func:`pogo_update_large` on the tensor cores
    (``large_p.pogo_update_tc``: 3xTF32 ``wgmma`` fed by TMA, n % 4 ==
    0)."""
    if runner is None and x.device.type == "cpu":
        return _update(None, x, g, eta, lam, inplace)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = x if inplace else torch.empty_like(x)
    check_operands(x, g, out)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.pogo_update_tc(runner or large_p.runner(x), x, g,
                               scalars(eta, lam, x.device), out)
    pogo_update_large_tc.launches += 1
    return out


pogo_update_whole.launches = 0
pogo_update_batched.launches = 0
pogo_update_tiled.launches = 0
pogo_update_tiled_tc.launches = 0
pogo_update_tiled_tc128.launches = 0
pogo_update_cluster.launches = 0
pogo_update_large.launches = 0
pogo_update_large_tc.launches = 0
