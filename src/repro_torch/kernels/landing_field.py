"""Wrappers of the landing-field kernels (``csrc/two_stage.cu``).

``landing_field`` replaces ``repro/kernels/landing_field.py:42``
(``_landing_kernel``): one CTA per matrix with X and G resident in shared
memory. ``landing_field_tiled`` replaces ``repro/kernels/landing_field.py:79``
(``pogo_update._phase1_kernel`` + ``_field_tile_kernel``, two launches on
the TPU): one launch, one CTA per matrix sweeping its column tiles twice,
the first sweep shared with ``pogo_update_tiled``.
``landing_field_tiled_tc`` replaces the same TPU kernels on the tensor
cores for p <= 64 (the planner's range, ``ops.plan_landing_field``): the
tensor-core fused step's Landing branch with no base stage and no
telemetry, writing the field alone in its second sweep.
``landing_field_tiled_tc128`` is the wide kernel's for 64 < p <= 128,
sweep 2 once per 64-row half of Lambda, the kept blocks of A and B in a
scratch (``fused_step.park(rows=False)``); ``landing_field_tiled_tc``
hands p > 64 to it. ``landing_field_cluster`` (``csrc/small_p.cu``)
replaces the tiled TPU kernels up to p = 24 (``ops.CLUSTER_MAX_P``) where
a thread block cluster holds one matrix: X and G read once, Lambda
written once. ``landing_field_large`` (``csrc/large_p.cu``)
replaces the tiled TPU kernels for p > 128 (where it beat the CUDA-core
tiled kernel on the card, whose grams fit a block up to p ~ 160): the
TPU's two phases as gram launches and an apply launch, the grams between
them in HBM and L2, on the CUDA cores where n % 4 != 0;
``landing_field_large_tc`` is the same on the tensor cores (3xTF32
``wgmma`` fed by TMA), the route at n % 4 == 0.

All of them take a ``(B, p, n)`` fp32 stack ``x`` and gradient ``g`` and return
Landing's field ``Lambda = 1/2 (A G - B X) + lam (A X - X)`` with
``A = X X^T``, ``B = X G^T``, in a new tensor. On a CPU tensor they run
the plain version ``ref.landing_field_ref``; on a CUDA tensor they launch
the kernel or raise. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import contextlib

import torch

from . import fused_step, large_p, ref
from .pogo_update import check_operands, launch, lib, scalars


def _field(entry, x, g, lam, *extra, lib=lib):
    if x.device.type == "cpu":
        return ref.landing_field_ref(x, g, lam)
    return launch(entry, x, g, 0.0, lam, torch.empty_like(x), *extra, lib=lib)


def landing_field(x, g, lam):
    """Whole-matrix landing field: one CTA per ``(p, n)`` matrix, X and G in
    shared memory (``ops.landing_whole_smem_bytes``)."""
    out = _field("landing_field_whole", x, g, lam)
    if x.device.type == "cuda":
        landing_field.launches += 1
    return out


def landing_field_tiled(x, g, lam, *, tile_n=64):
    """Tiled landing field: one CTA per matrix sweeping ``tile_n``-wide
    column tiles (A, B; then Lambda), grams in shared memory
    (``ops.landing_tiled_smem_bytes``)."""
    out = _field("landing_field_tiled", x, g, lam, int(tile_n))
    if x.device.type == "cuda":
        landing_field_tiled.launches += 1
    return out


def landing_field_tiled_tc(x, g, lam):
    """Tensor-core landing field for ``p <= 64``: one persistent CTA per SM
    walking the matrices in 64-column chunks (A, B; then Lambda) through
    3xTF32 ``wgmma`` on TMA-fed tiles (``ops.tc_smem_bytes``). A CUDA stack
    with p > 64 goes to :func:`landing_field_tiled_tc128`."""
    if x.device.type == "cuda" and x.dim() == 3 and x.shape[1] > fused_step.TC_P:
        return landing_field_tiled_tc128(x, g, lam)
    out = _field("landing_field_tc", x, g, lam, None, lib=fused_step.tc_lib)
    if x.device.type == "cuda":
        landing_field_tiled_tc.launches += 1
    return out


def landing_field_tiled_tc128(x, g, lam):
    """The wide tensor-core landing field, ``64 < p <= 128``: A, B over
    32-column chunks; then Lambda once per 64-row half, straight to the
    output, the blocks of A and B for the second half kept in
    ``fused_step.park(rows=False)``."""
    if x.device.type != "cuda":
        return _field("landing_field_tc", x, g, lam)
    if x.dim() == 3 and x.shape[1] <= fused_step.TC_P:
        raise ValueError(f"the wide kernel takes {fused_step.TC_P} < p <= "
                         f"{fused_step.TC_WIDE_P}, got p={x.shape[1]}: "
                         "landing_field_tiled_tc runs it")
    scratch = fused_step.park(x, rows=False) if x.dim() == 3 else None
    out = _field("landing_field_tc", x, g, lam,
                 None if scratch is None else scratch.data_ptr(), lib=fused_step.tc_lib)
    landing_field_tiled_tc128.launches += 1
    return out


def landing_field_cluster(x, g, lam, *, cluster=None):
    """The landing field for small p (the kernel takes p <= 32) with one
    matrix a thread block cluster (``csrc/small_p.cu``): X and G held whole
    in the cluster's shared memory, read once, Lambda written once.
    ``cluster`` forces the cluster size (2, 4 or 8); by default the
    source's own (``ops.small_p_cluster``)."""
    out = _field("landing_field_cluster", x, g, lam, int(cluster or 0),
                 lib=fused_step.cluster_lib)
    if x.device.type == "cuda":
        landing_field_cluster.launches += 1
    return out


def landing_field_large(x, g, lam, *, runner=None):
    """The landing field for p > 128 (``csrc/large_p.cu``): A and BT, then
    Lambda, a gram and an apply spread over many blocks
    (``large_p.landing_field``). ``runner`` (a ``large_p.Runner``)
    launches elsewhere than on x's card: the CPU tests' emulated build."""
    if runner is None and x.device.type == "cpu":
        return ref.landing_field_ref(x, g, lam)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    check_operands(x, g, out)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.landing_field(runner or large_p.runner(x), x, g,
                              scalars(0.0, lam, x.device), out)
    landing_field_large.launches += 1
    return out


def landing_field_large_tc(x, g, lam, *, runner=None):
    """:func:`landing_field_large` on the tensor cores
    (``large_p.landing_field_tc``: 3xTF32 ``wgmma`` fed by TMA, n % 4 ==
    0)."""
    if runner is None and x.device.type == "cpu":
        return ref.landing_field_ref(x, g, lam)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    check_operands(x, g, out)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.landing_field_tc(runner or large_p.runner(x), x, g,
                                 scalars(0.0, lam, x.device), out)
    landing_field_large_tc.launches += 1
    return out


landing_field.launches = 0
landing_field_tiled.launches = 0
landing_field_tiled_tc.launches = 0
landing_field_tiled_tc128.launches = 0
landing_field_cluster.launches = 0
landing_field_large.launches = 0
landing_field_large_tc.launches = 0
