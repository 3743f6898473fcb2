"""Wrappers of the landing-field kernels (``csrc/two_stage.cu``).

``landing_field`` replaces ``repro/kernels/landing_field.py:42``
(``_landing_kernel``): one CTA per matrix with X and G resident in shared
memory. ``landing_field_tiled`` replaces ``repro/kernels/landing_field.py:79``
(``pogo_update._phase1_kernel`` + ``_field_tile_kernel``, two launches on
the TPU): one launch, one CTA per matrix sweeping its column tiles twice,
the first sweep shared with ``pogo_update_tiled``.

Both take a ``(B, p, n)`` fp32 stack ``x`` and gradient ``g`` and return
Landing's field ``Lambda = 1/2 (A G - B X) + lam (A X - X)`` with
``A = X X^T``, ``B = X G^T``, in a new tensor. On a CPU tensor they run
the plain version ``ref.landing_field_ref``; on a CUDA tensor they launch
the kernel or raise. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from . import ref
from .pogo_update import launch


def _field(entry, x, g, lam, *extra):
    if x.device.type == "cpu":
        return ref.landing_field_ref(x, g, lam)
    return launch(entry, x, g, 0.0, lam, torch.empty_like(x), *extra)


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


landing_field.launches = 0
landing_field_tiled.launches = 0
