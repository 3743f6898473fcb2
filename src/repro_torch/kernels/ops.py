"""Public fused group step with the Hopper shared-memory planner.

Port of ``repro/kernels/ops.py:355-477``. The TPU planner's VMEM budget
and live-buffer counts become the per-block shared-memory footprint of
the two CUDA kernels, mirrored here from ``csrc/fused_step.cu``:

* ``whole`` when X and the transformed gradient of one matrix plus the
  (p, p) grams A, B, C fit in one block's 227 KB;
* ``tiled`` otherwise, with the column tile that lets the most blocks
  share an SM (they hide each other's loads and barriers), the widest of
  those;
* a ``ValueError`` naming the shape and the limit when even the three
  (p, p) grams and the narrowest tiles do not fit (large p is later work).

The ragged n-edge is masked inside the kernels, so no operand is padded.
"""

from __future__ import annotations

import torch

from . import fused_step as _fs

# Dynamic shared memory one H100 block may use (232,448 bytes), and what
# one SM holds for all its resident blocks, each of which reserves 1 KB.
SMEM_LIMIT_BYTES = 232448
SM_SMEM_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
_THREADS = 256
_TILE_NS = (64, 32)
# Blocks per SM the tiled kernel's register cap allows (kTiledBlocksPerSm).
_TILED_BLOCKS_PER_SM = 3


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _tile_ld(p4: int) -> int:
    """Row stride of a k-major tile (padded so float4 reads of consecutive
    rows fall on distinct bank groups)."""
    return p4 + 4 if (p4 // 4) % 2 == 0 else p4


def whole_smem_bytes(p: int, n: int) -> int:
    """Shared memory of one whole-kernel block: X (then M) and the
    transformed gradient (k-major, n rounded up to 4), the grams A, B and
    C, and the block-reduction scratch."""
    p4 = _round4(p)
    return 4 * (2 * _round4(n) * _tile_ld(p4) + 3 * p4 * p4 + _THREADS // 32)


def tiled_smem_bytes(p: int, tile_n: int) -> int:
    """Shared memory of one tiled-kernel block: A, B and C, and the k-major
    X, transformed-gradient and M tiles."""
    p4 = _round4(p)
    return 4 * (3 * p4 * p4 + 3 * tile_n * _tile_ld(p4) + _THREADS // 32)


def tiled_blocks_per_sm(p: int, tile_n: int) -> int:
    """Tiled-kernel blocks that fit one SM, by shared memory and registers."""
    per_block = tiled_smem_bytes(p, tile_n) + _BLOCK_RESERVED_BYTES
    return min(_TILED_BLOCKS_PER_SM, SM_SMEM_BYTES // per_block)


def plan(p: int, n: int) -> tuple[str, int]:
    """``("whole", 0)`` or ``("tiled", tile_n)`` for ``(p, n)`` matrices."""
    if whole_smem_bytes(p, n) <= SMEM_LIMIT_BYTES:
        return "whole", 0
    fits = [t for t in _TILE_NS if tiled_smem_bytes(p, t) <= SMEM_LIMIT_BYTES]
    if fits:
        return "tiled", max(fits, key=lambda t: (tiled_blocks_per_sm(p, t), t))
    raise ValueError(
        f"fused group step: p={p} (n={n}) needs "
        f"{tiled_smem_bytes(p, _TILE_NS[-1])} bytes of shared memory for its "
        f"(p, p) grams and tiles, over the {SMEM_LIMIT_BYTES}-byte limit of "
        "one block; large-p groups are not ported yet"
    )


def fused_group_step(
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
    inplace: bool = False,
):
    """Single-pass fused group step on one ``(B, p, n)`` stack.

    In-kernel linear base optimizer (``none`` | ``trace`` | ``vadam``), the
    POGO direction, leap and land, and the per-matrix feasibility distance
    from the land gram. Returns ``(x_next, mu', nu', dist, finite)`` as
    ``repro.kernels.ops.fused_group_step`` does, ``finite = isfinite(dist)``.

    On a CPU tensor this runs ``ref.fused_group_step_ref``; on a CUDA
    tensor it launches the planned kernel or raises. ``inplace=True``
    writes X' over ``x`` and the moments over ``mu``/``nu``.
    """
    if x.is_complex():
        raise ValueError("fused_group_step is real-only (caller must gate)")
    kw = dict(method=method, lam=lam, base_kind=base_kind, hyper=tuple(hyper),
              post_scale=float(post_scale), mu=mu, nu=nu, count=count, pv=pv,
              inplace=inplace)
    if x.device.type == "cpu":
        return _fs.run_plain(x, g, eta, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no fused group step for device {x.device}")
    _, p, n = x.shape
    kind, tile_n = plan(p, n)
    if kind == "whole":
        return _fs.fused_step_whole(x, g, eta, **kw)
    return _fs.fused_step_tiled(x, g, eta, tile_n=tile_n, **kw)

