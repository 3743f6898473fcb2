"""Public kernel entry points with the Hopper shared-memory planner.

Port of ``repro/kernels/ops.py``: the fused group step, POGO and Landing
(``:355-477``), its tensor-parallel stages and single-device schedule
(``:483-673``), the two-stage POGO update (``:209-257``), the landing
field (``:281-314``), Newton-Schulz (``:700-725``) and the
flash-attention forward (``:729-763``). The TPU planner's
VMEM budget and live-buffer counts become the per-block shared-memory
footprint of each CUDA kernel, mirrored here from ``csrc/fused_step.cu``,
``csrc/fused_step_tc.cu``, ``csrc/small_p.cu``, ``csrc/tp_step.cu``,
``csrc/two_stage.cu`` and ``csrc/newton_schulz.cu``, and past it the large
route:

* ``whole`` when X and the (transformed) gradient of one matrix plus the
  kernel's (p, p) grams fit in one block's 227 KB;
* ``cluster`` otherwise, for the fused step (POGO and Landing) and the
  two-stage POGO update and landing field at p <= ``CLUSTER_MAX_P``, when
  n % 4 == 0 and a thread block cluster of at most 8 CTAs holds the matrix
  (``csrc/small_p.cu``, ``small_p_cluster``), and for Newton-Schulz at p <
  ``NS_TC_MIN_P`` where such a cluster holds Y (the same source's second
  kernel, ``ns_cluster``);
* ``tc`` otherwise when ``TC_MIN_P <= p <= TC_MAX_P`` (the tensor-core
  kernels of ``csrc/fused_step_tc.cu``, any n, one CTA per SM: one padded
  64-row ``wgmma`` tile for p <= 64, two 64-row halves up to 128), for
  the fused POGO step and the two-stage POGO update; from
  ``LANDING_TC_MIN_P`` for fused Landing, and from
  ``LANDING_FIELD_TC_MIN_P`` for the landing field; for Newton-Schulz
  ``NS_TC_MIN_P <= p <= 64`` where n fits a thread block cluster's shared
  memory (``csrc/newton_schulz_tc.cu``, ``ns_tc_cluster``);
* ``tc128`` for Newton-Schulz at ``NS_TC_MAX_P < p <= TC_MAX_P``
  where n fits a cluster of up to 16 CTAs (the same source's second
  kernel, ``ns_tc128_cluster``), and ``stream`` past it at n % 4 == 0 (the
  same source's third kernel, Y streamed through a TMA ring, one CTA a
  matrix);
* ``tiled`` otherwise, with the column tile that lets the most blocks
  share an SM (they hide each other's loads and barriers), the widest of
  those: the fused group step's and the two-stage kernels' p below the
  tensor-core range and Newton-Schulz's up to p = 128 outside it;
* ``large_tc`` for every p > 128 that does not fit whole, at n % 4 == 0:
  the gram-then-apply launches of ``csrc/large_p.cu`` (``large_p.py``) on
  the tensor cores (3xTF32 ``wgmma`` fed by TMA), each phase of the TPU's
  tiled kernels a launch over many blocks, the (p, p) operands between
  them in HBM and L2. The fused step's and the POGO update's grams and
  tiles outgrow one block there; the landing field's and Newton-Schulz's
  still fit up to p ~ 160 and 136, where the large route was faster on
  the card (the readings beside ``NS_TC_MAX_P``);
* ``large`` the same shapes at n % 4 != 0, a row stride TMA cannot take:
  the same launches on the CUDA cores (IEEE fp32).

The TP kernels always sweep n in tiles (a shard of a wide matrix rarely
fits one block whole), with the tile that lets the most blocks share an
SM; they have no large route, and ``plan_tp`` refuses p whose grams do
not fit (ROADMAP: "sharded schedules (large p)"). The ragged n-edge is
masked inside the kernels, so no operand is padded. Each entry point runs
the plain version on a CPU tensor and the planned kernel, or an error, on
a CUDA tensor.
"""

from __future__ import annotations

import functools

import torch

from . import flash_attention as _fa
from . import fused_step as _fs
from . import landing_field as _lf
from . import newton_schulz as _ns
from . import pogo_update as _pu
from . import ref
from . import tp_step as _tp

# Dynamic shared memory one H100 block may use (232,448 bytes), and what
# one SM holds for all its resident blocks, each of which reserves 1 KB.
SMEM_LIMIT_BYTES = 232448
SM_SMEM_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
_THREADS = 256
_TILE_NS = (64, 32)
# The fused group step's CUDA-core tiled kernel also takes a 16-column
# tile, the only one at which p = 128 (internlm2-1.8b's q/k) fits a block.
_FUSED_TILE_NS = (64, 32, 16)
# The two-stage kernels take it only where neither 64 nor 32 fits (p = 128
# for POGO's three tiles), so that no shape that planned before moves to a
# narrower tile.
_TWO_STAGE_FALLBACK = (16,)
# TC_MIN_P <= p <= TC_MAX_P takes csrc/fused_step_tc.cu (its wide kernel
# above p = 64), other p the CUDA-core tiled kernel; fused Landing from
# LANDING_TC_MIN_P. Its work per 64-column chunk does not shrink with p, the
# CUDA-core kernel's does. On an H100 (benchmarks_torch/tc_variants.py,
# 2048 x (p, 2048); ms, tensor-core / CUDA-core, POGO over VAdam; Landing
# over trace) the CUDA-core kernel was faster at p = 8, 16 and 24 for both;
# at p = 25 3.8688 / 3.6302; 2.9859 / 3.2010, at 28 3.8704 / 3.8008;
# 2.9938 / 3.4792, at 29 3.8698 / 3.9847; 2.9954 / 3.7153 and at 32
# 3.8885 / 4.0714; 3.0010 / 3.7433: POGO takes the tensor cores from p =
# 29, Landing from 25. Above 64 the wide kernel, at 576 x (p, 2048): p = 72
# 4.5692 / 5.9152; 3.6586 / 5.6448, 96 4.6310 / 8.8753; 3.7211 / 8.1520,
# 128 4.7414 / 17.9761; 3.8668 / 16.2153.
TC_MIN_P = 29
LANDING_TC_MIN_P = 25
TC_MAX_P = 128
# The two-stage POGO update and landing field take the tensor-core kernel's
# two-stage entries (its wide kernel above p = 64) for TC_MIN_P <= p <=
# TC_MAX_P (the field LANDING_FIELD_TC_MIN_P <= p <= TC_MAX_P). On an H100
# (benchmarks_torch/tc_variants.py, its two-stage lines; ms, tensor-core /
# CUDA-core tiled, POGO update; field) the CUDA-core kernels were faster
# at 2048 x (16, 4096) 6.6631 / 3.7574; 4.2318 / 2.7419 and 2048 x (24,
# 2048) 3.3908 / 2.7826; 2.1473 / 1.9936; at 2048 x (25, 2048) POGO's was,
# 3.4192 / 3.2231, the field's not, 2.1558 / 2.5652, and so to p = 28,
# 3.4188 / 3.3824; 2.1628 / 2.6789; the tensor-core entries were faster at
# 2048 x (29, 2048) 3.4247 / 3.5123; 2.1630 / 2.7052, (32, 2048) 3.4317 /
# 3.6149; 2.1888 / 2.6922, 1024 x (48, 2048) 1.7454 / 3.2877; 1.0975 /
# 2.2511 and 640 x (64, 960) 0.5388 / 1.4915; 0.3371 / 1.0294. The POGO
# update's wide kernel at 576 x (p, 2048): p = 72 4.3681 / 5.5770, 96
# 4.4355 / 8.3068, 128 4.5525 / 16.7332; the field's (a later call): p = 72
# 2.4731 / 3.4260, 96 2.5098 / 5.4644, 128 2.5745 / 8.9067.
LANDING_FIELD_TC_MIN_P = 25
# Newton-Schulz takes csrc/newton_schulz_tc.cu for NS_TC_MIN_P <= p <=
# NS_TC_MAX_P where one matrix does not fit a block whole and n fits a
# cluster. Its work per chunk does not shrink with p, the CUDA-core tiled
# kernel's does. On an H100 (benchmarks_torch/tc_variants.py --ns-shape, 12
# iterations; ms, tensor-core / CUDA-core tiled): 640 x (64, 960) 1.8397 /
# 5.8335; 512 x (p, 2048) p = 32 3.7050 / 4.5994, 40 3.7097 / 6.3019;
# 256 x (p, 4096) p = 32 4.5423 / 4.5597, 40 4.5572 / 6.2831, 48 4.5200 /
# 7.8868, 64 4.4703 / 10.7892; an earlier build of the kernel (2.05 ms at
# (64, 960)) lost at 256 x (24, 4096) 4.7512 / 3.6945 and (16, 4096)
# 4.7974 / 2.5269. p = 32 at n = 4096 is a tie within the spread of the
# readings (tensor-core 4.4949-4.5720, tiled 4.5507-4.6236); it takes the
# tensor cores with the rest of p = 32, which won clearly at n = 2048.
# Below it, where a cluster holds Y at n % 4 == 0, csrc/small_p.cu's
# Newton-Schulz kernel (row 9cl) beat row 9 at every p and n read (on an
# H100, benchmarks_torch/small_p_readings.py --ns; ms at 1048 x (p, n), row
# 9 / 9cl): (4, 10000) 14.3743 / 0.9178, (10, 10000) 18.4287 / 3.0378, (24,
# 4096) 12.7088 / 4.8953, (31, 2048) 8.4403 / 4.0294, (31, 10000) 38.7785 /
# 24.4383. It beat 9tc at p = 32 too (4.0171 / 7.2896 at n = 2048, 8.7314 /
# 17.9388 at 4096); p = 32 stays with 9tc here, no configuration has it.
NS_TC_MIN_P = 32
NS_TC_MAX_P = 64
# Above NS_TC_MAX_P and up to TC_MAX_P a route other than the CUDA-core
# tiled kernel (row 9) takes Newton-Schulz where a matrix does not fit
# whole only if it wins the watchdog's drift step and its idle repair
# (every matrix masked off, the launch of every other step) costs at most
# 0.1 ms more. The tensor-core large route wins the drift step but not the
# idle repair: its 24 launches each walk the 9,216 items of 576 matrices.
# Past NS_TC_MAX_P and up to TC_MAX_P the same source's kernel for p
# <= 128 wins both where n fits a cluster of 16 CTAs (ns_tc128_cluster:
# n <= 2048). On an H100 (chip_smoke.py's crossovers; ms at 576 x (p,
# 2048), drift step then idle repair, tiled / large_tc / tc128): p = 72
# 22.9319 / 18.7431 / 16.7919, 0.0306 / 0.2134 / 0.0334; p = 96 34.7598
# / 23.1556 / 16.4663, 0.0391 / 0.2146 / 0.0276; p = 128 (internlm2-1.8b's
# q/k) 59.5427 / 29.2676 / 17.6470, 0.0325 / 0.2165 / 0.0380. Row 9
# keeps n past 2048 there at n % 4 != 0 (row 9s takes n % 4 == 0, below
# ns_tc128_smem_bytes), and p < NS_TC_MIN_P where no cluster holds Y
# (n % 4 != 0, or n past a cluster of 8). That kernel takes p <= 64 too,
# but its products keep 128 rows whatever p, so NS_TC_MAX_P stays where
# the p <= 64 kernel ends. On an H100 (benchmarks_torch/ns_tc_readings.py;
# ms, p <= 64 kernel / p <= 128 kernel, drift step then idle): 640 x (64,
# 960) 1.8203 / 8.1161, 0.0164 / 0.0162; 512 x (32, 2048) 3.6329 /
# 13.0075, 0.0156 / 0.0156; 576 x (64, 2048) 4.0033 / 15.8711, 0.0159 /
# 0.0159.
# Past TC_MAX_P the landing field and Newton-Schulz take the
# large route (csrc/large_p.cu) wherever a matrix does not fit a block whole,
# although the CUDA-core tiled kernels' grams still fit a block up to p ~ 160
# (the field) and 136 (Newton-Schulz). On an H100 (chip_smoke.py's
# crossovers; ms, tiled / large on the CUDA cores) in PR 21: the field at
# 576 x (136, 2048) 11.8759 / 10.9079 and (160, 2048) 21.8771 / 11.1318;
# Newton-Schulz at 576 x (136, 2048) 73.5720 / 55.9646. In PR 22 (tiled /
# large on the tensor cores / on the CUDA cores): the field at 576 x (129,
# 2048) 11.7740 / 6.6435 / 10.5213, (136, 2048) 11.7979 / 6.6779 /
# 10.6576, (160, 2048) 21.9452 / 6.9077 / 10.8035; Newton-Schulz at 576 x
# (129, 2048) 73.3104 / 47.7701 / 54.1802, (136, 2048) 73.0624 / 48.0271 /
# 54.7195. The tensor cores' large route takes every n % 4 == 0 there
# (large_kind); it was faster than the CUDA cores' at every shape the card
# timed (PR 22: the paper's CNN filters and O-ViT, these crossovers).
# The fused step (POGO and Landing), the POGO update and the landing field
# take csrc/small_p.cu (one matrix a thread block cluster, held whole in its
# shared memory) for p <= CLUSTER_MAX_P where a matrix does not fit a block
# whole, n % 4 == 0 and a cluster of at most 8 CTAs holds it
# (small_p_cluster); elsewhere the routes below. On an H100 (two runs of
# benchmarks_torch/small_p_readings.py, 1048 x (p, n); ms, fused POGO over
# trace cluster / CUDA-core tiled; POGO
# update cluster / tiled, each pair from one run): (2, 10000) 0.3110 /
# 3.3292; 0.2093 / 2.9917, (4, 2048) 0.1234 / 0.7066; 0.0787 / 0.6159, (10,
# 10000) 1.2316 / 4.4384; 0.9036 / 4.0761, (16, 4096) 0.9398 / 2.2075;
# 0.6590 / 1.9723, (20, 4096) 1.4878 / 3.0071; 1.0933 / 2.5634, (24, 2048)
# 1.3298 / 1.7186; 0.8439 / 1.5132, (24, 4096) 2.3564 / 3.4093; 1.6031 /
# 3.0291, (28, 2048) 1.9457 / 2.0682; 1.2334 / 1.8529, (28, 4096) 4.4077 /
# 4.0989; 2.6640 / 3.7108. Against the tensor-core kernels (2tc / 6tc; one
# run, ms cluster / tensor-core, fused; update): (29, 2048) 2.3473 / 1.9227;
# 1.4419 / 1.7255, (29, 4096) 5.1407 / 3.7678; 3.1278 / 3.3954, (30, 3072)
# 3.4895 / 2.8507; 2.1887 / 2.5550, (32, 2048) 2.4828 / 1.9336; 1.5141 /
# 1.7117, (32, 4096) 5.4636 / 3.7604; 3.1873 / 3.3778. The fused step's cluster kernel lost at (28, 4096), so both routes
# stop at 24 (the update's wins at 28 and 29-32 are left to its tiled and
# tensor-core kernels: no configuration here has p in 25-32, and one end
# keeps both POGO paths of a group on one kernel design). Below p = 4 the
# kernel was read at p = 2 alone (10x), so the route has no low end.
# Landing's two end there too. Below LANDING_TC_MIN_P the cluster won
# everywhere (chip_smoke.py's crossovers, one run; ms, fused Landing over
# trace cluster / CUDA-core tiled; field cluster / tiled): (4, 10000)
# 0.4371 / 3.0640; 0.2189 / 2.2371, (10, 10000) 1.0754 / 3.8587; 0.6461 /
# 3.0023, (16, 10000) 2.8632 / 4.4531; 1.3259 / 3.3646, (24, 2048) 0.9104
# / 1.4913; 0.6309 / 1.0998, (24, 4096) 2.0894 / 2.9372; 1.2224 / 2.1810.
# Against the tensor cores (2Ltc / 8tc) it was mixed: (28, 2048) 1.2383 /
# 1.5102; 0.9679 / 1.0868, (28, 4096) 3.1960 / 2.9710; 2.0506 / 2.1453,
# (29, 2048) 1.4227 / 1.5058; 1.1224 / 1.0819, (32, 2048) 1.4722 /
# 1.5149; 1.1458 / 1.0825, on shapes no configuration has.
CLUSTER_MAX_P = 24
# Blocks per SM the tiled kernel's register cap allows (kTiledBlocksPerSm),
# and the TP kernels' (kTpBlocksPerSm).
_TILED_BLOCKS_PER_SM = 3
_TP_BLOCKS_PER_SM = 2


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _tile_ld(p4: int) -> int:
    """Row stride of a k-major tile (padded so float4 reads of consecutive
    rows fall on distinct bank groups)."""
    return p4 + 4 if (p4 // 4) % 2 == 0 else p4


def _whole_bytes(p: int, n: int, grams: int, scratch: int) -> int:
    p4 = _round4(p)
    return 4 * (2 * _round4(n) * _tile_ld(p4) + grams * p4 * p4 + scratch)


def _tiled_bytes(p: int, tile_n: int, grams: int, tiles: int, scratch: int) -> int:
    p4 = _round4(p)
    return 4 * (grams * p4 * p4 + tiles * tile_n * _tile_ld(p4) + scratch)


def whole_smem_bytes(p: int, n: int) -> int:
    """Shared memory of one fused whole-kernel block: X (then M, or
    Landing's X') and the transformed gradient (k-major, n rounded up to
    4), the grams A, B and C (Landing's W), and the block-reduction
    scratch. Both methods use the same buffers, so one plan serves both."""
    return _whole_bytes(p, n, 3, _THREADS // 32)


def tiled_smem_bytes(p: int, tile_n: int) -> int:
    """Shared memory of one fused tiled-kernel block: A, B and C (Landing's
    W), and the k-major X, transformed-gradient and M (Landing's X') tiles."""
    return _tiled_bytes(p, tile_n, 3, 3, _THREADS // 32)


def tc_smem_bytes(p: int) -> int:
    """Shared memory of one tensor-core fused-step block at p
    (``fused_tc_smem_bytes``), whatever n; one block a SM. For p <= 64 a
    ring of six 64 x 64 fp32 operand tiles, the two lo tiles and the four
    (p, p) operand tiles; above, the wide kernel's ring of six 128-row x
    32-column boxes and 128 KB for the (p, p) operands (one output half's
    slabs of P and Q, or E, hi and lo). Then the reduction scratch, thirteen
    mbarriers and 1 KB to align the tiles."""
    tile = 64 * 64 * 4
    body = 12 * tile if p <= 64 else 6 * 128 * 32 * 4 + 128 * 128 * 4 * 2
    return body + 64 + 8 * 13 + 1024


def tp_gram_smem_bytes(p: int, tile_n: int) -> int:
    """``tp_gram``: A, B, S and the X and Gb tiles, and the reduction
    scratch."""
    return _tiled_bytes(p, tile_n, 3, 2, _THREADS // 32)


def tp_apply_smem_bytes(p: int, tile_n: int) -> int:
    """``tp_apply``: A, B, S (then C or A^2) and two scratch (p, p)
    products, the X, Gb and M tiles, and the reduction scratch."""
    return _tiled_bytes(p, tile_n, 5, 3, _THREADS // 32)


def pogo_whole_smem_bytes(p: int, n: int) -> int:
    """``pogo_update_whole``: X (then M), G, and the grams A, B, C."""
    return _whole_bytes(p, n, 3, 0)


def pogo_tiled_smem_bytes(p: int, tile_n: int) -> int:
    """``pogo_update_tiled``: A, B, C and the X, G and M tiles."""
    return _tiled_bytes(p, tile_n, 3, 3, 0)


def landing_whole_smem_bytes(p: int, n: int) -> int:
    """``landing_field``: X, G and the grams A, B."""
    return _whole_bytes(p, n, 2, 0)


def landing_tiled_smem_bytes(p: int, tile_n: int) -> int:
    """``landing_field_tiled``: A, B and the X and G tiles."""
    return _tiled_bytes(p, tile_n, 2, 2, 0)


def ns_whole_smem_bytes(p: int, n: int) -> int:
    """``newton_schulz_whole``: Y (k-major, all n columns), the gram G
    and the block-reduction scratch."""
    p4 = _round4(p)
    return 4 * (_round4(n) * _tile_ld(p4) + p4 * p4 + _THREADS // 32)


def ns_tiled_smem_bytes(p: int, tile_n: int) -> int:
    """``newton_schulz_tiled``: two grams (this iterate's and the next),
    the Y and new-Y tiles, and the block-reduction scratch."""
    return _tiled_bytes(p, tile_n, 2, 2, _THREADS // 32)


# csrc/newton_schulz_tc.cu: 64-column chunks of Y, at most _NS_TC_CHUNKS a
# CTA, over a cluster of at most _NS_TC_CLUSTER CTAs.
_NS_TC_CHUNKS = 9
_NS_TC_CLUSTER = 8


def ns_tc_cluster(n: int) -> int:
    """CTAs of ``newton_schulz_tc``'s cluster for n (``ns_tc_cluster``):
    the least power of two, at most 8, that leaves a CTA at most nine
    64-column chunks; 0 when n is too wide."""
    chunks = -(-n // 64)
    c = 1
    while c <= _NS_TC_CLUSTER:
        if -(-chunks // c) <= _NS_TC_CHUNKS:
            return c
        c *= 2
    return 0


# csrc/newton_schulz_tc.cu's kernel for p <= 128: at most two 64-column
# chunks of Y a CTA over a cluster of 2 to 16 CTAs (16 is past the portable
# 8: cudaFuncAttributeNonPortableClusterSizeAllowed).
_NS_TC128_CHUNKS = 2
_NS_TC128_CLUSTERS = (2, 4, 8, 16)


def ns_tc128_cluster(n: int) -> int:
    """CTAs of ``newton_schulz_tc128``'s cluster for n
    (``ns_tc128_cluster``): the least of 2, 4, 8, 16 that leaves a CTA at
    most two 64-column chunks; 0 when n is too wide (past 2048)."""
    chunks = -(-n // 64)
    for c in _NS_TC128_CLUSTERS:
        if n >= 1 and -(-chunks // c) <= _NS_TC128_CHUNKS:
            return c
    return 0


def ns_tc128_smem_bytes(n: int) -> int:
    """``newton_schulz_tc128``: a CTA's chunks of Y (128 rows, 32 KB
    each), G hi and lo (64 KB each), its slice of the summed gram (64 KB /
    c), the reduction scratch and 1 KB to align the tiles; 0 when n is too
    wide."""
    c = ns_tc128_cluster(n)
    if c == 0:
        return 0
    chunks, g = -(-n // 64), 128 * 128 * 4
    return -(-chunks // c) * 128 * 64 * 4 + 2 * g + g // c + 64 + 1024


# csrc/newton_schulz_tc.cu's streaming kernel (row 9s): one matrix a CTA,
# a ring of NS_STREAM_STAGES 128 x 64 fp32 stages beside G hi and lo. Past
# ns_tc128_cluster's n (2048), at n % 4 == 0, it takes NS_TC_MAX_P < p <=
# TC_MAX_P (plan_newton_schulz): it won the drift step and kept the idle
# repair within 0.1 ms of row 9's at every shape read. One CTA a matrix
# because clusters read no faster at the configurations' n: a version of
# the kernel that took the cluster size c as a launch parameter (one matrix
# a cluster of c CTAs, each streaming a share of the chunks, the gram summed
# over DSMEM) read, on an H100 (benchmarks_torch/ns_tc_readings.py
# --stream, 12 iterations; ms, drift step then idle repair), at 2080 x
# (128, 6144) (starcoder2-15b's q/k; granite-20b's and mixtral-8x22b's are
# (128, 6144) too): row 9 577.0702 / 0.0356, c = 1 109.3400 / 0.0387, c = 2
# 110.6789 / 0.0413, c = 4 125.3378 / 0.0398, c = 8 132.1726 / 0.0386, c =
# 16 156.5471 / 0.0447; at 576 x (128, 4096): row 9 119.3244 / 0.0370, c =
# 1 22.0483 / 0.0375, c = 2 20.7372 / 0.0359, c = 4 24.1201 / 0.0362, c = 8
# 25.8874 / 0.0357, c = 16 32.1770 / 0.0363. Lower p (read apart; row 9,
# c = 1, c = 2): 576 x (72, 4096) 45.7272 / 20.5062 / 19.0482, 576 x (96,
# 4096) 73.6564 / 19.9881 / 18.6436, 2080 x (72, 6144) 191.2246 / 96.5854
# / 99.6145. c = 2 read best only at 576 matrices of n = 4096 (132 CTAs
# taking 4.4 matrices each), which no configuration has. The kernel as it
# stands, one CTA a matrix, read (the same script; row 9 / 9s, drift step
# then idle repair): 2080 x (128, 6144) 577.0546 / 105.6583, 0.0296 /
# 0.0278; 576 x (128, 4096) 119.3046 / 21.2136, 0.0306 / 0.0323; and at
# the class's lower edge, 576 x (65, 2112) (p = 65, 33 chunks), 22.0527 /
# 10.0763, 0.0294 / 0.0287. The shapes between (p = 66-71, n = 2052-2108)
# were not read one by one.
NS_STREAM_STAGES = 3


def ns_stream_smem_bytes() -> int:
    """``newton_schulz_stream``'s shared memory a CTA: the ring, G hi and lo
    (64 KB each), the reduction scratch, the mbarriers and 1 KB to align the
    tiles."""
    return NS_STREAM_STAGES * 128 * 64 * 4 + 2 * 128 * 128 * 4 + 64 + 16 * NS_STREAM_STAGES + 1024


def ns_stream_takes(n: int) -> bool:
    """Whether ``newton_schulz_stream`` takes n: n % 4 == 0 (TMA's row
    stride) and at least as many 64-column chunks as the ring has stages
    (so that it never loads a chunk's next sweep before storing this one)."""
    return n >= 1 and n % 4 == 0 and -(-n // 64) >= NS_STREAM_STAGES


def ns_tc_smem_bytes(n: int) -> int:
    """``newton_schulz_tc``: a CTA's chunks of Y (16 KB each), G hi and lo,
    the CTA's partial gram (64, 65), the two published (64, 64) partials,
    the reduction scratch and 1 KB to align the tiles."""
    c = ns_tc_cluster(n)
    if c == 0:
        return 0
    chunks = -(-n // 64)
    tile = 64 * 64 * 4
    return (-(-chunks // c) + 2) * tile + 64 * 65 * 4 + 2 * tile + 64 + 1024


# csrc/small_p.cu: a CTA's columns in row-major boxes of at most
# _SMALL_P_BOX columns, at most _SMALL_P_BOXES of them, over a cluster of
# 2, 4 or 8 CTAs.
_SMALL_P_BOX = 256
_SMALL_P_BOXES = 64
_SMALL_P_CLUSTERS = (2, 4, 8)
# The kernels take p <= 32 (kSpMaxP), past the route's CLUSTER_MAX_P, so that
# the readings beside it can time both sides of its end.
SMALL_P_MAX_P = 32


def _small_p_layout(p: int, n: int, c: int) -> tuple[int, int, int]:
    """``sp_layout``: (box columns, boxes a CTA, bytes of a box's slot)."""
    cols = -(-n // c)
    nbox = -(-cols // _SMALL_P_BOX)
    w = _round4(-(-cols // nbox))
    return w, nbox, -(-(p * w * 4) // 128) * 128


def small_p_smem_bytes(p: int, n: int, c: int) -> int:
    """``small_p_smem_bytes``: one CTA's X and Geu slices (a slot of p x W
    floats a box, rounded up to 128 bytes), the published and summed (PB,
    PB) grams and the distance's scratch (PB = p rounded up to 4), a zero
    row, the warps' partials, the reduction scratch, two mbarriers a box and
    1 KB to align the slices."""
    _, nbox, sbox = _small_p_layout(p, n, c)
    pb = _round4(p)
    return 2 * nbox * sbox + 4 * (7 * pb * pb + _SMALL_P_BOX + 8 * 16 + 16) + 16 * nbox + 1024


def _least_cluster(p: int, n: int, smem_bytes, most: int = 2) -> int:
    """``sp_least_cluster``: the least of 2, 4 and 8 whose CTA
    (``smem_bytes(p, n, c)``) leaves its SM room for a second (where the
    kernel's registers allow ``most`` CTAs an SM, two), else the least whose
    slices fit a CTA; 0 where none does (or p > ``SMALL_P_MAX_P``, or n % 4
    != 0)."""
    if not 1 <= p <= SMALL_P_MAX_P or n < 4 or n % 4:
        return 0
    for ctas in range(most, 0, -1):
        for c in _SMALL_P_CLUSTERS:
            smem = smem_bytes(p, n, c)
            if (_small_p_layout(p, n, c)[1] <= _SMALL_P_BOXES and smem <= SMEM_LIMIT_BYTES
                    and ctas * (smem + _BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES):
                return c
    return 0


def small_p_cluster(p: int, n: int) -> int:
    """``small_p_cluster``: the CTAs of the cluster kernels' cluster for
    (p, n) (:func:`_least_cluster`), so that one CTA's loads run under the
    other's products (on an H100 at 1048 x (10, 10000), ms fused POGO / POGO
    update, in one run of ``benchmarks_torch/small_p_readings.py``: c = 8,
    two CTAs an SM, 1.2307 / 0.9033; c = 4, one, 1.5050 / 1.0695)."""
    return _least_cluster(p, n, small_p_smem_bytes)


def ns_cluster_smem_bytes(p: int, n: int, c: int) -> int:
    """``ns_cluster_smem_bytes``: one CTA of Newton-Schulz's cluster kernel,
    its slots of Y (p x W floats a box, rounded up to 128 bytes), two sets
    of published (PB, PB) grams and the summed one, a zero row, the warps'
    partials, an mbarrier a box and 1 KB to align the slots."""
    _, nbox, sbox = _small_p_layout(p, n, c)
    pb = _round4(p)
    return nbox * sbox + 4 * (3 * pb * pb + _SMALL_P_BOX + 8 * 16) + 8 * nbox + 1024


def ns_cluster(p: int, n: int) -> int:
    """``ns_cluster``: the CTAs of ``newton_schulz_cluster``'s cluster for
    (p, n), :func:`_least_cluster` on Y's slots alone, with the CTAs an SM
    that the kernel's registers allow (``ns_ctas_per_sm``: two to p = 12,
    one past it); 0 where none holds Y."""
    return _least_cluster(p, n, ns_cluster_smem_bytes, 2 if p <= 12 else 1)


def _blocks_per_sm(smem: int, cap: int = _TILED_BLOCKS_PER_SM) -> int:
    """Tiled-kernel blocks that fit one SM, by shared memory and registers."""
    return min(cap, SM_SMEM_BYTES // (smem + _BLOCK_RESERVED_BYTES))


def tiled_blocks_per_sm(p: int, tile_n: int) -> int:
    """Fused tiled-kernel blocks that fit one SM."""
    return _blocks_per_sm(tiled_smem_bytes(p, tile_n))


def _best_tile(p: int, tiled_bytes, cap: int = _TILED_BLOCKS_PER_SM,
               tiles: tuple[int, ...] = _TILE_NS,
               fallback: tuple[int, ...] = ()) -> int | None:
    """The column tile of ``tiles`` (of ``fallback`` when none of them fits
    a block) that lets the most blocks share an SM, the widest of those;
    None when even the narrowest does not fit a block."""
    fits = ([t for t in tiles if tiled_bytes(p, t) <= SMEM_LIMIT_BYTES]
            or [t for t in fallback if tiled_bytes(p, t) <= SMEM_LIMIT_BYTES])
    if not fits:
        return None
    return max(fits, key=lambda t: (_blocks_per_sm(tiled_bytes(p, t), cap), t))


def ns_tiled_tile_n(p: int) -> int | None:
    """The CUDA-core tiled Newton-Schulz kernel's column tile for p (None:
    p too large for it)."""
    return _best_tile(p, ns_tiled_smem_bytes)


def tiled_tile_n(p: int) -> int | None:
    """The CUDA-core fused tiled kernel's column tile for p (None: p too
    large for it)."""
    return _best_tile(p, tiled_smem_bytes, tiles=_FUSED_TILE_NS)


def _plan(what: str, p: int, n: int, whole_bytes, tiled_bytes,
          tiles: tuple[int, ...] = _TILE_NS,
          fallback: tuple[int, ...] = ()) -> tuple[str, int]:
    """``("whole", 0)`` when one matrix fits a block, else ``("tiled",
    tile_n)`` when the grams and a tile do, else a ``ValueError``."""
    if whole_bytes(p, n) <= SMEM_LIMIT_BYTES:
        return "whole", 0
    tile = _best_tile(p, tiled_bytes, tiles=tiles, fallback=fallback)
    if tile is not None:
        return "tiled", tile
    raise ValueError(
        f"{what}: p={p} (n={n}) needs {tiled_bytes(p, (tiles + fallback)[-1])} "
        f"bytes of shared memory for its (p, p) grams and tiles, over the "
        f"{SMEM_LIMIT_BYTES}-byte limit of one block"
    )


def _route(what: str, p: int, n: int, whole_bytes, tiled_bytes, tc_low: int,
           tc_high: int = TC_MAX_P, tiles: tuple[int, ...] = _TILE_NS,
           fallback: tuple[int, ...] = (), cluster=None) -> tuple[str, int]:
    """Whole when one matrix fits a block; else, with ``cluster`` =
    ``(capacity, high)``, the cluster kernel for p <= high where a cluster
    holds the matrix (``capacity(p, n)``: :func:`small_p_cluster` or
    :func:`ns_cluster`); else the tensor-core kernel for ``tc_low <= p <=
    tc_high``; else the large route for p > ``TC_MAX_P``
    (:func:`large_kind`); else :func:`_plan`'s tile (every p <=
    ``TC_MAX_P`` has one)."""
    if whole_bytes(p, n) > SMEM_LIMIT_BYTES:
        if cluster and p <= cluster[1] and cluster[0](p, n):
            return "cluster", 0
        if tc_low <= p <= tc_high:
            return "tc", 0
        if p > TC_MAX_P:
            return large_kind(n), 0
    return _plan(what, p, n, whole_bytes, tiled_bytes, tiles, fallback)


def large_kind(n: int) -> str:
    """The large route's kernels at row length n: the tensor cores'
    (``"large_tc"``) where TMA takes the row stride (n % 4 == 0), else
    the CUDA cores' (``"large"``)."""
    return "large_tc" if n % 4 == 0 else "large"


def plan(p: int, n: int, method: str = "pogo") -> tuple[str, int]:
    """``("whole", 0)``, ``("cluster", 0)``, ``("tc", 0)``, ``("tiled",
    tile_n)`` or the large route of the fused group step: whole when one
    matrix fits a block, else (p <= ``CLUSTER_MAX_P``) the cluster kernel
    where a cluster holds the matrix, else the tensor-core kernel for
    ``TC_MIN_P`` (``LANDING_TC_MIN_P`` for ``method="landing"``) ``<= p <=
    TC_MAX_P``, else the large route for p > ``TC_MAX_P``, else the
    CUDA-core tiled kernel."""
    low = LANDING_TC_MIN_P if method == "landing" else TC_MIN_P
    return _route("fused group step", p, n, whole_smem_bytes, tiled_smem_bytes, low,
                  tiles=_FUSED_TILE_NS, cluster=(small_p_cluster, CLUSTER_MAX_P))


def two_stage_tile_n(p: int, tiled_bytes) -> int | None:
    """The CUDA-core tiled two-stage kernel's column tile for p: the best of
    64 and 32, and 16 only where neither fits a block (p = 128 for POGO's
    three tiles), so that no shape that planned before moves to a narrower
    tile; None when even 16 does not fit."""
    return _best_tile(p, tiled_bytes, fallback=_TWO_STAGE_FALLBACK)


def plan_pogo_update(p: int, n: int) -> tuple[str, int]:
    """``("whole", 0)``, ``("cluster", 0)``, ``("tc", 0)``, ``("tiled",
    tile_n)`` or the large route of the POGO update (:func:`_route`, as
    :func:`plan`'s POGO step)."""
    return _route("pogo update", p, n, pogo_whole_smem_bytes, pogo_tiled_smem_bytes,
                  TC_MIN_P, fallback=_TWO_STAGE_FALLBACK,
                  cluster=(small_p_cluster, CLUSTER_MAX_P))


def plan_landing_field(p: int, n: int) -> tuple[str, int]:
    """``("whole", 0)``, ``("cluster", 0)``, ``("tc", 0)``, ``("tiled",
    tile_n)`` or the large route of the landing field (:func:`_route`; past
    p = 128 the large route, although the CUDA-core tiled kernel's grams
    fit a block up to p ~ 160: the readings beside ``NS_TC_MAX_P``)."""
    return _route("landing field", p, n, landing_whole_smem_bytes,
                  landing_tiled_smem_bytes, LANDING_FIELD_TC_MIN_P,
                  fallback=_TWO_STAGE_FALLBACK, cluster=(small_p_cluster, CLUSTER_MAX_P))


def plan_tp(what: str, p: int, tiled_bytes) -> int:
    """Column tile of a TP kernel: the one that lets the most blocks share
    an SM, the widest of those; a ``ValueError`` naming its ROADMAP entry
    when even the narrowest does not fit (the TP schedule has no large
    route yet)."""
    tile = _best_tile(p, tiled_bytes, _TP_BLOCKS_PER_SM)
    if tile is None:
        raise ValueError(
            f"{what}: p={p} needs {tiled_bytes(p, _TILE_NS[-1])} bytes of shared "
            f"memory for its (p, p) grams and tiles, over the {SMEM_LIMIT_BYTES}-"
            "byte limit of one block; the TP step at large p is not ported yet "
            "(ROADMAP: sharded schedules (large p))"
        )
    return tile


@functools.cache  # the watchdog's repair asks it on every step, the idle ones too
def plan_newton_schulz(p: int, n: int) -> tuple[str, int]:
    """``("whole", 0)``, ``("cluster", 0)``, ``("tc", 0)``, ``("tc128",
    0)``, ``("stream", 0)``, ``("tiled", tile_n)`` or the large route of
    Newton-Schulz (:func:`_route`): for p < ``NS_TC_MIN_P`` the cluster
    kernel of ``csrc/small_p.cu`` where a cluster holds Y (``ns_cluster``:
    n % 4 == 0); the tensor-core kernel for ``NS_TC_MIN_P <= p <=
    NS_TC_MAX_P`` when n fits a cluster (``ns_tc_cluster``), its p <= 128
    kernel above that up to ``TC_MAX_P`` when n fits one of up to 16 CTAs
    (``ns_tc128_cluster``), past that n the streaming kernel at n % 4 == 0
    (``ns_stream_takes``); past p = 128 the large route, although the
    CUDA-core tiled kernel's grams fit a block up to p = 136 (the readings
    beside ``NS_TC_MAX_P``)."""
    if ns_whole_smem_bytes(p, n) > SMEM_LIMIT_BYTES and NS_TC_MAX_P < p <= TC_MAX_P:
        if ns_tc128_cluster(n):
            return "tc128", 0
        if ns_stream_takes(n):
            return "stream", 0
    tc_high = NS_TC_MAX_P if ns_tc_cluster(n) else 0
    return _route("newton-schulz", p, n, ns_whole_smem_bytes, ns_tiled_smem_bytes,
                  NS_TC_MIN_P, tc_high, cluster=(ns_cluster, NS_TC_MIN_P - 1))


def pogo_update(x, g, eta, lam=0.5, *, find_root: bool = False,
                inplace: bool = False):
    """Two-stage POGO update of one ``(B, p, n)`` stack:
    ``X' = (1 + lam) M - lam (M M^T) M``, ``M = X - eta/2 (A G - B X)``
    (``repro.kernels.ops.pogo_update``). ``find_root`` lands with the
    quartic-root lambda per matrix, in plain PyTorch on any device as the
    JAX package runs it in jnp. ``inplace=True`` writes X' over ``x``."""
    if find_root:
        from ..core import quartic, stiefel

        m = x - eta * stiefel.riemannian_gradient(x, g)
        lam_v = quartic.optimal_lambda(m)[..., None, None]
        out = (1.0 + lam_v) * m - lam_v * (stiefel.gram(m) @ m)
        return x.copy_(out) if inplace else out
    if x.is_complex():
        raise ValueError("pogo_update is real-only (caller must gate)")
    if x.device.type == "cpu":  # the wrappers' plain version, any p
        return _pu.pogo_update_whole(x, g, eta, lam, inplace=inplace)
    kind, tile_n = plan_pogo_update(*x.shape[-2:])
    if kind == "whole":
        return _pu.pogo_update_whole(x, g, eta, lam, inplace=inplace)
    if kind == "cluster":
        return _pu.pogo_update_cluster(x, g, eta, lam, inplace=inplace)
    if kind == "tc":
        return _pu.pogo_update_tiled_tc(x, g, eta, lam, inplace=inplace)
    if kind == "large":
        return _pu.pogo_update_large(x, g, eta, lam, inplace=inplace)
    if kind == "large_tc":
        return _pu.pogo_update_large_tc(x, g, eta, lam, inplace=inplace)
    return _pu.pogo_update_tiled(x, g, eta, lam, tile_n=tile_n, inplace=inplace)


def landing_field(x, g, lam=1.0):
    """Landing's field ``1/2 (A G - B X) + lam (A X - X)`` of one
    ``(B, p, n)`` stack (``repro.kernels.ops.landing_field``)."""
    if x.is_complex():
        raise ValueError("landing_field is real-only (caller must gate)")
    if x.device.type == "cpu":  # the wrappers' plain version, any p
        return _lf.landing_field(x, g, lam)
    kind, tile_n = plan_landing_field(*x.shape[-2:])
    if kind == "whole":
        return _lf.landing_field(x, g, lam)
    if kind == "cluster":
        return _lf.landing_field_cluster(x, g, lam)
    if kind == "tc":
        return _lf.landing_field_tiled_tc(x, g, lam)
    if kind == "large":
        return _lf.landing_field_large(x, g, lam)
    if kind == "large_tc":
        return _lf.landing_field_large_tc(x, g, lam)
    return _lf.landing_field_tiled(x, g, lam, tile_n=tile_n)


def newton_schulz(x, iters: int = 12):
    """Batched Newton-Schulz polar projection of a ``(..., p, n)`` stack
    (``repro.kernels.ops.newton_schulz``), in a new tensor. The ragged
    p and n are masked in the kernels, so nothing is padded."""
    if x.is_complex() or x.device.type == "cpu":
        return ref.newton_schulz_ref(x, iters)
    *lead, p, n = x.shape
    xb = x.reshape(-1, p, n).to(torch.float32).contiguous()
    out = _ns_launch(xb, iters, torch.empty_like(xb), None, None)
    return out.reshape(*lead, p, n).to(x.dtype)


def newton_schulz_repair(x, dist, thresh, iters: int = 12):
    """The feasibility watchdog's drift repair on one ``(B, p, n)`` fp32
    stack, in place: every matrix with ``isfinite(dist) & (dist >
    thresh)`` is replaced by its Newton-Schulz projection and its entry of
    ``dist`` by the projection's ``||Y Y^T - I||_F``; the others keep
    their bits. ``thresh`` may be a tensor on the stack's device, so
    nothing waits for the card. Returns the ``(B,)`` bool repair mask."""
    mask = torch.isfinite(dist) & (dist > thresh)
    _ns_launch(x, iters, x, mask, dist)
    return mask


def _ns_launch(x, iters, out, mask, dist):
    if x.device.type == "cpu":
        return _ns.run_plain(x, iters, out=out, mask=mask, dist=dist)
    kind, tile_n = plan_newton_schulz(*x.shape[-2:])
    if kind == "whole":
        return _ns.newton_schulz_whole(x, iters, out=out, mask=mask, dist=dist)
    if kind == "tc":
        return _ns.newton_schulz_tc(x, iters, out=out, mask=mask, dist=dist)
    if kind == "tc128":
        return _ns.newton_schulz_tc128(x, iters, out=out, mask=mask, dist=dist)
    if kind == "stream":
        return _ns.newton_schulz_stream(x, iters, out=out, mask=mask, dist=dist)
    if kind == "cluster":
        return _ns.newton_schulz_cluster(x, iters, out=out, mask=mask, dist=dist)
    if kind == "large":
        return _ns.newton_schulz_large(x, iters, out=out, mask=mask, dist=dist)
    if kind == "large_tc":
        return _ns.newton_schulz_large_tc(x, iters, out=out, mask=mask, dist=dist)
    return _ns.newton_schulz_tiled(x, iters, tile_n=tile_n, out=out, mask=mask,
                                   dist=dist)


KERNELS = (_fs.fused_step_whole, _fs.fused_step_tiled, _fs.fused_step_cluster,
           _fs.fused_step_whole_landing, _fs.fused_step_tiled_landing,
           _fs.fused_step_cluster_landing,
           _fs.fused_step_tiled_tc, _fs.fused_step_tiled_tc_landing,
           _fs.fused_step_tiled_tc128, _fs.fused_step_tiled_tc128_landing,
           _fs.fused_step_large, _fs.fused_step_large_landing,
           _fs.fused_step_large_tc, _fs.fused_step_large_tc_landing,
           _tp.tp_gram, _tp.tp_apply, _pu.pogo_update_whole,
           _pu.pogo_update_tiled, _pu.pogo_update_cluster, _pu.pogo_update_tiled_tc,
           _pu.pogo_update_tiled_tc128, _pu.pogo_update_large, _pu.pogo_update_large_tc,
           _lf.landing_field, _lf.landing_field_tiled, _lf.landing_field_cluster,
           _lf.landing_field_tiled_tc,
           _lf.landing_field_tiled_tc128, _lf.landing_field_large,
           _lf.landing_field_large_tc, _ns.newton_schulz_whole, _ns.newton_schulz_tiled,
           _ns.newton_schulz_tc, _ns.newton_schulz_tc128, _ns.newton_schulz_stream,
           _ns.newton_schulz_cluster,
           _ns.newton_schulz_large,
           _ns.newton_schulz_large_tc,
           _fa.flash_attention_fp32, _fa.flash_attention_tf32, _fa.flash_attention_tc)


def launches() -> dict:
    """Launches of every kernel wrapper since the last reset, by name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


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

    In-kernel linear base optimizer (``none`` | ``trace`` | ``vadam``),
    then ``method="pogo"``'s direction, leap and land with the distance
    from the land gram, or ``"landing"``'s fixed step with the distance
    from the direct gram of X'. Returns ``(x_next, mu', nu', dist,
    finite)`` as ``repro.kernels.ops.fused_group_step`` does, ``finite =
    isfinite(dist)``.

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
    kind, tile_n = plan(p, n, method)
    if kind == "whole":
        return _fs.fused_step_whole(x, g, eta, **kw)
    if kind == "cluster":
        return _fs.fused_step_cluster(x, g, eta, **kw)
    if kind == "tc":
        return _fs.fused_step_tiled_tc(x, g, eta, **kw)
    if kind == "large":
        return _fs.fused_step_large(x, g, eta, **kw)
    if kind == "large_tc":
        return _fs.fused_step_large_tc(x, g, eta, **kw)
    return _fs.fused_step_tiled(x, g, eta, tile_n=tile_n, **kw)



# ----------------------------------------- tensor-parallel fused group step


def fused_group_step_tp_partial(x, g, *, base_kind: str = "none",
                                hyper: tuple = (), post_scale: float = 1.0,
                                mu=None, inplace: bool = False):
    """Local stage of the one-all-reduce TP step on a rank's ``(B, p,
    n_local)`` columns (``repro.kernels.ops.fused_group_step_tp_partial``):
    sum the returned ``(B, K)`` payload over the TP ranks, then call
    :func:`fused_group_step_tp_finish`. Returns ``(payload, gbase, mu')``;
    ``inplace=True`` writes mu' over ``mu``."""
    if x.is_complex():
        raise ValueError("the TP group step is real-only (caller must gate)")
    tile_n = 0 if x.device.type == "cpu" else \
        plan_tp("tp_gram", x.shape[1], tp_gram_smem_bytes)
    return _tp.tp_gram(x, g, base_kind=base_kind, hyper=tuple(hyper),
                       post_scale=float(post_scale), mu=mu, inplace=inplace,
                       tile_n=tile_n)


def fused_group_step_tp_finish(x, gbase, payload, eta, *, method: str, lam,
                               base_kind: str = "none", hyper: tuple = (),
                               post_scale: float = 1.0, nu=None, count=None,
                               pv=None, inplace: bool = False):
    """Column-local finish of the TP step on the full payload
    (``repro.kernels.ops.fused_group_step_tp_finish``): vadam's deferred
    scalar and nu' in torch ops on the payload (``ref.tp_scale_ref``), then
    the ``tp_apply`` kernel. ``dist`` depends on the replicated payload
    only, so every rank gets the same. Returns ``(x2, nu', dist,
    finite)``; ``inplace=True`` writes X' over ``x``."""
    scl = nu_out = None
    if base_kind == "vadam":
        scl, nu_out = ref.tp_scale_ref(payload, x.shape[-2], hyper=tuple(hyper),
                                       post_scale=float(post_scale), nu=nu,
                                       count=count)
        scl = scl.contiguous()
    tile_n = 0 if x.device.type == "cpu" else \
        plan_tp("tp_apply", x.shape[1], tp_apply_smem_bytes)
    x2, dist = _tp.tp_apply(x, gbase, payload, eta, scl, method=method, lam=lam,
                            pv=pv, inplace=inplace, tile_n=tile_n)
    return x2, nu_out, dist, torch.isfinite(dist)


def fused_group_step_tp(x, g, eta, *, method: str, lam, base_kind: str = "none",
                        hyper: tuple = (), post_scale: float = 1.0, mu=None,
                        nu=None, count=None, pv=None, tp_shards: int = 1):
    """The TP schedule on one device (``repro.kernels.ops.fused_group_step_tp``):
    ``n`` split into ``tp_shards`` chunks, a partial per chunk, the
    payloads left-folded in shard order (the order ``ref.
    fused_group_step_tp_ref`` sums in), the finish on the full matrix.
    Returns :func:`fused_group_step`'s 5-tuple, in new tensors."""
    if x.is_complex():
        raise ValueError("the TP group step is real-only (caller must gate)")
    n = x.shape[-1]
    if n % tp_shards:
        raise ValueError(f"n={n} does not split into {tp_shards} shards")
    loc = n // tp_shards
    total = None
    gbs, mus = [], []
    for k in range(tp_shards):
        sl = slice(k * loc, (k + 1) * loc)
        pay, gb, mo = fused_group_step_tp_partial(
            x[..., sl].contiguous(), g[..., sl].contiguous(), base_kind=base_kind,
            hyper=hyper, post_scale=post_scale,
            mu=None if mu is None else mu[..., sl].contiguous())
        total = pay if total is None else total + pay
        gbs.append(gb)
        mus.append(mo)
    x2, nu_out, dist, finite = fused_group_step_tp_finish(
        x, torch.cat(gbs, dim=-1), total, eta, method=method, lam=lam,
        base_kind=base_kind, hyper=hyper, post_scale=post_scale, nu=nu,
        count=count, pv=pv)
    mu_out = None if mu is None else torch.cat(mus, dim=-1)
    return x2, mu_out, nu_out, dist, finite


# ------------------------------------------------------------ flash attention


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Flash-attention forward on ``(B, S, H, hd)`` GQA inputs
    (``repro.kernels.ops.flash_attention``): on a CUDA tensor the kernel
    that ``flash_attention.plan`` picks (``csrc/flash_attention_tc.cu`` for
    bf16, the 3xTF32 ``csrc/flash_attention_tf32.cu`` for fp32 at hd % 4
    == 0, the CUDA-core ``csrc/flash_attention.cu`` for the rest of fp32),
    the plain version on a CPU tensor. Forward
    only: the prefill and every no-grad forward use it, training keeps the
    blocked attention of ``models/attention.py``. Unlike the TPU wrapper it
    pads nothing and repeats no KV head: the kernel masks keys past the
    true length and reads each query head's KV head in place."""
    return _fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window)
