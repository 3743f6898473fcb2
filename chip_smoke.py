#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card, then drives the port's three main paths with
``constraint_step`` at the full width of SmolLM-360M's constrained q/k
projections (one 640 x (64, 960) stack: the tensor-core kernels of
``fused_step_tc.cu``, 3xTF32 ``wgmma`` on TMA-fed tiles, after a one-
``wgmma`` probe of the card's TF32 reading, for the fused step and the
two-stage POGO update and landing field), at the many-matrices shape
2048 x (16, 256) (the whole kernels), at internlm2-1.8b's q/k, one 576 x
(128, 2048) stack (p > 64: the wide tensor-core kernel of the same source
for the fused step, the POGO update and the landing field; 3 steps each),
and at the paper's squared-unitary-PC sizes, 1048 x (10, 10000) (p < 25:
the cluster kernel of ``small_p.cu``, one matrix a thread block cluster
held in its shared memory, for fused POGO, the POGO update, fused Landing
and the landing field; 3 steps each) and 1048 x (10, 9998) (n % 4 != 0:
the CUDA-core tiled kernels of all four, rows 2, 6, 2L and 8), and at the
paper's own sizes for p > 128
(``src/repro/configs/pogo_paper.py``): its six orthogonal CNN filters, as
(1, p, n) leaves (a step runs the whole kernel at (64, 216), the
tensor-core kernel at (64, 576), its wide form at (128, 1152) and the
large route of ``large_p.cu``, gram-then-apply launches on the tensor
cores, at the three (256, 2304) filters), O-ViT's 18 x (1024, 1024) (the
same route), and a stack at n % 4 != 0, ``LARGE_ODD`` (the large route on
the CUDA cores, where TMA cannot take the row stride); 3 steps each:

* the fused group step, ``orthogonal("pogo", use_kernel=True,
  base_optimizer=chain(trace(0.9)))``;
* POGO over Adam on the two-stage step, ``orthogonal("pogo",
  learning_rate=1e-3, base_optimizer=chain(scale_by_adam()),
  use_kernel=True)``. Adam's output has unit scale per entry, so lr 0.1
  diverges at (64, 960) in both packages
  (``tests/test_torch_two_stage.py::test_pogo_adam_step_size_at_smollm_width``);
* the paper's Landing on the two-stage step, ``orthogonal("landing",
  learning_rate=0.25, base_optimizer=chain(trace(0.1)), use_kernel=True)``
  (lam 1, eps 0.5, exact safe step);
* fixed-step Landing on the fused step, the same with ``safe_step=False``
  (lr 0.25 keeps it within 7e-5 of the manifold on the CPU with these
  gradients, eps is 0.5), then one step under the feasibility watchdog
  after a 1.5x drift, which must repair every matrix: at SmolLM's q/k
  (the tensor-core Newton-Schulz kernel of ``newton_schulz_tc.cu``, one
  thread block cluster a matrix), at internlm2-1.8b's (the same source's
  kernel for p <= 128, a persistent grid of clusters of 16 CTAs; the drift
  step timed with it and with row 9's CUDA-core tiled kernel, its route
  before), at starcoder2-15b's, one 2080 x (128, 6144) stack (the wide
  kernel's Landing and the same source's streaming kernel, row 9s, Y
  streamed through a TMA ring; the drift step timed with it and with row
  9), at the paper's unitary-PC sizes (the cluster kernel's Landing
  and its Newton-Schulz, row 9cl, one matrix's Y held in a thread block
  cluster; the drift step timed with it and with row 9), at 1048 x (10,
  9998) (the tiled Landing and row 9's tiled repair) and at the CNN
  filters' 3 x (256, 2304), O-ViT's 18 x (1024, 1024) (the large route's
  Landing and Newton-Schulz on the tensor cores) and ``LARGE_ODD`` (on
  the CUDA cores).

Each path's kernels, as the planners of ``kernels/ops.py`` pick them for
its groups, must launch once per group and step, its first step must
agree with the plain route, and its feasibility must hold. The
tensor-core kernels (the wide ones at 576 x (128, 2048)) and the large
route's entries (on the tensor cores at both paper sizes, on the CUDA
cores at ``LARGE_ODD``) are launched 20 times each on the same inputs,
half of them beside a copy on another stream, and must repeat bit for
bit, and so must the tensor-core Newton-Schulz kernels (row 9s at
starcoder2-15b's 2080 x (128, 6144)) and the cluster
kernels of ``small_p.cu`` (its four entries and Newton-Schulz's, at the
paper's 1048 x (10, 10000)) and the 3xTF32 flash-attention kernel (at
the prefill's shape). The cluster kernels are timed
beside rows 2, 6, 2L and 8 at that shape, and at the readings behind the
cluster route's ends (``phase_cluster_crossovers``: p = 4-28 at n =
2048-10000, p = 29 and 32 against the tensor-core kernels, and every
cluster size that fits at the paper's shape). The large route's
entries are held against their plain versions and timed at both paper
sizes in the phases of their functions' other kernels, the tensor cores'
in turns with the CUDA cores' (their route there before PR 22); the
CUDA-core tiled kernels whose grams still fit a block past p = 128 are
timed beside both (the crossovers behind the planner's rule), and the
tensor-core large Newton-Schulz and the tensor-core kernel for p <= 128
beside row 9's tiled kernel at 576 x (p, 2048), p = 72, 96 and 128, on
the drift step and idle. The Newton-Schulz kernels are
held against their plain version with half the matrices masked off
(row 9s at starcoder2-15b's q/k too, timed in turns with row 9 called
directly and with the plain version, the peak device memory printed), and
timed beside the repair launch that finds no matrix past the threshold
(the CUDA-core large route's also as its Python loop issued it before
its iterations moved into one C call). The tensor-parallel step: its two kernels against their plain
versions at a rank's share of the q/k stack at width 2, 640 x (64, 480),
and of the many-matrices stack, 2048 x (16, 128); its single-device
schedule (four shards of 640 x (64, 960)) against the unsharded fused
step; then its main path, two ranks on the one card (``gloo``, a (1, 2)
mesh, the q/k stack as ``DTensor`` stacks ``Shard(-1)`` on "model", each rank
a process of its own): three POGO steps over VAdam and three Landing
steps over trace through ``constraint_step``, one all-reduce per step on
each rank, every rank's columns equal to the unsharded fused step's, and
a padded case (n = 962). Then the trainer: SmolLM-360M at full width (32 layers),
batch 8 x 512 tokens, through ``make_train_step`` and ``train`` as the
launcher builds them (POGO's fused kernel over VAdam on the q/k group,
AdamW elsewhere, the feasibility watchdog on), 8 steps, the q/k leaves
scaled by 1.5 just before step 5 so that the watchdog's Newton-Schulz
repair fires on all 640 matrices; a resume from the step-4 checkpoint
must replay steps 5 and 6 bit for bit. Then serving, at SmolLM-360M's
full width: the three flash-attention kernels against their plain
version, the bf16 tensor-core kernel (causal at (B, S, H, KV, hd) = (4,
2048, 15, 5, 64), at internlm2-1.8b's (1, 2048, 16, 8, 128), windowed at
S = 2000 and at hd 24; one output ulp per element, the error printed in
ulps), the 3xTF32 tensor-core kernel in fp32 (the prefill's shape,
internlm2-1.8b's heads; causal, non-causal and windowed at S = 2000;
atol 2e-5 / rtol 1e-4) and the CUDA-core kernel in fp32 at hd 62 (hd % 4
!= 0, its route since the 3xTF32 kernel), each timed at the prefill's
shape in turns with its plain version and PyTorch's
``scaled_dot_product_attention`` (the library yardstick, never on the
port's path), the CUDA-core kernel called directly beside the 3xTF32 one
there; ``transformer.prefill`` on 4 x 2048 tokens in bf16 (32 launches
of the bf16 kernel a call), in fp32 compute (32 of the 3xTF32 kernel)
and in fp32 at a synthetic head dimension of 62 (32 of the CUDA-core
kernel), its logits against the same call with the plain version patched
in; ``repro_torch.launch.serve`` with ``benchmarks/
serve_bench.py``'s default geometry (32 requests, prompts of 8-48 tokens,
16 new tokens, 8 slots, 128 blocks of 16, chunks of 16, folded q/k), every
request finished, 4 of them against ``generate_reference`` on the card
(tokens equal or parting at a tie, ``serve/parity.py``), and an
overloaded engine (24 blocks, swap preemption) that must swap out and
restore, its restored requests held to the oracle likewise. Any failure
exits non-zero. The second-to-last line is a JSON record of every kernel
(launches on the main path, error against the plain version, times and
bounds); the last line is the device record. Without a CUDA card it exits
2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
TF32_TC_FLOP_PER_S = 495e12  # dense TF32 tensor-core peak
# exp2 on the SFUs: 16 a clock on each of the 132 SMs at the 1.83 GHz that
# the tensor-core peak assumes (989e12 = 132 x 4096 flops x 1.83e9)
SFU_EXP2_PER_S = 16 * 132 * 1.83e9
WHOLE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_fused_step.py:67
TILED_TOL = dict(atol=3e-5, rtol=1e-4)  # tests/test_fused_step.py:95
# tests/test_kernels.py:34-50 (whole, atol 1e-6) and :65-75 (tiled).
TWO_STAGE_WHOLE_TOL = dict(atol=1e-6, rtol=1e-6)
TWO_STAGE_TILED_TOL = dict(atol=2e-5, rtol=1e-4)
LR = 0.1
GRAD_SCALE = 5e-4  # per-entry gradient std: keeps eta ||R|| near 1e-2
SMOLLM_STEPS = 10
MANY = {"w": (2048, 16, 256)}
# internlm2-1.8b's constrained q/k projections (src/repro/configs/
# internlm2_1_8b.py: 24 layers, 16 heads and 8 KV heads of head_dim 128,
# d_model 2048), one 576 x (128, 2048) stack: the wide tensor-core kernel's
# (64 < p <= 128) main path for the fused step, the POGO update and the
# landing field, and (Landing under the watchdog) the CUDA-core tiled
# Newton-Schulz kernel's.
INTERNLM2 = {"q_proj": (24, 16, 128, 2048), "k_proj": (24, 8, 128, 2048)}
WIDE_SHAPE = (576, 128, 2048)
# starcoder2-15b's constrained q/k projections (src/repro/configs/
# starcoder2_15b.py: 40 layers, 48 heads and 4 KV heads of head_dim 128,
# d_model 6144), one 2080 x (128, 6144) stack, 6.54 GB, full width: past the
# n of row 9w's clusters, the streaming Newton-Schulz kernel's (row 9s) main
# path under fused Landing's watchdog (the wide kernel's Landing, row 2Lw).
STARCODER2 = {"q_proj": (40, 48, 128, 6144), "k_proj": (40, 4, 128, 6144)}
STREAM_SHAPE = (sum(layers * heads for layers, heads, _, _ in STARCODER2.values()),
                *STARCODER2["q_proj"][2:])
PLAIN_SLICE = 520  # matrices a plain Newton-Schulz call takes at the largest stack
# The paper's squared-unitary-PC sizes (src/repro/configs/pogo_paper.py:10,
# 1048 matrices of (10, n), n at the top of its 256-10000 range), real-valued
# (the port refuses complex groups): p < 25, where the planner sends the fused
# step (POGO and Landing), the POGO update and the landing field to the
# cluster kernel of small_p.cu. At n = 9998 (n % 4 != 0, a row stride TMA
# cannot take) all four keep the CUDA-core tiled kernels (rows 2, 2L, 6, 8).
PAPER_PC = {"pc": (1048, 10, 10000)}
PAPER_SHAPE = (1048, 10, 10000)
PAPER_PC_ODD = {"pc": (1048, 10, 9998)}
PAPER_ODD_SHAPE = (1048, 10, 9998)
# The paper's own sizes (src/repro/configs/pogo_paper.py), synthetic and not
# cut: the orthogonal CNN filters (:8), six leaves, three of them (256, 2304)
# (p > 128: the large route of csrc/large_p.cu; the others plan the whole
# kernel, the tensor-core kernel and its wide form), and O-ViT's 18 matrices
# of (1024, 1024) (:5).
CNN_FILTERS = [(64, 216), (256, 2304), (256, 2304), (256, 2304), (64, 576), (128, 1152)]
CNN = {f"conv{i}": (1, p, n) for i, (p, n) in enumerate(CNN_FILTERS)}
CNN_SHAPE = (3, 256, 2304)
OVIT = {"ovit": (18, 1024, 1024)}
OVIT_SHAPE = (18, 1024, 1024)
# The large route at n % 4 != 0 (a row stride TMA cannot take: the CUDA-core
# kernels, scalar loads, ragged 64-row tiles), and the tensor-core route's
# ragged case (p = 200 pads to 256, n to a last partial 128-column block).
LARGE_ODD = (5, 200, 901)
LARGE_TC_RAGGED = (5, 200, 904)
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "fused_step_whole": ("fused_step", "src/repro/kernels/fused_step.py:175"),
    "fused_step_tiled": ("fused_step", "src/repro/kernels/fused_step.py:608"),
    "fused_step_cluster": ("small_p", "src/repro/kernels/fused_step.py:608"),
    "pogo_update_whole": ("two_stage", "src/repro/kernels/pogo_update.py:64"),
    "pogo_update_tiled": ("two_stage", "src/repro/kernels/pogo_update.py:143"),
    "pogo_update_cluster": ("small_p", "src/repro/kernels/pogo_update.py:143"),
    "fused_step_cluster_landing": ("small_p", "src/repro/kernels/fused_step.py:559"),
    "landing_field_cluster": ("small_p", "src/repro/kernels/landing_field.py:79"),
    "landing_field": ("two_stage", "src/repro/kernels/landing_field.py:42"),
    "landing_field_tiled": ("two_stage", "src/repro/kernels/landing_field.py:79"),
    "pogo_update_tiled_tc": ("fused_step_tc", "src/repro/kernels/pogo_update.py:143"),
    "landing_field_tiled_tc": ("fused_step_tc", "src/repro/kernels/landing_field.py:79"),
    "landing_field_tiled_tc128": ("fused_step_tc", "src/repro/kernels/landing_field.py:79"),
    "newton_schulz": ("newton_schulz", "src/repro/kernels/newton_schulz.py:37"),
    "newton_schulz_tc": ("newton_schulz_tc", "src/repro/kernels/newton_schulz.py:37"),
    "newton_schulz_tc128": ("newton_schulz_tc", "src/repro/kernels/newton_schulz.py:37"),
    "newton_schulz_stream": ("newton_schulz_tc", "src/repro/kernels/newton_schulz.py:37"),
    "newton_schulz_cluster": ("small_p", "src/repro/kernels/newton_schulz.py:37"),
    "fused_step_whole_landing": ("fused_step", "src/repro/kernels/fused_step.py:164"),
    "fused_step_tiled_landing": ("fused_step", "src/repro/kernels/fused_step.py:559"),
    "fused_step_tiled_tc": ("fused_step_tc", "src/repro/kernels/fused_step.py:608"),
    "fused_step_tiled_tc_landing": ("fused_step_tc", "src/repro/kernels/fused_step.py:559"),
    "fused_step_tiled_tc128": ("fused_step_tc", "src/repro/kernels/fused_step.py:608"),
    "fused_step_tiled_tc128_landing": ("fused_step_tc", "src/repro/kernels/fused_step.py:559"),
    "pogo_update_tiled_tc128": ("fused_step_tc", "src/repro/kernels/pogo_update.py:143"),
    "tp_gram": ("tp_step", "src/repro/kernels/fused_step.py:304"),
    "tp_apply": ("tp_step", "src/repro/kernels/fused_step.py:417"),
    "flash_attention": ("flash_attention", "src/repro/kernels/flash_attention.py:88"),
    "flash_attention_tf32": ("flash_attention_tf32", "src/repro/kernels/flash_attention.py:88"),
    "flash_attention_tc": ("flash_attention_tc", "src/repro/kernels/flash_attention.py:88"),
    "fused_step_large": ("large_p", "src/repro/kernels/fused_step.py:608"),
    "fused_step_large_landing": ("large_p", "src/repro/kernels/fused_step.py:559"),
    "pogo_update_large": ("large_p", "src/repro/kernels/pogo_update.py:143"),
    "landing_field_large": ("large_p", "src/repro/kernels/landing_field.py:79"),
    "newton_schulz_large": ("large_p", "src/repro/kernels/newton_schulz.py:37"),
    "fused_step_large_tc": ("large_p", "src/repro/kernels/fused_step.py:608"),
    "fused_step_large_tc_landing": ("large_p", "src/repro/kernels/fused_step.py:559"),
    "pogo_update_large_tc": ("large_p", "src/repro/kernels/pogo_update.py:143"),
    "landing_field_large_tc": ("large_p", "src/repro/kernels/landing_field.py:79"),
    "newton_schulz_large_tc": ("large_p", "src/repro/kernels/newton_schulz.py:37"),
}
LANDING_LR = 0.25  # fixed-step Landing: max distance 7e-5 over 12 CPU steps
# POGO over Adam's distance is ||X X^T - I||_F formed directly in fp32 (the
# two-stage step's telemetry), so the iterate's own fp32 rounding (about an
# ulp an entry) shows in it, growing with sqrt(p n): at the CNN filters'
# (256, 2304) an H100 read 1.03e-5 to 1.38e-5 (the kernels and the plain
# route alike, lr 1e-3 and 3e-4), at O-ViT's (1024, 1024) 2.56e-5 to
# 2.80e-5 (an exact Stiefel draw rounded to fp32 reads 1.09e-5 there), so
# POGO's 1e-5 cannot hold. Its limit at the paper's sizes: 5e-5. The fused
# step's distance comes from the gram identity on C and keeps 1e-5.
PAPER_DIRECT_GRAM_LIMIT = 5e-5
TP_STEPS = 3  # per method on the two-rank TP path
NS_ITERS = 12
IDLE_CALLS = 100  # calls of each idle repair timed beside row 9's
NS_TOL = dict(atol=1e-6, rtol=0.0)  # tests/test_kernels.py:54-61
# The trainer phase: the launcher's defaults (src/repro_torch/launch/train.py)
# but POGO's lr. At the default 0.5 VAdam's unit-norm first step lands a
# q/k matrix ~3e-3 off the manifold (past the watchdog's soft 1e-3, so it
# would escalate and repair before any drift); 0.05 keeps the undrifted
# steps within the 1e-5 feasibility bound.
TRAIN_STEPS = 8
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_POGO_LR = 0.05
DRIFT_STEP = 5  # the q/k leaves are scaled by 1.5 just before this step
# The flops per matrix over p^2 n that each function needs. A p x p x n
# product takes 2 p^2 n, a symmetric gram (X X^T, M M^T, X' X'^T, Y Y^T)
# half of that: p^2 n for the tiles on and above the diagonal, as
# csrc/large_p.cu computes it. POGO's update and fused step: A = X X^T (1),
# B = X G^T (2), M's A G and B X (4), C = M M^T (1), C M (2); fused
# Landing: A, B, the step's A G and (lam (A - I) - B / 2) X (4), the
# distance's X' X'^T (1); the field: A, B, Lambda = A G / 2 + (lam (A - I)
# - B / 2) X, whose B X and A X share one product (4); a Newton-Schulz
# iteration: Y Y^T (1) and (Y Y^T) Y (2). The (p, p) products of POGO's
# distance are not counted. The tensor-core Newton-Schulz kernel's bound
# counts its own products (phase_newton_schulz).
FUSED_FLOPS = {"pogo": 10, "landing": 8}
TWO_STAGE_FLOPS = {"pogo_update": 10, "landing_field": 7}
NS_FLOPS = 3
# Serving. SmolLM-360M's prefill: 4 prompts of 2048 tokens. The flash
# kernels at that shape, (B, S, H, KV, hd); internlm2-1.8b's heads; S = 2000
# (not a multiple of the tiles); hd 24. fp32: tests/test_flash_kernel.py's
# tolerance.
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
FLASH_SHAPE = (PREFILL_BATCH, PREFILL_SEQ, 15, 5, 64)
FLASH_WIDE_SHAPE = (1, 2048, 16, 8, 128)
FLASH_F32_SHAPE = (2, 2000, 15, 5, 64)
FLASH_HD24_SHAPE = (2, 2000, 4, 2, 24)
# hd % 4 != 0: fp32 rows TMA cannot address, the CUDA-core kernel's route
# (no model here has such heads; the synthetic fp32 prefill at hd 62 is
# that kernel's main path).
PREFILL_ODD_HEAD_DIM = 62
FLASH_HD62_SHAPE = (PREFILL_BATCH, PREFILL_SEQ, 15, 5, PREFILL_ODD_HEAD_DIM)
FLASH_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 output per element: one output ulp (tests/test_torch_gpu.py's
# tolerance); 3e-2, tests/test_flash_kernel.py's bf16 tolerance against
# JAX, is printed beside it.
FLASH_BF16_TOL = dict(atol=1e-6, rtol=1 / 64)
FLASH_BF16_REFERENCE = 3e-2
# Prefill's last-position logits, kernel vs plain, over the largest |logit|
# (bf16, 32 layers), between the readings of benchmarks_torch/
# parity_readings.py on an H100: the kernel 1.71e-2, the training path's
# bf16 p 1.98e-2; key 0 dropped for the last row alone 3.25e-2 (argmax 2/4),
# the first key tile dropped 1.23.
PREFILL_REL_TOL = 2.5e-2
# The same in fp32 compute, set before its first reading: the CUDA-core
# kernel is within 2e-5 / 1e-4 of its plain version per element (fp32 sums
# in another order), 32 layers may grow that 10-100x; a dropped key moves
# the bf16 logits by 3.25e-2. An H100 read 3.66e-6.
PREFILL_F32_REL_TOL = 1e-3
# benchmarks/serve_bench.py's default geometry (_sizes, :63-66), and an
# overloaded pool of 24 blocks with swap preemption.
SERVE_ARGS = ["--arch", "smollm-360m", "--requests", "32", "--min-prompt-len", "8",
              "--prompt-len", "48", "--max-new", "16", "--slots", "8",
              "--blocks", "128", "--block-size", "16", "--prefill-chunk", "16"]
OVERLOAD_BLOCKS = 24
ORACLE_REQUESTS = 4


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _errors(got, want, tol):
    """(max abs, max rel, ok) over the outputs that exist; the relative
    error of an output is its max abs error over its largest magnitude."""
    import torch

    max_abs = max_rel = 0.0
    ok = True
    for a, b in zip(got[:4], want[:4]):
        if b is None:
            continue
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float(d.max() / b.abs().max().clamp_min(1e-30)))
        ok &= bool(torch.all(d <= tol["atol"] + tol["rtol"] * b.abs()))
    return max_abs, max_rel, ok


def _errors_by_output(got, want):
    """Max abs error of each fused-step output that exists: X', mu', nu' and
    the distance."""
    return {k: float((a - b).abs().max())
            for k, a, b in zip(("x", "mu", "nu", "dist"), got[:4], want[:4])
            if b is not None}


def _time_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def _row9_planned(p):
    """Inside the block ``ops.plan_newton_schulz`` gives row 9's tiled
    kernel at every shape, as it did before the tensor-core routes."""
    from repro_torch.kernels import ops

    planner, tile_n = ops.plan_newton_schulz, ops.ns_tiled_tile_n(p)
    ops.plan_newton_schulz = lambda p_, n: ("tiled", tile_n)
    try:
        yield
    finally:
        ops.plan_newton_schulz = planner


def _idle_in_turns(repair, p, calls=None):
    """Medians of ``calls`` timings of ``repair`` (an idle repair through
    ``ops.newton_schulz_repair``) as planned and with row 9 planned
    (``_row9_planned``), a call of each in turns whose order reverses every
    pair, after two calls of each. Each timing is one call from an idle
    card: a pair of CUDA events around it, the card synchronized before, so
    that it holds the host's work and the card's. The two differ by
    microseconds; medians of 20 calls in a row spread wider than that
    (an H100 read one route's 0.0717 and 0.1110 ms in two calls, and 9cl's
    0.1235 against row 9's 0.1111 in one)."""
    import torch

    def one(planned):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with contextlib.ExitStack() as stack:
            if not planned:
                stack.enter_context(_row9_planned(p))
            torch.cuda.synchronize()
            start.record()
            repair()
            end.record()
        return start, end

    for _ in range(2):
        one(True), one(False)
    pairs = {True: [], False: []}
    for i in range(calls or IDLE_CALLS):
        for planned in ((True, False) if i % 2 == 0 else (False, True)):
            pairs[planned].append(one(planned))
    torch.cuda.synchronize()
    return tuple(statistics.median(s.elapsed_time(e) for s, e in pairs[k])
                 for k in (True, False))


def _time_rotating(fns, rounds=3):
    """Medians of ``rounds`` timings of each ``(fn, calls)``, taken in turns
    whose order reverses every round."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in range(rounds):
        for j in (order if i % 2 == 0 else order[::-1]):
            fn, calls = fns[j]
            times[j].append(_time_ms(fn, calls))
    return [statistics.median(t) for t in times]


def _time_in_turns(kernel, plain, rounds=3):
    """Medians of the kernel (20 launches) and the plain version (10 calls),
    taken in turns: plain, kernel, kernel, plain, ..."""
    plain_ms, kernel_ms = _time_rotating([(plain, 10), (kernel, 20)], rounds)
    return kernel_ms, plain_ms


def _bound_ms(bytes_, flops, flop_per_s=FP32_FLOP_PER_S):
    """Least time for the work: the larger of its bytes over the HBM rate
    and its operations over their rate (fp32 unless given), and which one
    bounds it."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bound(b, p, n, base_kind, method, pieces=0):
    """One fused step: 5 HBM passes of the (B, p, n) fp32 operands (read X,
    g, mu; write X', mu') plus the per-matrix scalars, against the step's
    ``FUSED_FLOPS`` in fp32 on the CUDA cores, or (``pieces`` 3) as 3xTF32
    on the tensor cores."""
    passes = 5 if base_kind != "none" else 3
    scalars = (3 if base_kind == "vadam" else 1) * b * 4
    flops = FUSED_FLOPS[method] * p * p * n * b
    if pieces:
        return _bound_ms(passes * b * p * n * 4 + scalars, pieces * flops, TF32_TC_FLOP_PER_S)
    return _bound_ms(passes * b * p * n * 4 + scalars, flops)


def phase_tf32_probe(card):
    """One TF32 wgmma (``fused_step_tc.cu``'s probe): the register fragment
    and the shared-memory operands against a @ b^T on small integers (a
    wrong layout fails the run), then how the card reads an operand's low
    13 bits and rounds a sum, printed."""
    import torch

    from repro_torch.kernels import fused_step as fs

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-8, 9, (64, 8), generator=gen, device="cuda").float()
    b = torch.randint(-8, 9, (64, 8), generator=gen, device="cuda").float()
    exact = all(torch.equal(fs.tf32_probe(a, b, a_regs=r), a @ b.T) for r in (False, True))
    a, b = torch.zeros((64, 8), device="cuda"), torch.zeros((64, 8), device="cuda")
    a[:, 0], b[:, 0] = 1.0 + 0.75 * 2.0**-10, 1.0  # 0.75 of a TF32 ulp past 1
    op = {float(fs.tf32_probe(a, b, a_regs=r)[0, 0]) for r in (False, True)}
    a[:, 0], a[:, 1], b[:, 1] = 1.0, 1.5 * 2.0**-24, 1.0  # a sum 0.75 fp32 ulp past 1
    acc = {float(fs.tf32_probe(a, b, a_regs=r)[0, 0]) for r in (False, True)}
    reading = {1.0: "dropped (truncated)", 1.0 + 2.0**-10: "rounded to nearest"}
    summing = {1.0: "toward zero", 1.0 + 2.0**-23: "to nearest"}
    print(f"tf32 probe: fragment layout and operands exact {exact}; an operand's low 13 "
          f"bits {[reading.get(v, v) for v in sorted(op)]}; 1 + 0.75 ulp summed "
          f"{[summing.get(v, v) for v in sorted(acc)]} [{card}]", flush=True)
    if not exact:
        raise SystemExit("tf32 probe: the wgmma fragment layout or operands are wrong")


def _record(records, name, shape, rec):
    """A kernel's record takes its first shape timed; later shapes go under
    its ``by_shape``."""
    old = records.setdefault(name, {})
    if "ms" not in old:
        old.update(rec)
    else:
        old.setdefault("by_shape", {})["{}x({},{})".format(*shape)] = rec


def _operands(gen, b, p, n):
    import torch

    from repro_torch.core import stiefel

    x = stiefel.random_stiefel(gen, (b, p, n), device="cuda")
    g = 0.2 * torch.randn((b, p, n), generator=gen, device="cuda")
    mu = 0.1 * torch.randn((b, p, n), generator=gen, device="cuda")
    nu = torch.rand((b,), generator=gen, device="cuda")
    return x, g, mu, nu


def _ragged(gen, x, g, mu, p):
    """Per-matrix valid-row counts in [1, p] and the stacks zeroed past them."""
    import torch

    pv = torch.randint(1, p + 1, (x.shape[0],), generator=gen, device="cuda",
                       dtype=torch.int32)
    rows = torch.arange(p, device="cuda")[None, :, None] < pv[:, None, None]
    return pv, *(torch.where(rows, a, 0.0) for a in (x, g, mu))


def phase_fused_kernels(gen):
    """Each fused kernel, POGO and Landing branches, against the plain
    version at the main-path shapes (the first case of each kernel, timed):
    the whole kernels at 2048 x (16, 256), the tensor-core kernels at
    SmolLM's 640 x (64, 960) (every base, in place, ragged), the wide
    tensor-core kernels at internlm2-1.8b's 576 x (128, 2048) (every base,
    in place, ragged; plain loads at 7 x (72, 1002)), the CUDA-core tiled
    kernels at the paper's 1048 x (10, 9998) (their main path: trace
    first, the planner's tile) and at 1048 x (10, 10000), 576 x (128, 2048)
    and 640 x (64, 960), where they ran before the cluster and tensor-core
    kernels (checked here, and timed beside them), the cluster kernel's
    POGO and Landing entries at 1048 x (10, 10000) (every base, in place,
    ragged; Landing's also with a learning rate held on the card, bit for
    bit the host value's result), and the large route
    (p > 128): on the tensor cores
    at the paper's CNN filters 3 x (256, 2304) (every base, in place) and
    O-ViT 18 x (1024, 1024), ragged rows at ``LARGE_TC_RAGGED``, each timed
    beside the CUDA cores' large route (checked here too); on the CUDA
    cores at ``LARGE_ODD`` (n % 4 != 0). Each (kernel, shape) is timed
    at its first case that the planner picks it for; the first shape timed
    gives the kernel's record, later ones its ``by_shape``. Each output's
    error is printed apart: X', mu', nu' and the distance."""
    import torch

    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import large_p, ops, ref

    tc_shape = (640, 64, 960)
    cases = [  # (kernel, (B, p, n), base, hyper, variant)
        ("fused_step_whole", (2048, 16, 256), "trace", (0.9, False), ""),
        ("fused_step_whole", (256, 16, 256), "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_whole", (256, 16, 256), "none", (), ""),
        ("fused_step_tiled_tc", tc_shape, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled_tc", tc_shape, "trace", (0.9, False), ""),
        ("fused_step_tiled_tc", tc_shape, "trace", (0.9, True), ""),
        ("fused_step_tiled_tc", tc_shape, "vadam", (0.9, 0.999, 1e-8), "in place"),
        ("fused_step_tiled_tc", tc_shape, "trace", (0.9, False), "ragged"),
        ("fused_step_tiled_tc128", WIDE_SHAPE, "trace", (0.9, False), ""),
        ("fused_step_tiled_tc128", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled_tc128", WIDE_SHAPE, "trace", (0.9, True), ""),
        ("fused_step_tiled_tc128", WIDE_SHAPE, "none", (), ""),
        ("fused_step_tiled_tc128", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8), "in place"),
        ("fused_step_tiled_tc128", (140, 100, 300), "trace", (0.9, False), "ragged"),
        ("fused_step_tiled_tc128", (7, 72, 1002), "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled", PAPER_ODD_SHAPE, "trace", (0.9, False), ""),
        ("fused_step_cluster", PAPER_SHAPE, "trace", (0.9, False), ""),
        ("fused_step_cluster", PAPER_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_cluster", PAPER_SHAPE, "trace", (0.9, True), ""),
        ("fused_step_cluster", PAPER_SHAPE, "none", (), ""),
        ("fused_step_cluster", PAPER_SHAPE, "vadam", (0.9, 0.999, 1e-8), "in place"),
        ("fused_step_cluster", PAPER_SHAPE, "trace", (0.9, False), "ragged"),
        ("fused_step_tiled", PAPER_SHAPE, "trace", (0.9, False), ""),
        ("fused_step_tiled", WIDE_SHAPE, "trace", (0.9, False), ""),
        ("fused_step_tiled", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled", tc_shape, "trace", (0.9, False), ""),
    ]
    for b, p, n in ((2048, 16, 256), tc_shape):
        kind = ops.plan(p, n, "landing")[0]
        name = "fused_step_whole_landing" if kind == "whole" else "fused_step_tiled_tc_landing"
        for base, hyper in (("trace", (0.1, False)), ("none", ()),
                            ("trace", (0.5, True)), ("vadam", (0.9, 0.999, 1e-8))):
            cases.append((name, (b, p, n), base, hyper, ""))
    cases += [
        ("fused_step_tiled_tc_landing", tc_shape, "vadam", (0.9, 0.999, 1e-8), "in place"),
        ("fused_step_tiled_tc_landing", tc_shape, "trace", (0.1, False), "ragged"),
        ("fused_step_tiled_tc128_landing", WIDE_SHAPE, "trace", (0.1, False), ""),
        ("fused_step_tiled_tc128_landing", WIDE_SHAPE, "none", (), ""),
        ("fused_step_tiled_tc128_landing", WIDE_SHAPE, "trace", (0.5, True), ""),
        ("fused_step_tiled_tc128_landing", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled_tc128_landing", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8),
         "in place"),
        ("fused_step_tiled_tc128_landing", (140, 100, 300), "trace", (0.1, False), "ragged"),
        ("fused_step_tiled_tc128_landing", (7, 72, 1002), "trace", (0.1, False), ""),
        ("fused_step_tiled_landing", PAPER_ODD_SHAPE, "trace", (0.1, False), ""),
        ("fused_step_cluster_landing", PAPER_SHAPE, "trace", (0.1, False), ""),
        ("fused_step_cluster_landing", PAPER_SHAPE, "none", (), ""),
        ("fused_step_cluster_landing", PAPER_SHAPE, "trace", (0.5, True), ""),
        ("fused_step_cluster_landing", PAPER_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_cluster_landing", PAPER_SHAPE, "vadam", (0.9, 0.999, 1e-8), "in place"),
        ("fused_step_cluster_landing", PAPER_SHAPE, "trace", (0.1, False), "ragged"),
        ("fused_step_cluster_landing", PAPER_SHAPE, "trace", (0.1, False), "device eta"),
        ("fused_step_tiled_landing", PAPER_SHAPE, "trace", (0.1, False), ""),
        ("fused_step_tiled_landing", WIDE_SHAPE, "trace", (0.1, False), ""),
        ("fused_step_tiled_landing", WIDE_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
        ("fused_step_tiled_landing", tc_shape, "trace", (0.1, False), ""),
    ]
    for cc, main in (("fused_step_large", ("trace", (0.9, False))),
                     ("fused_step_large_landing", ("trace", (0.1, False)))):
        name = cc.replace("large", "large_tc")
        cases += [(cc, LARGE_ODD, *main, ""),  # n % 4 != 0: the CUDA cores' main path
                  (cc, LARGE_ODD, "vadam", (0.9, 0.999, 1e-8), "in place"),
                  (cc, LARGE_ODD, "trace", (0.9, False), "ragged"),
                  (name, CNN_SHAPE, *main, ""),
                  (name, CNN_SHAPE, "vadam", (0.9, 0.999, 1e-8), ""),
                  (name, CNN_SHAPE, "trace", (0.5, True), ""),
                  (name, CNN_SHAPE, "none", (), ""),
                  (name, CNN_SHAPE, "vadam", (0.9, 0.999, 1e-8), "in place"),
                  (name, LARGE_TC_RAGGED, "trace", (0.9, False), "ragged"),
                  (name, OVIT_SHAPE, *main, ""),
                  (name, OVIT_SHAPE, "vadam", (0.9, 0.999, 1e-8), "in place")]
    records = {}
    timed_at = set()
    for name, (b, p, n), base, hyper, variant in cases:
        landing = name.endswith("_landing")
        method = "landing" if landing else "pogo"
        x, g, mu, nu = _operands(gen, b, p, n)
        if landing:  # off the manifold, so that lam (A X - X) is visible
            x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        pv = None
        if variant == "ragged":
            pv, x, g, mu = _ragged(gen, x, g, mu, p)
        kw = dict(method=method, lam=1.0 if landing else 0.5,
                  base_kind=base, hyper=hyper,
                  mu=mu if base != "none" else None,
                  nu=nu if base == "vadam" else None,
                  count=torch.tensor(3, dtype=torch.int32, device="cuda"), pv=pv)
        tol = WHOLE_TOL if "whole" in name else TILED_TOL
        kind, tile_n = ops.plan(p, n, method)  # the kernel and tile the main path runs
        entry = name.removesuffix("_landing")
        planned = {"whole": "fused_step_whole",
                   "tc": "fused_step_tiled_tc" if p <= 64 else "fused_step_tiled_tc128",
                   "tiled": "fused_step_tiled", "cluster": "fused_step_cluster",
                   "large": "fused_step_large", "large_tc": "fused_step_large_tc"}[kind]
        if entry == "fused_step_tiled" and kind in ("tc", "cluster"):
            tile_n = ops.tiled_tile_n(p)  # where it ran before the tc or cluster kernel
        elif planned != entry:
            raise SystemExit(f"the planner picks {kind} for ({p}, {n}), not {name}")
        wrapper = getattr(fs, entry)
        if entry == "fused_step_tiled":
            wrapper = functools.partial(wrapper, tile_n=tile_n)
        want = ref.fused_group_step_ref(x, g, LR, **kw)
        torch.cuda.synchronize()
        before = getattr(fs, name).launches
        if variant == "in place":
            got = wrapper(x, g, LR, inplace=True, **kw)
            if got[0] is not x or (base != "none" and got[1] is not mu):
                raise SystemExit(f"{name} in place returned new tensors")
        elif variant == "device eta":
            got = wrapper(x, g, torch.tensor(LR, device="cuda"), **kw)
        else:
            got = wrapper(x, g, LR, **kw)
        if getattr(fs, name).launches != before + 1:
            raise SystemExit(f"{name} did not count its launch")
        torch.cuda.synchronize()
        note = ""
        if variant == "device eta":
            if not all(torch.equal(a, h) for a, h in zip(got[:4], wrapper(x, g, LR, **kw)[:4])
                       if a is not None):
                raise SystemExit(f"{name}: a device-held eta changed the result")
            note = "; bit for bit the host eta's"
        max_abs, max_rel, ok = _errors(got, want, tol)
        by_output = _errors_by_output(got, want)
        print(f"kernel {name} {b}x({p},{n}) {base}{hyper}{' ' + variant if variant else ''}: "
              f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (atol {tol['atol']}, rtol "
              f"{tol['rtol']}{note}) {'ok' if ok else 'MISMATCH'}; max_abs by output "
              f"{ {k: f'{v:.3e}' for k, v in by_output.items()} }", flush=True)
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
        if not variant and planned == entry and (name, (b, p, n)) not in timed_at:
            timed_at.add((name, (b, p, n)))
            tc = kind == "tc"
            timed = [(lambda: ref.fused_group_step_ref(x, g, LR, **kw), 10),
                     (lambda: wrapper(x, g, LR, **kw), 20)]
            if tc or kind == "cluster":  # the CUDA-core tiled kernel at the same call
                timed.append((lambda: fs.fused_step_tiled(
                    x, g, LR, tile_n=ops.tiled_tile_n(p), **kw), 20))
            elif kind == "large_tc":  # the CUDA-core large route, its route before
                cc_got = fs.fused_step_large(x, g, LR, **kw)
                torch.cuda.synchronize()
                cc_err, _, cc_ok = _errors(cc_got, want, tol)
                if not cc_ok:
                    raise SystemExit(f"fused_step_large at {(b, p, n)} disagrees")
                del cc_got
                timed.append((lambda: fs.fused_step_large(x, g, LR, **kw), 20))
            times = _time_rotating(timed)
            plain_ms, ms = times[:2]
            bound_ms, bound_by = _bound(b, p, n, base, method,
                                        pieces=3 if kind in ("tc", "large_tc") else 0)
            flops = FUSED_FLOPS[method] * p * p * n * b
            extra = f"; 3xTF32 tensor work {1e3 * 3 * flops / TF32_TC_FLOP_PER_S:.4f}"
            if tc:  # the sweeps' HBM passes (the wide kernel's pass 2 runs twice)
                passes = (10 if landing else 11.5) if p > 64 else (7 if landing else 9)
                floor_ms = 1e3 * passes * b * p * n * 4 / HBM_BYTES_PER_S
                extra += (f"; the schedule's {passes} passes {floor_ms:.4f}; fp32 CUDA cores "
                          f"{1e3 * flops / FP32_FLOP_PER_S:.4f}; the CUDA-core tiled kernel "
                          f"at this call {times[2]:.4f} ms")
            elif kind == "cluster":  # row 2 (2L) beside it, by its 9 (7) passes
                row, passes = ("2L", 7) if landing else ("2", 9)
                floor_ms = 1e3 * passes * b * p * n * 4 / HBM_BYTES_PER_S
                extra += (f"; cluster of {ops.small_p_cluster(p, n)}; row {row} (tile "
                          f"{ops.tiled_tile_n(p)}, {passes} passes {floor_ms:.4f}) at this "
                          f"call {times[2]:.4f} ms")
                _record(records, "fused_step_tiled" + ("_landing" if landing else ""), (b, p, n),
                        dict(ms=times[2], plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            elif kind in ("large", "large_tc"):  # its launches, the slices' sums included
                run = large_p.runner(x)
                wrapper(x, g, LR, runner=run, **kw)
                extra += f"; CUDA launches of large_p.cu a call {run.launches}"
            if kind == "large_tc":
                cc_bound = _bound(b, p, n, base, method)
                extra += (f"; fp32 CUDA cores {cc_bound[0]:.4f}; the CUDA-core large route "
                          f"at this call {times[2]:.4f} ms")
                _record(records, name.replace("_tc", ""), (b, p, n), dict(
                    max_abs_err=cc_err, ms=times[2], plain_ms=plain_ms,
                    bound_ms=cc_bound[0], bound_by=cc_bound[1]))
            print(f"  {name} {b}x({p},{n}) tile_n {tile_n} ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}{extra})", flush=True)
            _record(records, name, (b, p, n), dict(
                max_abs_err=max_abs, max_abs_err_by_output=by_output, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
        del x, g, mu, nu, got, want
    return records


def phase_tc_repeatability(gen, repeats=20):
    """Each tensor-core kernel launched ``repeats`` times on the same inputs
    at 640 x (64, 960) (the wide ones and Newton-Schulz's for p <= 128 at
    576 x (128, 2048), the streaming one, row 9s, at starcoder2-15b's 2080 x
    (128, 6144), the cluster kernels of small_p.cu, its four entries
    and Newton-Schulz's, at the paper's 1048 x (10, 10000); Newton-Schulz
    on the watchdog's drifted input, half
    the matrices masked off), each
    entry of the large route on the tensor cores at the CNN filters' 3 x
    (256, 2304) (its grams split n into slices there) and O-ViT's 18 x
    (1024, 1024), and on the CUDA cores at ``LARGE_ODD``, and the 3xTF32
    flash-attention kernel at the prefill's shape, every
    other launch beside a 1 GiB copy on a second
    stream that takes SMs and HBM from it: every output must equal the first
    launch's bit for bit. The kernels sum in a fixed order, so a difference
    is a race whose outcome depends on timing, which the CPU emulator
    cannot show."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import pogo_update as pu

    side = torch.cuda.Stream()
    big = torch.zeros(256 * 2**20, device="cuda")
    dst = torch.empty_like(big)

    def repeat(label, run):
        first = [None if t is None else t.clone() for t in run()]
        differ = 0
        for i in range(repeats):
            torch.cuda.synchronize()
            if i % 2:
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    dst.copy_(big)
            got = run()
            torch.cuda.synchronize()
            differ += sum(not torch.equal(a, f) for a, f in zip(got, first) if f is not None)
        print(f"kernel {label}: {repeats} launches, half beside a copy on another stream: "
              f"{differ} outputs differ from the first launch's", flush=True)
        if differ:
            raise SystemExit(f"{label} is not repeatable")

    large = (CNN_SHAPE, OVIT_SHAPE)  # the tensor-core large route; the CUDA cores' at LARGE_ODD
    for name, base, hyper, shape in (
            ("fused_step_tiled_tc", "vadam", (0.9, 0.999, 1e-8), (640, 64, 960)),
            ("fused_step_tiled_tc_landing", "trace", (0.1, False), (640, 64, 960)),
            ("fused_step_tiled_tc128", "vadam", (0.9, 0.999, 1e-8), WIDE_SHAPE),
            ("fused_step_tiled_tc128_landing", "trace", (0.1, False), WIDE_SHAPE),
            ("fused_step_cluster", "vadam", (0.9, 0.999, 1e-8), PAPER_SHAPE),
            ("fused_step_cluster_landing", "vadam", (0.9, 0.999, 1e-8), PAPER_SHAPE),
            *((name, "vadam", (0.9, 0.999, 1e-8), shape) for shape in large
              for name in ("fused_step_large_tc", "fused_step_large_tc_landing")),
            ("fused_step_large", "vadam", (0.9, 0.999, 1e-8), LARGE_ODD),
            ("fused_step_large_landing", "vadam", (0.9, 0.999, 1e-8), LARGE_ODD)):
        landing = name.endswith("_landing")
        x, g, mu, nu = _operands(gen, *shape)
        if landing:
            x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        kw = dict(method="landing" if landing else "pogo", lam=1.0 if landing else 0.5,
                  base_kind=base, hyper=hyper, mu=mu, nu=nu if base == "vadam" else None,
                  count=torch.tensor(3, dtype=torch.int32, device="cuda"))
        wrapper = getattr(fs, name.removesuffix("_landing"))
        repeat(f"{name} {shape[0]}x{shape[1:]} {base}",
               lambda: wrapper(x, g, LR, **kw)[:4])
        del x, g, mu, nu
    for shape, updates in (((640, 64, 960), (pu.pogo_update_tiled_tc, lf.landing_field_tiled_tc)),
                           (WIDE_SHAPE, (pu.pogo_update_tiled_tc128,
                                         lf.landing_field_tiled_tc128)),
                           (PAPER_SHAPE, (pu.pogo_update_cluster, lf.landing_field_cluster)),
                           *((shape, (pu.pogo_update_large_tc, lf.landing_field_large_tc))
                             for shape in large),
                           (LARGE_ODD, (pu.pogo_update_large, lf.landing_field_large))):
        x, g, _, _ = _operands(gen, *shape)
        x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        for update in updates:
            args = (LR, 0.5) if update.__name__.startswith("pogo") else (1.0,)
            repeat(f"{update.__name__} {shape[0]}x{shape[1:]}",
                   lambda: (update(x, g, *args),))
        del x, g
    for kernel, shape in ((ns.newton_schulz_tc, (640, 64, 960)),
                          (ns.newton_schulz_tc128, WIDE_SHAPE),
                          (ns.newton_schulz_stream, STREAM_SHAPE),
                          (ns.newton_schulz_cluster, PAPER_SHAPE),
                          *((ns.newton_schulz_large_tc, shape) for shape in large),
                          (ns.newton_schulz_large, LARGE_ODD)):
        # the watchdog's drift (a tenth of it at square matrices, as in
        # phase_newton_schulz), half the matrices masked off
        x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
        x += (0.005 if shape[1] == shape[2] else 0.05) * torch.randn(
            shape, generator=gen, device="cuda")
        mask = torch.arange(shape[0], device="cuda") % 2 == 0
        dist = torch.ones(shape[0], device="cuda")

        def ns_run():
            y, d = x.clone(), dist.clone()
            kernel(y, NS_ITERS, out=y, mask=mask, dist=d)
            return y, d

        repeat(f"{kernel.__name__} {shape[0]}x{shape[1:]}, half masked", ns_run)
        del x
    q, k, v = _flash_inputs(gen, FLASH_SHAPE, torch.float32)
    repeat(f"flash_attention_tf32 {FLASH_SHAPE} causal",
           lambda: (fa.flash_attention_tf32(q, k, v, causal=True, window=None),))
    del q, k, v, big, dst


def _tp_bound(name, b, p, n, base_kind="trace", method="pogo"):
    """``tp_gram``: read X, g (and mu), write Gb (and mu'), and the payload
    row; A = X X^T, a symmetric gram (p^2 n flops), and two p x p x n
    products (5 p^2 n flops). ``tp_apply``: read X,
    Gb and the payload, write X'; three p x p x n products (6 p^2 n) and
    the (p, p) algebra, 20 p^3 flops for POGO (10 products) and 26 p^3 for
    Landing (13)."""
    k = 3 * p * p + (base_kind == "vadam")
    if name == "tp_gram":
        passes = 5 if base_kind != "none" else 3
        return _bound_ms((passes * p * n + k) * b * 4, 5 * p * p * n * b)
    p3 = 20 if method == "pogo" else 26
    return _bound_ms((3 * p * n + k) * b * 4, (6 * p * p * n + p3 * p ** 3) * b)


def phase_tp_kernels(gen):
    """``tp_gram`` and ``tp_apply`` against their plain versions at a rank's
    block of the q/k stack at width 2, 640 x (64, 480) (the main path's
    shape, timed first), and of the many-matrices stack, 2048 x (16, 128).
    The payload is the sum of both halves' partials, as the all-reduce
    makes it; ``tp_apply`` runs POGO on the trace payload and Landing on
    the vadam one (with vadam's scalar)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tp_step as tp

    records = {}
    for b, p, n in ((640, 64, 480), (2048, 16, 128)):
        for base, hyper, method in (("trace", (0.9, False), "pogo"),
                                    ("vadam", (0.9, 0.999, 1e-8), "landing")):
            x, g, mu, nu = _operands(gen, b, p, 2 * n)
            x += 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
            h = {k: v[..., :n].contiguous() for k, v in (("x", x), ("g", g), ("mu", mu))}
            other = ref.tp_partial_ref(x[..., n:], g[..., n:], base_kind=base,
                                       hyper=hyper, mu=mu[..., n:])[0]
            gkw = dict(base_kind=base, hyper=hyper, post_scale=1.0, mu=h["mu"])
            gtile = ops.plan_tp("tp_gram", p, ops.tp_gram_smem_bytes)
            got = tp.tp_gram(h["x"], h["g"], tile_n=gtile, **gkw)
            torch.cuda.synchronize()
            want = ref.tp_partial_ref(h["x"], h["g"], **gkw)
            err_g, _, ok_g = _errors(got, want, TILED_TOL)
            payload = want[0] + other
            scl = None
            if base == "vadam":
                scl = ref.tp_scale_ref(payload, p, hyper=hyper, post_scale=1.0, nu=nu,
                                       count=torch.tensor(3, device="cuda"))[0].contiguous()
            atile = ops.plan_tp("tp_apply", p, ops.tp_apply_smem_bytes)
            akw = dict(method=method, lam=0.5 if method == "pogo" else 1.0)
            got_a = tp.tp_apply(h["x"], want[1], payload, LR, scl, tile_n=atile, **akw)
            torch.cuda.synchronize()
            want_a = ref.tp_apply_ref(h["x"], want[1], payload, LR, scl, **akw)
            err_a, _, ok_a = _errors(got_a, want_a, TILED_TOL)
            print(f"kernel tp_gram {b}x({p},{n}) {base} tile_n {gtile}: max_abs "
                  f"{err_g:.3e}; tp_apply {method} tile_n {atile}: max_abs {err_a:.3e}, "
                  f"distance {float(got_a[1].max()):.3e} (atol {TILED_TOL['atol']}, rtol "
                  f"{TILED_TOL['rtol']}) {'ok' if ok_g and ok_a else 'MISMATCH'}",
                  flush=True)
            if not (ok_g and ok_a):
                raise SystemExit("a TP kernel disagrees with its plain version")
            for name, err in (("tp_gram", err_g), ("tp_apply", err_a)):
                rec = records.setdefault(name, {})
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
            if "ms" in records["tp_gram"]:
                continue
            ms_g, plain_g = _time_in_turns(
                lambda: tp.tp_gram(h["x"], h["g"], tile_n=gtile, **gkw),
                lambda: ref.tp_partial_ref(h["x"], h["g"], **gkw))
            ms_a, plain_a = _time_in_turns(
                lambda: tp.tp_apply(h["x"], want[1], payload, LR, scl, tile_n=atile,
                                    **akw),
                lambda: ref.tp_apply_ref(h["x"], want[1], payload, LR, scl, **akw))
            bg, byg = _tp_bound("tp_gram", b, p, n, base)
            ba, bya = _tp_bound("tp_apply", b, p, n, base, method)
            print(f"  tp_gram {b}x({p},{n}) ms {ms_g:.4f} plain_ms {plain_g:.4f} "
                  f"bound_ms {bg:.4f} ({byg}); tp_apply {method} ms {ms_a:.4f} "
                  f"plain_ms {plain_a:.4f} bound_ms {ba:.4f} ({bya})", flush=True)
            records["tp_gram"].update(ms=ms_g, plain_ms=plain_g, bound_ms=bg, bound_by=byg)
            records["tp_apply"].update(ms=ms_a, plain_ms=plain_a, bound_ms=ba, bound_by=bya)
            del x, g, mu, nu, h, got, want, got_a, want_a, payload
    return records


def phase_two_stage_kernels(gen):
    """Each two-stage kernel against its plain version at its main-path
    shape, on the planner's route, timed with its bound: the whole kernels
    at 2048 x (16, 256), the tensor-core entries at SmolLM's 640 x (64, 960)
    and the wide ones at internlm2-1.8b's 576 x (128, 2048) (each timed
    beside the CUDA-core tiled kernel, their route there before, checked at
    the same call: the field at tile 64, POGO's update at tile 16), the
    cluster POGO update and field at the paper's 1048 x (10, 10000) (beside
    rows 6 and 8, checked at the same call), the CUDA-core tiled kernels at
    1048 x (10, 9998), the large
    route on the tensor cores at the CNN filters' 3 x (256, 2304) and
    O-ViT's 18 x (1024, 1024) (both timed, each beside the CUDA cores'
    large route, checked at the same call) and on the CUDA cores at
    ``LARGE_ODD``. Then every kernel at a ragged shape, 7 x (10, 250) (the
    wide ones at 7 x (100, 250), the large ones at (3, 136, 203) and
    ``LARGE_TC_RAGGED``, the cluster ones at 7 x (10, 2000)), the
    tensor-core entries also at 7 x (64, 250) (plain loads), POGO's in
    place and with a learning rate held on the card (bit for bit the host
    value's result; the cluster one's too). X is a Stiefel draw plus 0.01
    randn, and each check first shows that dropping lam's term would break
    the tolerance."""
    import torch

    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import large_p, ops, ref
    from repro_torch.kernels import pogo_update as pu

    tc_shape = (640, 64, 960)
    main = {"pogo_update_whole": (2048, 16, 256), "landing_field": (2048, 16, 256),
            "pogo_update_tiled_tc": tc_shape, "landing_field_tiled_tc": tc_shape,
            "pogo_update_tiled_tc128": WIDE_SHAPE, "landing_field_tiled_tc128": WIDE_SHAPE,
            "pogo_update_tiled": PAPER_ODD_SHAPE, "landing_field_tiled": PAPER_ODD_SHAPE,
            "pogo_update_cluster": PAPER_SHAPE, "landing_field_cluster": PAPER_SHAPE,
            "pogo_update_large": LARGE_ODD, "landing_field_large": LARGE_ODD,
            "pogo_update_large_tc": CNN_SHAPE, "landing_field_large_tc": CNN_SHAPE}
    ragged = {"tc128": (7, 100, 250), "large": (3, 136, 203), "large_tc": LARGE_TC_RAGGED,
              "cluster": (7, 10, 2000)}
    cases = [(name, shape, "") for name, shape in main.items()]
    cases += [("pogo_update_large_tc", OVIT_SHAPE, ""),
              ("landing_field_large_tc", OVIT_SHAPE, "")]
    cases += [(name, ragged.get(name.removeprefix("pogo_update_").removeprefix(
        "landing_field_").removeprefix("tiled_"), (7, 10, 250)), "ragged") for name in main]
    cases += [("pogo_update_tiled_tc", (7, 64, 250), "ragged"),
              ("landing_field_tiled_tc", (7, 64, 250), "ragged"),
              ("pogo_update_cluster", PAPER_SHAPE, "in place"),
              ("pogo_update_cluster", PAPER_SHAPE, "device eta"),
              ("pogo_update_tiled_tc", tc_shape, "in place"),
              ("pogo_update_tiled_tc", tc_shape, "device eta"),
              ("pogo_update_tiled_tc128", WIDE_SHAPE, "in place"),
              ("pogo_update_tiled_tc128", WIDE_SHAPE, "device eta"),
              ("pogo_update_large", LARGE_ODD, "in place"),
              ("pogo_update_large_tc", CNN_SHAPE, "in place"),
              ("pogo_update_large_tc", CNN_SHAPE, "device eta")]
    records = {}
    for name, shape, variant in cases:
        pogo = name.startswith("pogo")
        mod = pu if pogo else lf
        tiled_bytes = ops.pogo_tiled_smem_bytes if pogo else ops.landing_tiled_smem_bytes
        b, p, n = main[name]
        kind, tile_n = (ops.plan_pogo_update if pogo else ops.plan_landing_field)(p, n)
        stem = "pogo_update" if pogo else "landing_field"
        planned = {"whole": "pogo_update_whole" if pogo else "landing_field",
                   "tc": f"{stem}_tiled_tc" + ("128" if p > 64 else ""),
                   "tiled": f"{stem}_tiled", "cluster": f"{stem}_cluster",
                   "large": f"{stem}_large", "large_tc": f"{stem}_large_tc"}[kind]
        if planned != name:
            raise SystemExit(f"the planner picks {kind} for ({p}, {n}), not {name}")
        wrapper = getattr(mod, name)
        if kind == "tiled":
            wrapper = functools.partial(wrapper, tile_n=tile_n)
        if pogo:
            def run(x, g, wrapper=wrapper, eta=LR, **kw):
                return wrapper(x, g, eta, 0.5, **kw)

            def plain(x, g, lam=0.5):
                return ref.pogo_update_ref(x, g, LR, lam)
        else:
            def run(x, g, wrapper=wrapper, **kw):
                return wrapper(x, g, 1.0, **kw)

            def plain(x, g, lam=1.0):
                return ref.landing_field_ref(x, g, lam)
        tol = TWO_STAGE_TILED_TOL if kind != "whole" else TWO_STAGE_WHOLE_TOL
        x, g, _, _ = _operands(gen, *shape)
        # Off the manifold, so that lam's term (the land stage's
        # lam (M M^T - I) M, the field's lam (A X - X)) is visible.
        x += 0.01 * torch.randn(shape, generator=gen, device="cuda")
        want = plain(x, g)
        without = plain(x, g, lam=0.0)
        if _errors((without,), (want,), tol)[2]:
            raise SystemExit(f"{name} {shape}: the check cannot see lam's term")
        torch.cuda.synchronize()
        before = getattr(mod, name).launches
        if variant == "in place":
            got = run(x, g, inplace=True)
            if got is not x:
                raise SystemExit(f"{name} in place returned a new tensor")
        elif variant == "device eta":
            got = run(x, g, eta=torch.tensor(LR, device="cuda"))
        else:
            got = run(x, g)
        torch.cuda.synchronize()
        if getattr(mod, name).launches != before + 1:
            raise SystemExit(f"{name} did not count its launch")
        note = ""
        if variant == "device eta":
            if not torch.equal(got, run(x, g)):
                raise SystemExit(f"{name}: a device-held eta changed the result")
            note = "; bit for bit the host eta's"
        max_abs, max_rel, ok = _errors((got,), (want,), tol)
        print(f"kernel {name} {shape[0]}x{shape[1:]}{' ' + variant if variant else ''} "
              f"{kind} tile_n {tile_n}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} (atol "
              f"{tol['atol']}, rtol {tol['rtol']}; lam's term up to "
              f"{float((want - without).abs().max()):.1e}{note}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version")
        if variant:
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], max_abs)
            del x, g, got, want, without
            continue
        # The main-path shape comes first (and the large route's O-ViT):
        # timed, with its bound (read X and G, write one result).
        b, p, n = shape
        flops = TWO_STAGE_FLOPS[stem] * p * p * n * b
        timed = [(lambda: plain(x, g), 10), (lambda: run(x, g), 20)]
        extra = f"; 3xTF32 tensor work {1e3 * 3 * flops / TF32_TC_FLOP_PER_S:.4f}"
        if kind in ("tc", "cluster"):  # the CUDA-core tiled kernel at the same call
            cc = functools.partial(getattr(mod, f"{stem}_tiled"),
                                   tile_n=ops.two_stage_tile_n(p, tiled_bytes))
            cc_out = run(x, g, wrapper=cc)
            torch.cuda.synchronize()
            cc_err, _, cc_ok = _errors((cc_out,), (want,), tol)
            if not cc_ok:
                raise SystemExit(f"{stem}_tiled at {shape} disagrees")
            timed.append((lambda: run(x, g, wrapper=cc), 20))
            if kind == "tc":
                bound_ms, bound_by = _bound_ms(3 * b * p * n * 4, 3 * flops, TF32_TC_FLOP_PER_S)
            else:
                bound_ms, bound_by = _bound_ms(3 * b * p * n * 4, flops)
        elif kind == "large_tc":  # the CUDA-core large route, its route before
            cc = getattr(mod, f"{stem}_large")
            cc_err, _, cc_ok = _errors((run(x, g, wrapper=cc),), (want,), tol)
            torch.cuda.synchronize()
            if not cc_ok:
                raise SystemExit(f"{stem}_large at {shape} disagrees")
            timed.append((lambda: run(x, g, wrapper=cc), 20))
            bound_ms, bound_by = _bound_ms(3 * b * p * n * 4, 3 * flops, TF32_TC_FLOP_PER_S)
        else:
            bound_ms, bound_by = _bound_ms(3 * b * p * n * 4, flops)
        times = _time_rotating(timed)
        plain_ms, ms = times[:2]
        if kind == "tc":  # the sweeps' HBM passes (the wide kernel's pass 2 runs twice)
            passes = (9.5 if p > 64 else 7) if pogo else (7 if p > 64 else 5)
            extra += (f"; bytes, 3 passes {1e3 * 3 * b * p * n * 4 / HBM_BYTES_PER_S:.4f}; "
                      f"the schedule's {passes} passes "
                      f"{1e3 * passes * b * p * n * 4 / HBM_BYTES_PER_S:.4f}; fp32 CUDA cores "
                      f"{1e3 * flops / FP32_FLOP_PER_S:.4f}; the CUDA-core tiled kernel at "
                      f"this call {times[2]:.4f} ms")
        elif kind == "cluster":  # row 6 (8) beside it, by its 7 (5) passes
            row, passes = ("6", 7) if pogo else ("8", 5)
            extra = (f"; cluster of {ops.small_p_cluster(p, n)}; row {row} (tile "
                     f"{ops.two_stage_tile_n(p, tiled_bytes)}, {passes} passes "
                     f"{1e3 * passes * b * p * n * 4 / HBM_BYTES_PER_S:.4f}) at this call "
                     f"{times[2]:.4f} ms")
            _record(records, f"{stem}_tiled", shape, dict(
                max_abs_err=cc_err, ms=times[2], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by))
        elif kind in ("large", "large_tc"):  # its launches, the slices' sums included
            counted = large_p.runner(x)
            run(x, g, runner=counted)
            extra += f"; CUDA launches of large_p.cu a call {counted.launches}"
        if kind == "large_tc":
            cc_bound = _bound_ms(3 * b * p * n * 4, flops)
            extra += (f"; fp32 CUDA cores {cc_bound[0]:.4f}; the CUDA-core large route at this "
                      f"call {times[2]:.4f} ms")
            _record(records, f"{stem}_large", shape, dict(
                max_abs_err=cc_err, ms=times[2], plain_ms=plain_ms, bound_ms=cc_bound[0],
                bound_by=cc_bound[1]))
        print(f"  {name} {b}x({p},{n}) ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({bound_by}{extra})", flush=True)
        _record(records, name, shape, dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                           bound_ms=bound_ms, bound_by=bound_by))
        del x, g, got, want, without
    return records


def phase_newton_schulz(gen):
    """Each Newton-Schulz kernel against the plain version on the watchdog's
    input, 1.5 x Stiefel + 0.05 randn, 12 iterations, with half the
    matrices masked off (they must come out bit-unchanged, distances too),
    through the planner: at the trainer's 640 x (64, 960) (the tensor-core
    kernel, a cluster of two CTAs a matrix), 1048 x (10, 9998) (row 9's
    tiled kernel, whose main path the paper's stack at n % 4 != 0 is: its
    record's shape), the paper's unitary-PC 1048 x
    (10, 10000) (row 9cl, the cluster kernel of ``small_p.cu``; row 9's
    tiled kernel, its route before, is held against the plain version and
    timed beside it, and the idle repair must stay within 0.01 ms of row
    9's through the same entry), internlm2-1.8b's 576 x
    (128, 2048) (the tensor-core kernel for p <= 128, 16 CTAs a matrix, row
    9w; row 9's tiled kernel, its route before, is held against the plain
    version and timed beside it), starcoder2-15b's 2080 x (128, 6144) (row
    9s, the streaming kernel; row 9's tiled kernel, its route before, is
    held against the plain version and timed beside it, the idle repair
    too; the plain version in slices of ``PLAIN_SLICE`` matrices, fewer
    calls timed, the peak device memory printed), 2048 x (16, 256) (whole),
    ``LARGE_ODD`` (the CUDA cores' large route), the CNN filters' 3 x (256,
    2304) and O-ViT's 18 x (1024, 1024) (the tensor cores' large route)
    and 7 x (10, 250); then timed unmasked at the others, each beside the
    repair with no matrix past the threshold (the watchdog's launch on
    every step), the tensor-core kernels in turns with the kernel that
    planned at their shape before and the plain version. A square matrix
    takes a tenth of the noise: 0.05 randn gives a (1024, 1024) one
    singular values near 0, from which 12 iterations after the Frobenius
    prescale do not converge, in the plain version either (an H100 read
    ||Y Y^T - I||_F 8.297 from both)."""
    import torch

    from repro_torch.core import stiefel
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import large_p, ops, ref
    from repro_torch.kernels import newton_schulz as ns

    records = {}
    counters = (ns.newton_schulz_tc, ns.newton_schulz_tc128, ns.newton_schulz_large,
                ns.newton_schulz_large_tc, ns.newton_schulz_cluster, ns.newton_schulz_stream)
    untimed = ((7, 10, 250),)
    for shape in ((640, 64, 960), PAPER_ODD_SHAPE, PAPER_SHAPE, WIDE_SHAPE, STREAM_SHAPE,
                  (2048, 16, 256), LARGE_ODD, CNN_SHAPE, OVIT_SHAPE, *untimed):
        b, p, n = shape
        big = shape == STREAM_SHAPE
        torch.cuda.reset_peak_memory_stats()
        x = 1.5 * stiefel.random_stiefel(gen, shape, device="cuda")
        x += (0.005 if p == n else 0.05) * torch.randn(shape, generator=gen, device="cuda")
        dist = torch.where(torch.arange(b, device="cuda") % 2 == 0, 2.0, 0.0).float()
        x0, d0 = x.clone(), dist.clone()
        kind, tile_n = ops.plan_newton_schulz(p, n)
        name = {"tc": "newton_schulz_tc", "tc128": "newton_schulz_tc128",
                "large": "newton_schulz_large", "large_tc": "newton_schulz_large_tc",
                "cluster": "newton_schulz_cluster",
                "stream": "newton_schulz_stream"}.get(kind, "newton_schulz")
        before = [c.launches for c in counters]
        rep = ops.newton_schulz_repair(x, dist, torch.tensor(0.1, device="cuda"),
                                       NS_ITERS)
        torch.cuda.synchronize()
        if [c.launches - k for c, k in zip(counters, before)] != [
                kind == "tc", kind == "tc128", kind == "large", kind == "large_tc",
                kind == "cluster", kind == "stream"]:
            raise SystemExit(f"newton_schulz {shape}: the planned {kind} kernel did not launch")
        want = _plain_ns(x0[rep])
        want_d = ref.manifold_distance_ref(want)
        max_abs, _, ok = _errors((x[rep],), (want,), NS_TOL)
        kept = torch.equal(x[~rep], x0[~rep]) and torch.equal(dist[~rep], d0[~rep])
        print(f"kernel newton_schulz_{kind} {b}x({p},{n}) tile_n {tile_n}: repaired "
              f"{int(rep.sum())}, max_abs {max_abs:.3e} (atol {NS_TOL['atol']}), "
              f"distance kernel {float(dist[rep].max()):.3e} plain "
              f"{float(want_d.max()):.3e}, max |kernel - plain| "
              f"{float((dist[rep] - want_d).abs().max()):.3e}, masked-off bit-unchanged "
              f"{kept} {'ok' if ok and kept else 'MISMATCH'}", flush=True)
        if not (ok and kept and int(rep.sum()) == (b + 1) // 2
                and float(dist[rep].max()) < 1e-2):
            raise SystemExit(f"newton_schulz {shape} disagrees with its plain version")
        rec = records.setdefault(name, {})
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), max_abs)
        if shape in untimed:
            continue
        out = torch.empty_like(x0)
        wrapper = getattr(ns, f"newton_schulz_{kind}")
        if kind == "tiled":
            wrapper = functools.partial(wrapper, tile_n=tile_n)
        del want, want_d
        calls = 2 if big else 10  # the plain version's and row 9's calls a round
        timed = [(lambda: _plain_ns(x0), calls),
                 (lambda: wrapper(x0, NS_ITERS, out=out), 5 if big else 20)]
        if kind in ("tc", "tc128", "cluster", "stream"):  # row 9's tiled kernel, its route before
            cc_tile = ops.ns_tiled_tile_n(p)
            cc = functools.partial(ns.newton_schulz_tiled, tile_n=cc_tile)
            max_cc, _, ok_cc = _errors((cc(x0, NS_ITERS, out=out),), (_plain_ns(x0),), NS_TOL)
            if not ok_cc:
                raise SystemExit(f"newton_schulz_tiled at {shape} disagrees ({max_cc:.3e})")
            timed.append((lambda: cc(x0, NS_ITERS, out=out), calls if big else 20))
        elif kind == "large_tc":  # the CUDA-core large route, its route before
            max_cc, _, ok_cc = _errors((ns.newton_schulz_large(x0, NS_ITERS),),
                                       (ref.newton_schulz_ref(x0, NS_ITERS),), NS_TOL)
            if not ok_cc:
                raise SystemExit(f"newton_schulz_large at {shape} disagrees ({max_cc:.3e})")
            timed.append((lambda: ns.newton_schulz_large(x0, NS_ITERS, out=out), 20))
        times = _time_rotating(timed)
        plain_ms, ms = times[:2]
        # Read X, write Y; NS_FLOPS p^2 n an iteration. On the tensor cores
        # the update takes 3 TF32 products, the symmetric gram 2 (G = U + U^T).
        flops = NS_FLOPS * NS_ITERS * p * p * n * b
        if kind in ("tc", "tc128", "stream"):
            tc_flops = (2 + 3) * 2 * NS_ITERS * p * p * n * b
            bound_ms, bound_by = _bound_ms(2 * b * p * n * 4, tc_flops, TF32_TC_FLOP_PER_S)
        elif kind == "large_tc":  # every product 3xTF32
            bound_ms, bound_by = _bound_ms(2 * b * p * n * 4, 3 * flops, TF32_TC_FLOP_PER_S)
        else:
            bound_ms, bound_by = _bound_ms(2 * b * p * n * 4, flops)
        idle, thresh = torch.zeros(b, device="cuda"), torch.tensor(0.1, device="cuda")

        def idle_repair():
            ops.newton_schulz_repair(x0, idle, thresh, NS_ITERS)

        extra = ""
        if kind in ("tc", "tc128", "cluster", "stream"):  # row 9's idle repair, the same entry
            ops.reset_launches()
            idle_ms, idle_cc = _idle_in_turns(idle_repair, p)
            if ops.launches()["newton_schulz_tiled"] != 2 + IDLE_CALLS:
                raise SystemExit(f"newton_schulz {shape}: row 9's idle repair did not run")
            cc_bound = _bound_ms(2 * b * p * n * 4, flops)
            extra = (f"; the CUDA-core tiled kernel at this call {times[2]:.4f} ms (tile "
                     f"{cc_tile}; fp32 CUDA cores {cc_bound[0]:.4f}), its "
                     f"repair with no matrix past the threshold {idle_cc:.4f} ms")
            if kind != "cluster":
                extra = "; 3xTF32 tensor work (the gram 2 TF32 products, the update 3)" + extra
            if big:
                extra += (f"; 2 HBM passes {1e3 * 8 * b * p * n / HBM_BYTES_PER_S:.4f} ms, "
                          f"{2 * NS_ITERS + 1} passes "
                          f"{1e3 * (2 * NS_ITERS + 1) * 4 * b * p * n / HBM_BYTES_PER_S:.4f}")
        else:
            idle_ms = _time_ms(idle_repair, 20)
        if kind == "cluster":  # row 9's reading here, the planner's rule, the grid
            c = ops.ns_cluster(p, n)
            extra += (f"; clusters of {c} CTAs, "
                      f"{fs.cluster_lib().ns_cluster_max_clusters(p, n, c)} resident at once")
            _record(records, "newton_schulz", shape, dict(
                max_abs_err=max_cc, ms=times[2], plain_ms=plain_ms, bound_ms=cc_bound[0],
                bound_by=cc_bound[1]))
            if not (ms < times[2] and idle_ms <= idle_cc + 0.01):
                raise SystemExit(f"newton_schulz_cluster at {shape}: {ms:.4f} ms, idle "
                                 f"{idle_ms:.4f}, against row 9's {times[2]:.4f} / "
                                 f"{idle_cc:.4f}: the planner's rule no longer holds")
        if kind in ("tc128", "stream"):  # row 9's reading here, the planner's rule, the grid
            if kind == "tc128":
                extra += (f"; clusters of {ops.ns_tc128_cluster(n)} CTAs, "
                          f"{ns.tc_lib().ns_tc128_max_clusters(n)} resident at once")
            else:
                extra += f"; one CTA a matrix, {ns.tc_lib().ns_stream_max_clusters()} at once"
            _record(records, "newton_schulz", shape, dict(
                max_abs_err=max_cc, ms=times[2], plain_ms=plain_ms, bound_ms=cc_bound[0],
                bound_by=cc_bound[1]))
            if not (ms < times[2] and idle_ms <= idle_cc + 0.1):
                raise SystemExit(f"newton_schulz_{kind} at {shape}: {ms:.4f} ms, idle "
                                 f"{idle_ms:.4f}, against row 9's {times[2]:.4f} / "
                                 f"{idle_cc:.4f}: the planner's rule no longer holds")
        elif kind in ("large", "large_tc"):  # its launches, the n-slices' sums included
            counted = large_p.runner(x0)
            wrapper(x0, NS_ITERS, out=out, runner=counted)
            extra = (f"; 3xTF32 tensor work {1e3 * 3 * flops / TF32_TC_FLOP_PER_S:.4f}; CUDA "
                     f"launches of large_p.cu a call {counted.launches}")
        if kind == "large_tc":  # the CUDA-core route's repair, from C and from Python
            y, none = x0.clone(), torch.zeros(b, dtype=torch.bool, device="cuda")
            idle_cc = _time_ms(lambda: ns.newton_schulz_large(y, NS_ITERS, out=y, mask=none), 20)
            idle_py = _time_ms(lambda: _ns_python_loop(y, NS_ITERS, none), 20)
            if not torch.equal(y, x0):
                raise SystemExit(f"newton_schulz {shape}: an idle repair wrote a matrix")
            cc_bound = _bound_ms(2 * b * p * n * 4, flops)
            extra += (f"; fp32 CUDA cores {cc_bound[0]:.4f}; the CUDA-core large route at this "
                      f"call {times[2]:.4f} ms, its idle repair {idle_cc:.4f} ms (as PR 21's "
                      f"Python loop issued it: {idle_py:.4f} ms)")
            _record(records, "newton_schulz_large", shape, dict(
                max_abs_err=max_cc, ms=times[2], plain_ms=plain_ms, bound_ms=cc_bound[0],
                bound_by=cc_bound[1]))
        if big:
            extra += (f"; peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
                      f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
        print(f"  newton_schulz_{kind} {b}x({p},{n}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}); repair with no matrix past the "
              f"threshold {idle_ms:.4f} ms{extra}", flush=True)
        if kind != "whole":
            _record(records, name, shape, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                               bound_by=bound_by))
        del x, x0, out
    return records


def _plain_ns(x):
    """``ref.newton_schulz_ref`` at ``NS_ITERS``, in slices of ``PLAIN_SLICE``
    matrices where the stack is as large as starcoder2-15b's (its
    temporaries at once would take several stacks of device memory)."""
    import torch

    from repro_torch.kernels import ref

    if x.numel() < STREAM_SHAPE[1] * STREAM_SHAPE[2] * STREAM_SHAPE[0]:
        return ref.newton_schulz_ref(x, NS_ITERS)
    return torch.cat([ref.newton_schulz_ref(x[i:i + PLAIN_SLICE], NS_ITERS)
                      for i in range(0, x.shape[0], PLAIN_SLICE)])


def _ns_python_loop(x, iters, mask):
    """The CUDA-core large route's Newton-Schulz repair in place as its
    Python loop issued it before the loop moved into one C call (a gram
    and an apply an iteration, from Python)."""
    import torch

    from repro_torch.kernels import large_p

    run = large_p.runner(x)
    tmp = torch.empty_like(x)
    src = x
    for k in range(1, iters + 1):
        dst = x if (iters - k) % 2 == 0 else tmp
        gm = large_p.gram(run, src, mask=mask)[0]
        large_p.apply(run, "ns", gm, src, dst, scal=None, mask=mask, first=k == 1)
        src = dst
    return x


def phase_large_crossovers(gen):
    """The readings behind the planner's rules around p = 128: the field and
    Newton-Schulz at 576 x (129, 2048) and (136, 2048) and the field at 576
    x (160, 2048), where the CUDA-core tiled kernels' grams still fit a
    block, each timed in turns with the large route on the tensor cores
    (planned there) and on the CUDA cores (PR 21's); and Newton-Schulz at
    internlm2-1.8b's 576 x (128, 2048) and at 576 x (72, 2048) and (96,
    2048), where the tensor-core kernel for p <= 128 (row 9w) is planned,
    beside row 9's tiled kernel and the tensor-core large route on the
    drift step and as the idle repair (every matrix masked off):
    ``ops.plan_newton_schulz`` takes a route from row 9 at p <= 128 only
    where it is faster on the drift step and its idle repair costs at most
    0.1 ms more. Every route is checked against the plain version first."""
    import torch

    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import ops, ref

    for label, shape in (("landing field", (576, 129, 2048)),
                         ("landing field", (576, 136, 2048)),
                         ("landing field", (576, 160, 2048)),
                         ("newton-schulz", (576, 129, 2048)),
                         ("newton-schulz", (576, 136, 2048)),
                         ("newton-schulz", WIDE_SHAPE),
                         ("newton-schulz", (576, 72, 2048)),
                         ("newton-schulz", (576, 96, 2048))):
        b, p, n = shape
        field = label == "landing field"
        if field:
            tile_n = ops.two_stage_tile_n(p, ops.landing_tiled_smem_bytes)
            routes = [functools.partial(lf.landing_field_tiled, tile_n=tile_n),
                      lf.landing_field_large_tc, lf.landing_field_large]
            planned = ops.plan_landing_field(p, n)
        else:
            tile_n = ops.ns_tiled_tile_n(p)
            routes = [functools.partial(ns.newton_schulz_tiled, tile_n=tile_n),
                      ns.newton_schulz_large_tc,
                      ns.newton_schulz_large if p > 128 else ns.newton_schulz_tc128]
            planned = ops.plan_newton_schulz(p, n)
        if planned != (("tc128", 0) if p <= 128 else ("large_tc", 0)):
            raise SystemExit(f"{label} ({p}, {n}) plans {planned}")
        x, g, _, _ = _operands(gen, *shape)
        if field:
            args = (x, g, 1.0)
            want = ref.landing_field_ref(x, g, 1.0)
            tol = TWO_STAGE_TILED_TOL
        else:
            x = 1.5 * x + 0.05 * torch.randn(shape, generator=gen, device="cuda")
            args = (x, NS_ITERS)
            want = ref.newton_schulz_ref(x, NS_ITERS)
            tol = NS_TOL
        errs = [_errors((fn(*args),), (want,), tol) for fn in routes]
        torch.cuda.synchronize()
        if not all(e[2] for e in errs):
            raise SystemExit(f"{label} {shape}: a kernel disagrees ({errs})")
        calls = 10 if field else 3
        times = _time_rotating([(functools.partial(fn, *args), calls) for fn in routes])
        line = (f"crossover {label} {b}x({p},{n}), planned {planned[0]}: the CUDA-core tiled "
                f"kernel (tile {tile_n}) {times[0]:.4f} ms, max_abs {errs[0][0]:.3e}; the "
                f"tensor-core large route {times[1]:.4f} ms, max_abs {errs[1][0]:.3e}")
        if p > 128:
            line += f"; the CUDA-core large route {times[2]:.4f} ms, max_abs {errs[2][0]:.3e}"
        elif not field:
            line += (f"; the tensor-core kernel for p <= 128 {times[2]:.4f} ms, max_abs "
                     f"{errs[2][0]:.3e}")
        if not field:  # the idle repair: every matrix masked off
            y, none = x.clone(), torch.zeros(b, dtype=torch.bool, device="cuda")
            idle = _time_rotating([(functools.partial(fn, y, NS_ITERS, out=y, mask=none), 20)
                                   for fn in routes])
            if not torch.equal(y, x):
                raise SystemExit(f"{label} {shape}: an idle repair wrote a matrix")
            line += (f"; idle repair: tiled {idle[0]:.4f} ms, tensor-core large "
                     f"{idle[1]:.4f} ms, " + ("CUDA-core large" if p > 128 else "p <= 128")
                     + f" {idle[2]:.4f} ms")
            if p <= 128:
                wins = [k for k in (1, 2) if times[k] < times[0] and idle[k] <= idle[0] + 0.1]
                best = min(wins, key=lambda k: times[k]) if wins else 0
                line += (f"; the rule (faster drift step, idle within 0.1 ms of row 9's) "
                         f"takes {('row 9', 'the large route', 'row 9w')[best]}")
        print(line, flush=True)
        del x, g, want, args


# The readings behind the cluster route's end (ops.CLUSTER_MAX_P): 1048 matrices (the paper's count) at p = 4, 10, 16, 24, 28
# and n = 2048, 4096, 10000, and at p = 29 and 32 (the tensor cores' range)
# at n = 2048.
CLUSTER_READINGS = [(1048, p, n) for p in (4, 10, 16, 24, 28) for n in (2048, 4096, 10000)]
CLUSTER_READINGS += [(1048, 29, 2048), (1048, 32, 2048)]


def phase_cluster_crossovers(gen, shapes=CLUSTER_READINGS, rounds=3):
    """At each shape, the cluster kernel's four entries (their own cluster
    size) in turns with the routes below them: fused POGO over trace and
    the POGO update against the CUDA-core tiled kernels (rows 2 and 6), or
    from ``TC_MIN_P`` the tensor-core ones (2tc and 6tc); fused Landing over
    trace and the landing field against rows 2L and 8, or from
    ``LANDING_TC_MIN_P`` 2Ltc and 8tc (X off the manifold for Landing's
    two); each checked against the plain version first. A shape no cluster
    holds says so. Then, at the paper's 1048 x (10, 10000), every cluster
    size that fits a CTA, in turns."""
    import torch

    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import landing_field as lf
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pogo_update as pu

    kw = dict(method="pogo", lam=0.5, base_kind="trace", hyper=(0.9, False))
    lkw = dict(method="landing", lam=1.0, base_kind="trace", hyper=(0.1, False))
    for b, p, n in shapes:
        c = ops.small_p_cluster(p, n)
        plans = (f"{ops.plan(p, n)[0]} / {ops.plan_pogo_update(p, n)[0]} / "
                 f"{ops.plan(p, n, 'landing')[0]} / {ops.plan_landing_field(p, n)[0]}")
        if c == 0:
            print(f"crossover cluster {b}x({p},{n}), planned {plans}: no cluster holds it",
                  flush=True)
            continue
        if p >= ops.TC_MIN_P:
            other, fused, update = "tensor-core", fs.fused_step_tiled_tc, pu.pogo_update_tiled_tc
        else:
            other = "CUDA-core tiled"
            fused = functools.partial(fs.fused_step_tiled, tile_n=ops.tiled_tile_n(p))
            update = functools.partial(
                pu.pogo_update_tiled, tile_n=ops.two_stage_tile_n(p, ops.pogo_tiled_smem_bytes))
        if p >= ops.LANDING_TC_MIN_P:
            lother, lfused, field = ("tensor-core", fs.fused_step_tiled_tc,
                                     lf.landing_field_tiled_tc)
        else:
            lother = "CUDA-core tiled"
            lfused = functools.partial(fs.fused_step_tiled, tile_n=ops.tiled_tile_n(p))
            field = functools.partial(lf.landing_field_tiled, tile_n=ops.two_stage_tile_n(
                p, ops.landing_tiled_smem_bytes))
        x, g, mu, _ = _operands(gen, b, p, n)
        xl = x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
        want = ref.fused_group_step_ref(x, g, LR, mu=mu, **kw)
        want_u = ref.pogo_update_ref(x, g, LR, 0.5)
        want_l = ref.fused_group_step_ref(xl, g, LANDING_LR, mu=mu, **lkw)
        want_f = ref.landing_field_ref(xl, g, 1.0)
        for label, got, w, tol in (
                ("fused cluster", fs.fused_step_cluster(x, g, LR, mu=mu, **kw), want, TILED_TOL),
                ("fused " + other, fused(x, g, LR, mu=mu, **kw), want, TILED_TOL),
                ("update cluster", (pu.pogo_update_cluster(x, g, LR, 0.5),), (want_u,),
                 TWO_STAGE_TILED_TOL),
                ("update " + other, (update(x, g, LR, 0.5),), (want_u,), TWO_STAGE_TILED_TOL),
                ("fused Landing cluster", fs.fused_step_cluster(xl, g, LANDING_LR, mu=mu, **lkw),
                 want_l, TILED_TOL),
                ("fused Landing " + lother, lfused(xl, g, LANDING_LR, mu=mu, **lkw), want_l,
                 TILED_TOL),
                ("field cluster", (lf.landing_field_cluster(xl, g, 1.0),), (want_f,),
                 TWO_STAGE_TILED_TOL),
                ("field " + lother, (field(xl, g, 1.0),), (want_f,), TWO_STAGE_TILED_TOL)):
            if not _errors(got, w, tol)[2]:
                raise SystemExit(f"crossover {label} at {(b, p, n)} disagrees")
        del want, want_u, want_l, want_f
        t = _time_rotating([(lambda: fs.fused_step_cluster(x, g, LR, mu=mu, **kw), 10),
                            (lambda: fused(x, g, LR, mu=mu, **kw), 10),
                            (lambda: pu.pogo_update_cluster(x, g, LR, 0.5), 10),
                            (lambda: update(x, g, LR, 0.5), 10),
                            (lambda: fs.fused_step_cluster(xl, g, LANDING_LR, mu=mu, **lkw), 10),
                            (lambda: lfused(xl, g, LANDING_LR, mu=mu, **lkw), 10),
                            (lambda: lf.landing_field_cluster(xl, g, 1.0), 10),
                            (lambda: field(xl, g, 1.0), 10)], rounds)
        print(f"crossover cluster {b}x({p},{n}), planned {plans}: fused POGO cluster of {c} "
              f"{t[0]:.4f} ms, {other} {t[1]:.4f} ms; POGO update cluster {t[2]:.4f} ms, "
              f"{other} {t[3]:.4f} ms; fused Landing cluster {t[4]:.4f} ms, {lother} "
              f"{t[5]:.4f} ms; field cluster {t[6]:.4f} ms, {lother} {t[7]:.4f} ms", flush=True)
        del x, g, mu, xl
    b, p, n = PAPER_SHAPE
    sizes = [c for c in (2, 4, 8) if ops.small_p_smem_bytes(p, n, c) <= ops.SMEM_LIMIT_BYTES]
    x, g, mu, _ = _operands(gen, b, p, n)
    xl = x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
    entries = (
        ("fused POGO", lambda c: fs.fused_step_cluster(x, g, LR, mu=mu, cluster=c, **kw)),
        ("POGO update", lambda c: pu.pogo_update_cluster(x, g, LR, 0.5, cluster=c)),
        ("fused Landing",
         lambda c: fs.fused_step_cluster(xl, g, LANDING_LR, mu=mu, cluster=c, **lkw)),
        ("field", lambda c: lf.landing_field_cluster(xl, g, 1.0, cluster=c)))
    t = _time_rotating([(functools.partial(fn, c), 10) for _, fn in entries for c in sizes],
                       rounds)
    k = len(sizes)
    line = "; ".join(f"{label} { {c: round(v, 4) for c, v in zip(sizes, t[i * k:(i + 1) * k])} }"
                     " ms" for i, (label, _) in enumerate(entries))
    print(f"cluster sizes at {b}x({p},{n}) (smem a CTA "
          f"{[ops.small_p_smem_bytes(p, n, c) for c in sizes]} bytes), planned "
          f"{ops.small_p_cluster(p, n)}: {line}", flush=True)
    del x, g, mu, xl


def _is_qk(path: str) -> bool:
    return "q_proj" in path or "k_proj" in path


def _timed(transform, events):
    """``transform`` with every ``update`` bracketed by two CUDA events."""
    import torch

    from repro_torch.optim import GradientTransformation

    def update(grads, state, params=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = transform.update(grads, state, params)
        end.record()
        events.append((start, end))
        return out

    return GradientTransformation(transform.init, update, tag=transform.tag)


def phase_trainer(card, workdir):
    """SmolLM-360M at full width through the launcher's ``make_train_step``
    and ``train``; returns the main path's kernel launches."""
    import shutil
    import time

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import ops
    from repro_torch.models import ortho
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import partition
    from repro_torch.train.loop import LoopConfig, drift, train
    from repro_torch.train.train_step import TrainConfig, make_optimizer, make_train_step
    from repro_torch import tree

    cfg = get_config("smollm-360m")
    wd = api.WatchdogConfig()
    tc = TrainConfig(pogo_learning_rate=TRAIN_POGO_LR, pogo_use_kernel=True,
                     ortho_watchdog=wd, warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                     decay_steps=TRAIN_STEPS)
    opt = make_optimizer(cfg, tc)
    transforms = dict(opt.tag[1])  # the orthoptimizer's updates, timed
    ortho_events: list = []
    transforms["orthogonal"] = _timed(transforms["orthogonal"], ortho_events)
    opt = partition(transforms, lambda p: ortho.label_tree(p, cfg))
    step_fn, _ = make_train_step(cfg, tc, optimizer=opt)

    def fresh(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = ortho.project_init(tfm.init_params(gen, cfg, "cuda"), cfg)
        data = DataIterator(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                            device="cuda")
        return params, opt.init(params), data

    per_step: dict = {}

    def stepper(data):
        def run(p, o, b):
            k = data.step  # this step's number, 1-based
            if k == DRIFT_STEP:
                p = drift(p, 0.5, select=_is_qk)
            before = ops.launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            n_events = len(ortho_events)
            start.record()
            p, o, m = step_fn(p, o, b)
            end.record()
            torch.cuda.synchronize()
            o_start, o_end = ortho_events[n_events]
            after = ops.launches()
            per_step[k] = dict(
                metrics={name: float(v) for name, v in m.items()},
                summary=api.watchdog_summary(o),
                launches={n: after[n] - before[n] for n in after if after[n] != before[n]},
                ms=start.elapsed_time(end), ortho_ms=o_start.elapsed_time(o_end))
            return p, o, m
        return run

    ck1, ck2 = os.path.join(workdir, "run"), os.path.join(workdir, "resume")
    params, state, data = fresh(0)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"trainer: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"pogo lr {TRAIN_POGO_LR}, watchdog {wd}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    params, state, step, _ = train(
        stepper(data), params, state, data,
        LoopConfig(total_steps=TRAIN_STEPS, save_every=2, keep_last=8,
                   checkpoint_dir=ck1, log_every=1))
    wall = time.monotonic() - t0
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    run1 = dict(per_step)
    for k in sorted(run1):
        r = run1[k]
        print(f"trainer step {k}: {r['metrics']} ms {r['ms']:.1f} ortho_ms "
              f"{r['ortho_ms']:.3f} repairs {r['summary']['repairs']} launches "
              f"{r['launches']}", flush=True)
    if step != TRAIN_STEPS:
        raise SystemExit(f"trainer stopped at step {step}")
    for k, r in run1.items():
        m = r["metrics"]
        if not (m["health_finite"] == 1.0 and m["loss"] == m["loss"] < float("inf")):
            raise SystemExit(f"trainer step {k}: not finite {m}")
        # One fused step and one repair launch per step: the repair's CTAs
        # exit at once for matrices that did not trip, so only the drift
        # step repairs (the counter says which).
        if r["launches"] != {"fused_step_tiled_tc": 1, "newton_schulz_tc": 1}:
            raise SystemExit(f"trainer step {k}: launches {r['launches']}")
        repairs = 640 if k >= DRIFT_STEP else 0
        if r["summary"]["repairs"] != repairs:
            raise SystemExit(f"trainer step {k}: {r['summary']}, expected {repairs} repairs")
        if k == DRIFT_STEP:
            if not m["ortho_distance"] < wd.hard / 2:
                raise SystemExit(f"trainer drift step: distance {m['ortho_distance']} "
                                 f"(limit {wd.hard / 2})")
        elif m["ortho_distance"] > 1e-5:
            raise SystemExit(f"trainer step {k}: ortho_distance {m['ortho_distance']}")
    want = {n: TRAIN_STEPS if n in ("fused_step_tiled_tc", "newton_schulz_tc") else 0
            for n in launches}
    if launches != want:
        raise SystemExit(f"trainer: launches {launches}, expected {want}")

    # Resume from the step-4 checkpoint (other weights in memory) and replay.
    shutil.copytree(os.path.join(ck1, "step_000000004"),
                    os.path.join(ck2, "step_000000004"))
    per_step.clear()
    p2, s2, d2 = fresh(1)
    p2, s2, step2, _ = train(stepper(d2), p2, s2, d2,
                             LoopConfig(total_steps=6, save_every=100,
                                        checkpoint_dir=ck2, log_every=1))
    same = all(per_step[k]["metrics"] == run1[k]["metrics"] for k in (5, 6))
    want6 = ckpt.restore(ck1, 6, (p2, s2))
    same_state = all(torch.equal(a, b) for a, b in
                     zip(tree.leaves(want6), tree.leaves((p2, s2))))
    print(f"trainer resume from step 4: steps 5-6 metrics identical {same}, "
          f"params and optimizer state at step 6 identical {same_state}", flush=True)
    if step2 != 6 or not (same and same_state):
        raise SystemExit("trainer: the resumed run does not replay steps 5-6")

    steady = [r for k, r in run1.items() if k > 1]  # step 1 warms the caches
    step_ms = statistics.median(r["ms"] for r in steady)
    ortho_ms = statistics.median(r["ortho_ms"] for r in steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"trainer: median step {step_ms:.2f} ms, {1e3 * tokens / step_ms:.0f} tokens/s, "
          f"orthoptimizer {ortho_ms:.3f} ms ({ortho_ms / step_ms:.4f} of the step; "
          f"drift step {run1[DRIFT_STEP]['ortho_ms']:.3f} ms), peak "
          f"{peak:.1f} MiB, {TRAIN_STEPS} steps in {wall:.1f} s wall [{card}]", flush=True)
    return launches


def make_opt(path, use_kernel=True, **kw):
    """The optimizer of main path ``path`` (``fused``, ``pogo_adam``,
    ``landing``, ``landing_fused``, or the TP path's ``tp_pogo`` and
    ``tp_landing``); ``benchmarks_torch/profile_step.py`` traces the same."""
    from repro_torch.core import api
    from repro_torch.optim import chain, scale_by_adam, scale_by_vadam, trace

    if path in ("landing_fused", "tp_landing"):
        return api.orthogonal("landing", learning_rate=LANDING_LR, use_kernel=use_kernel,
                              safe_step=False, base_optimizer=chain(trace(0.1)), **kw)
    if path == "tp_pogo":
        return api.orthogonal("pogo", learning_rate=LR, use_kernel=use_kernel,
                              base_optimizer=chain(scale_by_vadam()), **kw)

    if path == "fused":
        return api.orthogonal("pogo", learning_rate=LR, use_kernel=use_kernel,
                              base_optimizer=chain(trace(0.9)))
    if path == "pogo_adam":
        return api.orthogonal("pogo", learning_rate=1e-3, use_kernel=use_kernel,
                              base_optimizer=chain(scale_by_adam()))
    if path == "landing":
        return api.orthogonal("landing", learning_rate=0.25, use_kernel=use_kernel,
                              base_optimizer=chain(trace(0.1)))
    raise ValueError(f"unknown path {path!r}")


def _clone_state(state):
    from repro_torch import tree

    return state._replace(count=state.count.clone(),
                          base_state=tree.tree_map(lambda t: t.clone(),
                                                   state.base_state))


def drive_main_path(gen, shapes, label, steps, card, make_opt, max_dist):
    """``make_opt(True)`` + ``constraint_step`` on a ConstraintSet of random
    Stiefel leaves: 2 warm-up steps, then ``steps`` counted steps. The first
    counted step is held against the plain route, ``make_opt(False)``'s
    out-of-place update from the same state. Returns the launches of each
    kernel during the counted steps."""
    import torch

    from repro_torch.core import api, stiefel
    from repro_torch.kernels import ops

    params = {k: stiefel.random_stiefel(gen, s, device="cuda") for k, s in shapes.items()}
    cs = api.ConstraintSet.from_tree(params)
    del params
    opt = make_opt(True)
    state = opt.init(cs)
    step = api.constraint_step(opt)
    grads = [
        api.ConstraintSet(cs.plan, [GRAD_SCALE * torch.randn(s.shape, generator=gen,
                                                             device="cuda")
                                    for s in cs.stacks])
        for _ in range(steps + 2)
    ]
    print(f"{label}: {cs}", flush=True)
    for gs in grads[:2]:
        cs, state, health = step(cs, state, gs)
    torch.cuda.synchronize()

    # The plain route's first counted step, from the same state.
    plain = make_opt(False)
    cs0 = api.ConstraintSet(cs.plan, [s.clone() for s in cs.stacks])
    upd, plain_state = plain.update(grads[2], _clone_state(state), cs0)
    want_x = [x + u for x, u in zip(cs0.stacks, upd.stacks)]
    want_d = plain_state.last_distance.per_group
    del cs0, upd, plain_state
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times, dists = [], []
    for i, gs in enumerate(grads[2:]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cs, state, health = step(cs, state, gs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        dist = float(api.max_distance(state))
        dists.append(dist)
        if i == 0:
            got = tuple(cs.stacks) + tuple(state.last_distance.per_group)
            max_abs, _, ok = _errors(got, tuple(want_x) + tuple(want_d), TILED_TOL)
            per_group = [f"{float(a.max()):.3e}/{float(b.max()):.3e}"
                         for a, b in zip(state.last_distance.per_group, want_d)]
            print(f"{label} step 0 vs plain route: max_abs {max_abs:.3e}, max distance by "
                  f"group (kernel/plain) {per_group} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"{label}: main path disagrees with the plain route")
            del want_x, want_d
        if not bool(health.finite) or not dist <= max_dist:
            raise SystemExit(f"{label} step {i}: finite={bool(health.finite)} "
                             f"max_distance={dist} (limit {max_dist})")
    launches = ops.launches()
    for s in cs.stacks:
        if not bool(torch.isfinite(s).all()):
            raise SystemExit(f"{label}: non-finite stack")
    times.sort()
    print(f"{label}: {steps} steps, median step {times[len(times) // 2]:.4f} ms, "
          f"max_distance per step {[f'{d:.2e}' for d in dists]}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"launches {launches} [{card}]", flush=True)
    return launches


def phase_landing_watchdog(gen, card):
    """Fixed-step Landing on a q/k stack with the feasibility watchdog: two
    steps, then the stack scaled by 1.5 and one step, in which the fused
    kernel and the Newton-Schulz repair launch once each and every matrix
    is repaired (the fused watchdog only tightens the repair threshold,
    ``repro/core/api.py:1551-1564``): at SmolLM-360M's 640 x (64, 960) (the
    tensor-core repair), at internlm2-1.8b's 576 x (128, 2048) (the wide
    fused kernel and the tensor-core repair for p <= 128, row 9w), at
    starcoder2-15b's 2080 x (128, 6144) (the wide fused kernel and the
    streaming repair, row 9s; its peak device memory printed), at the
    paper's unitary-PC 1048 x (10, 10000) (the cluster kernel's Landing and
    Newton-Schulz, rows 2Lcl and 9cl), at 1048 x (10, 9998) (the CUDA-core
    tiled Landing and repair, rows 2L and 9, whose main path this is), at
    the paper's CNN filters, 3 x (256, 2304), and O-ViT, 18 x (1024, 1024)
    (the large route's fused Landing and Newton-Schulz), and at
    ``LARGE_ODD`` (the CUDA-core large route). At internlm2-1.8b's and
    starcoder2-15b's q/k and the paper's 1048 x (10, 10000) the drift step
    and an undrifted one (the repair's idle launch) are timed first, medians
    of three on copies of the state, the drift step also with row 9 planned
    in place of row 9w, 9s or 9cl.
    Returns the repair kernels' launches."""
    import torch

    from repro_torch.core import api, stiefel
    from repro_torch.kernels import ops

    wd = api.WatchdogConfig()
    repairs = {}
    for shape, fused, repair in (((640, 64, 960), "fused_step_tiled_tc_landing",
                                  "newton_schulz_tc"),
                                 (WIDE_SHAPE, "fused_step_tiled_tc128_landing",
                                  "newton_schulz_tc128"),
                                 (STREAM_SHAPE, "fused_step_tiled_tc128_landing",
                                  "newton_schulz_stream"),
                                 (PAPER_SHAPE, "fused_step_cluster_landing",
                                  "newton_schulz_cluster"),
                                 (PAPER_ODD_SHAPE, "fused_step_tiled_landing",
                                  "newton_schulz_tiled"),
                                 (CNN_SHAPE, "fused_step_large_tc_landing",
                                  "newton_schulz_large_tc"),
                                 (OVIT_SHAPE, "fused_step_large_tc_landing",
                                  "newton_schulz_large_tc"),
                                 (LARGE_ODD, "fused_step_large_landing", "newton_schulz_large")):
        torch.cuda.reset_peak_memory_stats()
        opt = make_opt("landing_fused", watchdog=wd)
        cs = api.ConstraintSet.from_tree({"qk": stiefel.random_stiefel(gen, shape,
                                                                       device="cuda")})
        state = opt.init(cs)
        step = api.constraint_step(opt)

        def grads():
            return api.ConstraintSet(cs.plan, [GRAD_SCALE * torch.randn(
                s.shape, generator=gen, device="cuda") for s in cs.stacks])

        for _ in range(2):
            cs, state, _ = step(cs, state, grads())
        if shape in (WIDE_SHAPE, STREAM_SHAPE, PAPER_SHAPE):
            _time_drift_step(step, cs, state, grads(), card, shape, repair)
        for s in cs.stacks:
            s.mul_(1.5)
        g = grads()
        torch.cuda.synchronize()
        ops.reset_launches()
        cs, state, health = step(cs, state, g)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if v}
        summary = api.watchdog_summary(state)
        dist = float(api.max_distance(state))
        peak = ""
        if shape == STREAM_SHAPE:
            peak = f", peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        print(f"landing fused + watchdog, {shape[0]}x{shape[1:]} scaled by 1.5: repairs "
              f"{summary['repairs']}, distance after the step {dist:.3e} (limit "
              f"{wd.hard / 2}), launches {launches}{peak} [{card}]", flush=True)
        if not (bool(health.finite) and summary["repairs"] == shape[0]
                and dist < wd.hard / 2 and launches == {fused: 1, repair: 1}):
            raise SystemExit(f"landing fused + watchdog at {shape}: the drift step was not "
                             "repaired")
        repairs[repair] = repairs.get(repair, 0) + launches[repair]
        del cs, state, g
    return repairs


def _time_drift_step(step, cs, state, g, card, shape, repair, repeats=3):
    """Medians of ``repeats`` fused Landing steps with the watchdog from
    copies of (cs, state) at ``shape``: undrifted (the repair's idle
    launch), after the 1.5x drift (the repair of every matrix), and the
    drift step again with a stand-in planner that gives Newton-Schulz row
    9's tiled kernel. Each run must launch the planned repair (``repair``)
    once a step."""
    import torch

    from repro_torch.core import api
    from repro_torch.kernels import ops

    def median_ms(scale):
        times = []
        for _ in range(repeats):
            cs2 = api.ConstraintSet(cs.plan, [scale * s for s in cs.stacks])
            state2 = _clone_state(state)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(cs2, state2, g)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def repairs(scale, want):
        ops.reset_launches()
        ms = median_ms(scale)
        got = {k: v for k, v in ops.launches().items() if k.startswith("newton_schulz") and v}
        if got != {want: repeats}:
            raise SystemExit(f"landing fused + watchdog timing: {got} repaired, not {want}")
        return ms

    still = repairs(1.0, repair)
    drift = repairs(1.5, repair)
    with _row9_planned(shape[1]):
        drift_row9 = repairs(1.5, "newton_schulz_tiled")
    row = {"newton_schulz_tc128": "row 9w", "newton_schulz_stream": "row 9s",
           "newton_schulz_cluster": "row 9cl"}[repair]
    print(f"landing fused + watchdog, {shape[0]}x{shape[1:]}: median step "
          f"{still:.4f} ms undrifted (the repair idle), {drift:.4f} ms on the drift step "
          f"({row} repairs), {drift_row9:.4f} ms with row 9 repairing [{card}]", flush=True)


def phase_tp_schedule(gen, card):
    """The single-device TP schedule, ``ops.fused_group_step_tp`` with four
    shards of the q/k stack, against the unsharded fused step on the card:
    POGO over VAdam and Landing over trace, each one call (four
    ``tp_gram`` and one ``tp_apply`` launch)."""
    import torch

    from repro_torch.kernels import ops

    for method, base, hyper in (("pogo", "vadam", (0.9, 0.999, 1e-8)),
                                ("landing", "trace", (0.1, False))):
        x, g, mu, nu = _operands(gen, 640, 64, 960)
        kw = dict(method=method, lam=0.5 if method == "pogo" else 1.0, base_kind=base,
                  hyper=hyper, mu=mu, nu=nu if base == "vadam" else None,
                  count=torch.tensor(3, dtype=torch.int32, device="cuda"))
        ops.reset_launches()
        got = ops.fused_group_step_tp(x, g, LR, tp_shards=4, **kw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launches().items() if v}
        want = ops.fused_group_step(x, g, LR, **kw)
        torch.cuda.synchronize()
        max_abs, _, ok = _errors(got, want, TILED_TOL)
        print(f"tp schedule {method}+{base} 640x(64,960) tp_shards 4 vs the unsharded "
              f"fused step: max_abs {max_abs:.3e}, launches {launches} "
              f"{'ok' if ok else 'MISMATCH'} [{card}]", flush=True)
        if not ok or launches != {"tp_gram": 4, "tp_apply": 1}:
            raise SystemExit("the single-device TP schedule disagrees with the fused step")
        del x, g, mu, nu, got, want


def _tp_runs(mesh, seed, n, paths):
    """One TP run per path on this rank: the stack (640, 64, n) and its
    gradients from ``seed``, as DTensors ``Shard(-1)`` on "model",
    ``TP_STEPS`` steps of ``constraint_step``. Returns per path the full
    operands, the local result, its distances, all-reduces per step and
    host-clock step times."""
    import time

    import torch

    from repro_torch.core import api, stiefel
    from repro_torch.distributed import shard_hints as sh

    out = []
    for i, path in enumerate(paths):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        x = stiefel.random_stiefel(gen, (640, 64, n), device="cuda")
        grads = [GRAD_SCALE * torch.randn(x.shape, generator=gen, device="cuda")
                 for _ in range(TP_STEPS)]
        opt = make_opt(path)
        cs = api.ConstraintSet.from_tree({"qk": sh.shard_columns(x, mesh)})
        state = opt.init(cs)
        step = api.constraint_step(opt)
        calls, ms = [], []
        for g in grads:
            before = sh.all_reduce_payload.calls
            gs = api.ConstraintSet.from_tree({"qk": sh.shard_columns(g, mesh)})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs, state, health = step(cs, state, gs)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            calls.append(sh.all_reduce_payload.calls - before)
            if not bool(health.finite):
                raise SystemExit(f"tp {path}: non-finite step")
        out.append(dict(path=path, x=x, grads=grads, local=cs.stacks[0].to_local().clone(),
                        dist=state.last_distance.per_group[0].clone(), calls=calls, ms=ms))
    return out


def _tp_check(rank, run):
    """The unsharded fused step from the same operands on this rank, and
    the rank's columns of it against the TP result."""
    import torch

    from repro_torch.core import api

    opt = make_opt(run["path"])
    cs = api.ConstraintSet.from_tree({"qk": run["x"].clone()})
    state = opt.init(cs)
    step = api.constraint_step(opt)
    for g in run["grads"]:
        cs, state, _ = step(cs, state, api.ConstraintSet(cs.plan, [g]))
    want = torch.chunk(cs.stacks[0], 2, dim=-1)[rank]
    max_abs, _, ok = _errors((run["local"], run["dist"]),
                             (want, state.last_distance.per_group[0]), TILED_TOL)
    return max_abs, ok, float(run["dist"].max())


def tp_rank(rank, workdir):
    """One rank of the two-rank TP path on the one card: gloo, a (1, 2)
    mesh. Prints one JSON line with its counts, errors and times."""
    import time

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import shard_hints as sh
    from repro_torch.kernels import ops
    from repro_torch.kernels import tp_step as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)  # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=2)
    try:
        mesh = DeviceMesh("cuda", torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        sh.set_mesh(mesh)
        rec = {"rank": rank}
        ops.reset_launches()  # the main path: POGO over VAdam, then Landing over trace
        runs = _tp_runs(mesh, 11, 960, ["tp_pogo", "tp_landing"])
        torch.cuda.synchronize()
        rec["launches"] = {k: v for k, v in ops.launches().items() if v}
        runs += _tp_runs(mesh, 21, 962, ["tp_pogo"])  # padded: 481 -> 484 a rank
        for run, label in zip(runs, ("pogo+vadam", "landing+trace", "pogo+vadam n=962")):
            max_abs, ok, dist_max = _tp_check(rank, run)
            rec[label] = dict(calls=run["calls"], max_abs=max_abs, ok=ok,
                              dist=dist_max, step_ms=statistics.median(run["ms"]),
                              local=list(run["local"].shape))
        # Where a step's time goes on this rank: each piece of the POGO
        # step at the main path's shape, the kernels by CUDA events, the
        # all-reduce by the host clock (gloo stages CUDA tensors on the host).
        x = runs[0]["local"].contiguous()
        g = torch.chunk(runs[0]["grads"][0], 2, dim=-1)[rank].contiguous()
        mu = torch.zeros_like(x)
        gtile = ops.plan_tp("tp_gram", 64, ops.tp_gram_smem_bytes)
        atile = ops.plan_tp("tp_apply", 64, ops.tp_apply_smem_bytes)
        gkw = dict(base_kind="vadam", hyper=(0.9, 0.999, 1e-8), mu=mu, tile_n=gtile)
        payload, gb, _ = tp.tp_gram(x, g, **gkw)
        gram_ms = _time_ms(lambda: tp.tp_gram(x, g, **gkw), 20)
        ar = []
        for _ in range(20):
            buf = payload.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sh.all_reduce_payload(buf)
            torch.cuda.synchronize()
            ar.append(1e3 * (time.perf_counter() - t0))
        scl = torch.ones(x.shape[0], device="cuda")
        apply_ms = _time_ms(lambda: tp.tp_apply(x, gb, payload, LR, scl, method="pogo",
                                                lam=0.5, tile_n=atile), 20)
        ar_ms = statistics.median(ar)
        rec["times"] = dict(gram_ms=gram_ms, all_reduce_ms=ar_ms, apply_ms=apply_ms,
                            all_reduce_share=ar_ms / (gram_ms + ar_ms + apply_ms))
        print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def phase_tp_ranks(card, workdir):
    """The TP main path: two ranks of this script on the one card. Returns
    the main path's launches of each TP kernel, summed over the ranks."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                               str(r), workdir], stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    recs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"tp rank exited with {proc.returncode}")
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    steps = [1] * TP_STEPS
    want = {"tp_gram": 2 * TP_STEPS, "tp_apply": 2 * TP_STEPS}
    for rec in recs:
        r = rec["rank"]
        for label in ("pogo+vadam", "landing+trace", "pogo+vadam n=962"):
            v = rec[label]
            limit = 0.5 if label.startswith("landing") else 1e-5
            print(f"tp rank {r} {label}: local {v['local']}, all-reduces per step "
                  f"{v['calls']}, max_abs vs the unsharded fused step {v['max_abs']:.3e}, "
                  f"max distance {v['dist']:.3e} (limit {limit}), median step "
                  f"{v['step_ms']:.3f} ms {'ok' if v['ok'] else 'MISMATCH'}", flush=True)
            if v["calls"] != steps or not v["ok"] or not v["dist"] <= limit:
                raise SystemExit(f"tp rank {r} {label}: {v}")
        t = rec["times"]
        print(f"tp rank {r} pogo+vadam 640x(64,480) pieces: tp_gram {t['gram_ms']:.4f} ms, "
              f"all-reduce (gloo) {t['all_reduce_ms']:.4f} ms, tp_apply "
              f"{t['apply_ms']:.4f} ms, all-reduce share {t['all_reduce_share']:.3f}; "
              f"main-path launches {rec['launches']} [{card}]", flush=True)
        if rec["launches"] != want:
            raise SystemExit(f"tp rank {r}: launches {rec['launches']}, expected {want}")
    return {k: sum(rec["launches"][k] for rec in recs) for k in want}


def _flash_inputs(gen, shape, dtype):
    import torch

    b, s, h, kvh, hd = shape
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype)
            for sh in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


def _flash_pairs(shape, causal):
    """(query, key) pairs that the causal mask keeps, over all (batch, head)."""
    b, s, h, _, _ = shape
    return (s * (s + 1) // 2 if causal else s * s) * b * h


def _flash_bound(shape, causal, elem_bytes, flop_per_s=FP32_FLOP_PER_S, pv_passes=1,
                 qk_passes=1):
    """Bytes: q, k, v read once, the output written once. Operations: a
    multiply-add per head dimension per kept (query, key) pair, ``qk_passes``
    times for QK^T and ``pv_passes`` for PV (the bf16 kernel runs PV once
    for each bf16 piece of p; 3xTF32 runs both three times), at
    ``flop_per_s``."""
    b, s, h, kvh, hd = shape
    return _bound_ms(elem_bytes * (2 * b * s * h * hd + 2 * b * s * kvh * hd),
                     2 * hd * (qk_passes + pv_passes) * _flash_pairs(shape, causal),
                     flop_per_s)


def phase_flash_attention(gen, card):
    """The three flash kernels against their plain version on the card: the
    bf16 tensor-core kernel at the prefill's shape, internlm2-1.8b's heads,
    S = 2000 windowed and hd 24; the 3xTF32 kernel (fp32) at the prefill's
    shape, internlm2-1.8b's heads and S = 2000; the CUDA-core kernel (fp32)
    at hd 62. Each launched through ``flash_attention_fwd``, which must
    pick it (``flash_attention.plan``). Then the bf16 kernel timed at the
    prefill's shape beside the plain version and PyTorch's SDPA, and the
    3xTF32 kernel beside the CUDA-core kernel called directly, the plain
    version and SDPA, in turns."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (shape, dtype, causal, window); the first of each kernel is its main path's
        (FLASH_SHAPE, bf16, True, None),
        (FLASH_WIDE_SHAPE, bf16, True, None),
        (FLASH_F32_SHAPE, bf16, True, 256),
        (FLASH_HD24_SHAPE, bf16, True, None),
        (FLASH_SHAPE, f32, True, None),
        (FLASH_WIDE_SHAPE, f32, True, None),
        (FLASH_F32_SHAPE, f32, True, None),
        (FLASH_F32_SHAPE, f32, False, None),
        (FLASH_F32_SHAPE, f32, True, 256),
        (FLASH_HD62_SHAPE, f32, True, None),
    ]
    # wrapper -> its record in the kernels line
    record_of = {"flash_attention_tc": "flash_attention_tc",
                 "flash_attention_tf32": "flash_attention_tf32",
                 "flash_attention_fp32": "flash_attention"}
    records = {key: {} for key in record_of.values()}
    for shape, dtype, causal, window in cases:
        q, k, v = _flash_inputs(gen, shape, dtype)
        ops.reset_launches()
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launched = {n: c for n, c in ops.launches().items() if c}
        want = fa.run_plain(q, k, v, causal=causal, window=window)
        d = (got.float() - want.float()).abs()
        max_abs = float(d.max())
        lim = FLASH_BF16_TOL if dtype == bf16 else FLASH_TOL
        name = fa.plan(dtype, shape[-1])
        ok = bool(torch.all(d <= lim["atol"] + lim["rtol"] * want.float().abs())
                  and torch.isfinite(got).all()) and launched == {name: 1}
        tol = f"per element atol {lim['atol']} rtol {lim['rtol']:.4g}"
        if dtype == bf16:
            # a bf16 ulp at the output's largest magnitude: 2^(floor(log2 max) - 7)
            top = float(want.float().abs().max())
            ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
            tol += (f"; {max_abs / ulp:.2f} bf16 ulp at the largest |output| {top:.3f}, "
                    f"{int((d > 0).sum())} of {d.numel()} elements differ; JAX's bf16 "
                    f"tolerance {FLASH_BF16_REFERENCE}")
        records[record_of[name]].setdefault("max_abs_err", max_abs)
        print(f"kernel {name} {shape} {str(dtype)[6:]} causal {causal} window {window}: "
              f"launches {launched}, max_abs {max_abs:.3e} ({tol}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise SystemExit(f"{name} {shape} {dtype} causal {causal} window {window} "
                             f"disagrees with its plain version or did not launch")
        del got, want, d

    hd = FLASH_SHAPE[-1]
    pairs = _flash_pairs(FLASH_SHAPE, True)
    exp_ms = 1e3 * pairs / SFU_EXP2_PER_S
    for dtype in (bf16, f32):
        q, k, v = _flash_inputs(gen, FLASH_SHAPE, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's layout
        fns = [(lambda: fa.flash_attention_fwd(q, k, v, causal=True), 20),
               (lambda: fa.run_plain(q, k, v, causal=True, window=None), 10),
               (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True), 20)]
        if dtype == f32:  # the CUDA-core kernel called directly, beside the 3xTF32 one
            fns.append((lambda: fa.flash_attention_fp32(q, k, v, causal=True, window=None),
                        10))
        ms, plain_ms, library_ms, *cc = _time_rotating(fns)
        esize = 2 if dtype == bf16 else 4
        bytes_ms, _ = _flash_bound(FLASH_SHAPE, True, esize, flop_per_s=math.inf)
        fp32_ms, _ = _flash_bound(FLASH_SHAPE, True, esize)
        if dtype == bf16:
            key = "flash_attention_tc"
            bound_ms, bound_by = _flash_bound(FLASH_SHAPE, True, 2, BF16_TC_FLOP_PER_S,
                                              pv_passes=3)
            two_ms, _ = _flash_bound(FLASH_SHAPE, True, 2, BF16_TC_FLOP_PER_S, pv_passes=2)
            tc_ms, _ = _flash_bound(FLASH_SHAPE, True, 2, BF16_TC_FLOP_PER_S)
            bounds = (f"split-p tensor work, QK^T and PV for each of p's three bf16 pieces "
                      f"at the bf16 tensor-core rate; {two_ms:.4f} with two pieces, "
                      f"{tc_ms:.4f} with one; exponentials {exp_ms:.4f} on the SFUs; "
                      f"bytes {bytes_ms:.4f}; fp32 CUDA cores {fp32_ms:.4f}")
        else:
            key = "flash_attention_tf32"
            bound_ms, bound_by = _flash_bound(FLASH_SHAPE, True, 4, TF32_TC_FLOP_PER_S,
                                              pv_passes=3, qk_passes=3)
            bounds = (f"3xTF32 tensor work, QK^T and PV three times each at the TF32 "
                      f"tensor-core rate; fp32 CUDA cores {fp32_ms:.4f}; exponentials "
                      f"{exp_ms:.4f} on the SFUs; bytes {bytes_ms:.4f}")
            cc_ms = cc[0]
            got = fa.flash_attention_fp32(q, k, v, causal=True, window=None)
            want = fa.run_plain(q, k, v, causal=True, window=None)
            cc_err = float((got - want).abs().max())
            print(f"  flash_attention (the CUDA-core kernel called directly) {FLASH_SHAPE} "
                  f"float32 causal: ms {cc_ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
                  f"{library_ms:.4f} bound_ms {fp32_ms:.4f} (operations, fp32 CUDA cores; "
                  f"bytes {bytes_ms:.4f}); max_abs {cc_err:.3e}; the 3xTF32 kernel "
                  f"{cc_ms / ms:.2f}x faster [{card}]", flush=True)
            if not bool(torch.all((got - want).abs() <= FLASH_TOL["atol"]
                                  + FLASH_TOL["rtol"] * want.abs())):
                raise SystemExit("flash_attention_fp32 disagrees with its plain version "
                                 f"at {FLASH_SHAPE}")
            records["flash_attention"].update(
                ms=cc_ms, plain_ms=plain_ms, bound_ms=fp32_ms, bound_by="operations",
                library_ms=library_ms)
            del got, want
        print(f"  {key} {FLASH_SHAPE} {str(dtype)[6:]} causal: ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} sdpa_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}, "
              f"{bounds}); {1e-9 * 4 * hd * pairs / ms:.1f} "
              f"TFLOP/s of the function's 4 hd flops a kept pair [{card}]", flush=True)
        records[key].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
        del q, k, v, qt, kt, vt
    return records


def _prefill_check(card, cfg, label, rel_tol, kernel):
    """Full-width ``transformer.prefill`` on 4 x 2048 tokens: its main-path
    launches (``kernel``, once a layer, and nothing else), its last-position
    logits against the same call with the plain version in
    ``ops.flash_attention``'s place, its time. Returns the launches."""
    import time

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tfm.init_params(gen, cfg, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device="cuda")
    tfm.prefill(params, cfg, tokens)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    logits = tfm.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if v}
    fn = ops.flash_attention
    ops.flash_attention = lambda q, k, v, *, causal=True, window=None: fa.run_plain(
        q, k, v, causal=causal, window=window)
    try:
        plain = tfm.prefill(params, cfg, tokens)
        torch.cuda.synchronize()
    finally:
        ops.flash_attention = fn
    err = float((logits - plain).abs().max())
    rel = err / float(plain.abs().max())
    # each row's argmax agrees, or parts at a tie: the plain version's
    # top-2 margin there under the measured error
    parted = (logits.argmax(-1) != plain.argmax(-1)).flatten()
    top2 = torch.topk(plain.float().flatten(0, 1), 2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1])[parted].tolist()
    agree = PREFILL_BATCH - len(margins)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        tfm.prefill(params, cfg, tokens)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(walls)
    tokens_n = PREFILL_BATCH * PREFILL_SEQ
    ok = (launches == {kernel: cfg.num_layers} and rel <= rel_tol
          and all(m < err for m in margins) and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.padded_vocab))
    print(f"{label} {cfg.name} {cfg.num_layers} layers, {PREFILL_BATCH} x "
          f"{PREFILL_SEQ} tokens ({cfg.compute_dtype}): launches {launches}, "
          f"last-position logits vs the plain version max_abs {err:.3e} "
          f"(relative {rel:.3e}, limit {rel_tol}), "
          f"argmax agrees {agree}/{PREFILL_BATCH} (parting margins {margins}, each "
          f"must be under the error), {ms:.2f} ms a call, "
          f"{1e3 * tokens_n / ms:.0f} tokens/s [{card}] {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{label}: launches or logits off")
    del params
    return launches


def phase_prefill(card):
    """SmolLM-360M's prefill as served, bf16: 32 launches of the
    tensor-core kernel a call."""
    from repro_torch.configs import get_config

    return _prefill_check(card, get_config("smollm-360m"), "prefill", PREFILL_REL_TOL,
                          "flash_attention_tc")


def phase_prefill_fp32(card):
    """The same prefill in fp32 compute: 32 launches of the 3xTF32 kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("smollm-360m"), compute_dtype="float32")
    return _prefill_check(card, cfg, "prefill fp32", PREFILL_F32_REL_TOL,
                          "flash_attention_tf32")


def phase_prefill_fp32_odd_heads(card):
    """The fp32 prefill at a synthetic head dimension of 62 (hd % 4 != 0,
    the CUDA-core kernel's route; SmolLM-360M otherwise as published): 32
    launches of the CUDA-core kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("smollm-360m"), compute_dtype="float32",
                              head_dim=PREFILL_ODD_HEAD_DIM)
    return _prefill_check(card, cfg, f"prefill fp32 hd {PREFILL_ODD_HEAD_DIM}",
                          PREFILL_F32_REL_TOL, "flash_attention_fp32")


def _serve(argv, uids=None):
    """``launch.serve.run(argv)`` with every engine it builds recording the
    logits of ``uids`` (all when None) and timing its swaps (a patch of the
    engine class in this script)."""
    import time

    import torch

    import repro_torch.serve as serve_pkg
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import parity

    base = serve_pkg.ServeEngine

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits = parity.record_logits(self, uids)
            self.swap_s = {"out": [], "in": []}

        def _timed(self, key, fn, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            self.swap_s[key].append(time.perf_counter() - t0)

        def _swap_out(self, slot):
            self._timed("out", super()._swap_out, slot)

        def _restore_one(self, slot, rec, blocks):
            self._timed("in", super()._restore_one, slot, rec, blocks)

    serve_pkg.ServeEngine = Recording
    try:
        return launch_serve.run(argv)
    finally:
        serve_pkg.ServeEngine = base


def _oracle_check(res, reqs, label, card):
    from repro_torch.serve import generate_reference, parity

    for r in reqs:
        ref_logits = []
        ref = generate_reference(res["params"], res["cfg"], r.prompt, r.max_new_tokens,
                                 logits=ref_logits)
        limit = parity.LOGIT_LIMITS[res["cfg"].compute_dtype]
        c = parity.compare_tokens(r.out_tokens, ref, ref_logits, res["engine"].logits[r.uid],
                                  limit=limit)
        how = (f"logit error {c['err']:.3e} (limit {limit}), " + (
            "identical" if c["identical"] else
            f"part at token {c['at']}, reference top-2 margin {c['margin']:.3e}, "
            f"{'tie' if c['ok'] else 'NOT A TIE'}"))
        if not c["ok"] and c["err"] > limit:
            how += ", OVER THE LIMIT"
        print(f"  {label} request {r.uid} (prompt {len(r.prompt)}, preemptions "
              f"{r.n_preemptions}) vs generate_reference: {how} [{card}]", flush=True)
        if not c["ok"]:
            raise SystemExit(f"{label}: request {r.uid} diverged from the oracle")


def phase_serve(card):
    """The launcher at full width with serve_bench's geometry, 4 requests
    against the oracle, then an overloaded engine with swap preemption.
    Returns the main path's launches (the engine reaches no kernel)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import RequestState, is_terminal

    ops.reset_launches()
    res = _serve(SERVE_ARGS, uids=range(ORACLE_REQUESTS))
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches().items() if v}
    eng, s = res["engine"], res["engine"].stats
    done = [r for r in res["terminal"] if r.state is RequestState.FINISHED]
    n_tokens = sum(len(r.out_tokens) for r in done)
    ttft = sorted(1e3 * (r.t_first - r.t_submit) for r in done)
    tpot = [1e3 * (r.token_times[-1] - r.token_times[0]) / (len(r.token_times) - 1)
            for r in done if len(r.token_times) > 1]
    print(f"serve {res['cfg'].name} {res['cfg'].num_layers} layers "
          f"{res['cfg'].compute_dtype}: "
          f"{len(done)}/{len(res['terminal'])} finished, {n_tokens} tokens in "
          f"{res['seconds']:.2f} s ({n_tokens / res['seconds']:.1f} tokens/s), prefill "
          f"{s['prefill_time_s']:.2f} s over {s['n_prefill_dispatches']} chunks, decode "
          f"{s['decode_time_s']:.2f} s over {s['n_decode_dispatches']} ticks "
          f"({1e3 * s['decode_time_s'] / s['n_decode_dispatches']:.2f} ms a tick), "
          f"TTFT median {statistics.median(ttft):.1f} ms max {ttft[-1]:.1f} ms, "
          f"time per output token median {statistics.median(tpot):.2f} ms, fold distance "
          f"{res['fold'].max_distance:.2e}, launches {launches} [{card}]", flush=True)
    if len(done) != 32 or launches:
        raise SystemExit(f"serve: {len(done)} finished of 32, launches {launches}")
    _oracle_check(res, [r for r in res["requests"] if r.uid < ORACLE_REQUESTS],
                  "serve", card)
    del res, eng

    over = _serve([*SERVE_ARGS, "--blocks", str(OVERLOAD_BLOCKS), "--preemption", "swap"])
    eng, s = over["engine"], over["engine"].stats
    states = [r.state for r in over["requests"]]
    restored = [r for r in over["requests"]
                if r.n_preemptions and r.state is RequestState.FINISHED]
    out_ms = [1e3 * t for t in eng.swap_s["out"]]
    in_ms = [1e3 * t for t in eng.swap_s["in"]]
    print(f"serve overloaded ({OVERLOAD_BLOCKS} blocks, swap): "
          f"{sum(st is RequestState.FINISHED for st in states)}/32 finished, swapped out "
          f"{s['swapped_out']}, in {s['swapped_in']}, restored and finished "
          f"{len(restored)}; swap-out median {statistics.median(out_ms):.2f} ms, restore "
          f"median {statistics.median(in_ms):.2f} ms, {over['seconds']:.2f} s [{card}]",
          flush=True)
    if not (all(is_terminal(st) for st in states)
            and s["swapped_out"] >= 1 and s["swapped_in"] >= 1 and restored):
        raise SystemExit("serve overloaded: no swap round trip, or a request not terminal")
    _oracle_check(over, restored, "overloaded", card)
    return launches


def planned_kernels(path, shapes):
    """The kernel wrapper that each group of ``shapes`` (leaves of the same
    (p, n) stack into one group) runs on main path ``path``, by the
    planners of ``kernels/ops.py``: ``{wrapper name: groups}``."""
    from repro_torch.kernels import ops

    fused = path in ("fused", "landing_fused")
    stem = {"fused": "fused_step", "landing_fused": "fused_step",
            "pogo_adam": "pogo_update", "landing": "landing_field"}[path]
    suffix = "_landing" if path == "landing_fused" else ""
    out = {}
    for p, n in sorted({s[-2:] for s in shapes.values()}):
        if fused:
            kind = ops.plan(p, n, "landing" if suffix else "pogo")[0]
        else:
            kind = (ops.plan_pogo_update if stem == "pogo_update" else ops.plan_landing_field)(
                p, n)[0]
        name = {"whole": "landing_field" if stem == "landing_field" else f"{stem}_whole",
                "tc": f"{stem}_tiled_tc" + ("128" if p > 64 else ""),
                "tiled": f"{stem}_tiled", "cluster": f"{stem}_cluster",
                "large": f"{stem}_large", "large_tc": f"{stem}_large_tc"}[kind] + suffix
        out[name] = out.get(name, 0) + 1
    return out


def _expect_launches(label, launches, expected, steps):
    """Each kernel of ``expected`` (wrapper name -> groups) launched that
    many times per step, and no other kernel."""
    want = {name: steps * expected.get(name, 0) for name in launches}
    if launches != want or set(expected) - set(launches):
        raise SystemExit(f"{label}: launches {launches}, expected {want}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import smollm_360m
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import large_p
    from repro_torch.kernels import newton_schulz as ns
    from repro_torch.kernels import pogo_update as pu
    from repro_torch.kernels import tp_step as tp
    from repro_torch.models import ortho

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per source, together
        list(ex.map(build.compile_source, sources))
    fs._lib()
    fs.tc_lib()
    pu.lib()
    ns.lib()
    ns.tc_lib()
    fs.cluster_lib()
    tp.lib()
    fa.lib()
    fa.tc_lib()
    fa.tf32_lib()
    large_p.lib()
    for name in sources:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)
    # every value kept in registers
    for name in ("newton_schulz_tc", "small_p", "flash_attention_tf32"):
        spills = [line for line in build.PTXAS_LOG[name].splitlines()
                  if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        if spills:
            raise SystemExit(f"{name}.cu spills: {spills}")

    phase_tf32_probe(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = phase_fused_kernels(gen)
    phase_tc_repeatability(gen)
    records.update(phase_two_stage_kernels(gen))
    records.update(phase_newton_schulz(gen))
    phase_large_crossovers(gen)
    phase_cluster_crossovers(gen)
    records.update(phase_tp_kernels(gen))

    smollm = ortho.orthogonal_leaf_shapes(smollm_360m.config())
    paths = [  # (label, shapes, steps, path, feasibility limit, kernel)
        ("fused smollm-360m q/k", smollm, SMOLLM_STEPS, "fused", 1e-5,
         "fused_step_tiled_tc"),
        ("fused 2048x(16,256)", MANY, 10, "fused", 1e-5, "fused_step_whole"),
        ("fused internlm2-1.8b q/k", INTERNLM2, 3, "fused", 1e-5, "fused_step_tiled_tc128"),
        ("fused paper unitary-PC sizes", PAPER_PC, 3, "fused", 1e-5, "fused_step_cluster"),
        ("fused paper unitary-PC sizes, n = 9998", PAPER_PC_ODD, 3, "fused", 1e-5,
         "fused_step_tiled"),
        ("pogo+adam smollm-360m q/k", smollm, 10, "pogo_adam", 1e-5,
         "pogo_update_tiled_tc"),
        ("pogo+adam 2048x(16,256)", MANY, 10, "pogo_adam", 1e-5, "pogo_update_whole"),
        ("pogo+adam internlm2-1.8b q/k", INTERNLM2, 3, "pogo_adam", 1e-5,
         "pogo_update_tiled_tc128"),
        ("pogo+adam paper unitary-PC sizes", PAPER_PC, 3, "pogo_adam", 1e-5,
         "pogo_update_cluster"),
        ("pogo+adam paper unitary-PC sizes, n = 9998", PAPER_PC_ODD, 3, "pogo_adam", 1e-5,
         "pogo_update_tiled"),
        ("landing smollm-360m q/k", smollm, 10, "landing", 0.5, "landing_field_tiled_tc"),
        ("landing 2048x(16,256)", MANY, 10, "landing", 0.5, "landing_field"),
        ("landing internlm2-1.8b q/k", INTERNLM2, 3, "landing", 0.5,
         "landing_field_tiled_tc128"),
        ("landing paper unitary-PC sizes", PAPER_PC, 3, "landing", 0.5,
         "landing_field_cluster"),
        ("landing paper unitary-PC sizes, n = 9998", PAPER_PC_ODD, 3, "landing", 0.5,
         "landing_field_tiled"),
        ("landing fused smollm-360m q/k", smollm, 10, "landing_fused", 0.5,
         "fused_step_tiled_tc_landing"),
        ("landing fused 2048x(16,256)", MANY, 10, "landing_fused", 0.5,
         "fused_step_whole_landing"),
        ("landing fused internlm2-1.8b q/k", INTERNLM2, 3, "landing_fused", 0.5,
         "fused_step_tiled_tc128_landing"),
        ("landing fused paper unitary-PC sizes", PAPER_PC, 3, "landing_fused", 0.5,
         "fused_step_cluster_landing"),
        ("landing fused paper unitary-PC sizes, n = 9998", PAPER_PC_ODD, 3, "landing_fused",
         0.5, "fused_step_tiled_landing"),
    ]
    # The paper's CNN filters (one step runs the whole, tensor-core, wide
    # and large routes, one group each) and O-ViT (the large route alone).
    for path, max_dist, what in (("fused", 1e-5, "fused"),
                                 ("pogo_adam", PAPER_DIRECT_GRAM_LIMIT, "pogo+adam"),
                                 ("landing", 0.5, "landing"),
                                 ("landing_fused", 0.5, "landing fused")):
        paths += [(f"{what} paper CNN filters", CNN, 3, path, max_dist, None),
                  (f"{what} paper O-ViT", OVIT, 3, path, max_dist, None),
                  (f"{what} n % 4 != 0, {LARGE_ODD[0]}x{LARGE_ODD[1:]}", {"odd": LARGE_ODD}, 3,
                   path, max_dist, "{}_large" + ("_landing" if path == "landing_fused" else ""))]
    launches = {}
    for label, shapes, steps, path, max_dist, kernel in paths:
        expected = planned_kernels(path, shapes)
        if kernel is not None and "{}" in kernel:
            kernel = kernel.format({"fused": "fused_step", "landing_fused": "fused_step",
                                    "pogo_adam": "pogo_update", "landing": "landing_field"}[path])
        if kernel is not None and expected != {kernel: 1}:
            raise SystemExit(f"{label}: the planners now pick {expected}, not {kernel}")
        counts = drive_main_path(gen, shapes, label, steps, card,
                                 functools.partial(make_opt, path), max_dist)
        _expect_launches(label, counts, expected, steps)
        for name in expected:
            launches[name] = launches.get(name, 0) + counts[name]
    repairs = phase_landing_watchdog(gen, card)
    launches["newton_schulz"] = repairs["newton_schulz_tiled"]
    launches["newton_schulz_cluster"] = repairs["newton_schulz_cluster"]
    launches["newton_schulz_tc128"] = repairs["newton_schulz_tc128"]
    launches["newton_schulz_stream"] = repairs["newton_schulz_stream"]
    launches["newton_schulz_large"] = repairs["newton_schulz_large"]
    launches["newton_schulz_large_tc"] = repairs["newton_schulz_large_tc"]
    phase_tp_schedule(gen, card)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        launches.update(phase_tp_ranks(card, workdir))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        counts = phase_trainer(card, workdir)
    launches["newton_schulz_tc"] = counts["newton_schulz_tc"]
    records.update(phase_flash_attention(gen, card))
    launches["flash_attention_tc"] = phase_prefill(card)["flash_attention_tc"]
    launches["flash_attention_tf32"] = phase_prefill_fp32(card)["flash_attention_tf32"]
    launches["flash_attention"] = phase_prefill_fp32_odd_heads(card)["flash_attention_fp32"]
    phase_serve(card)

    kernels = [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/kernels/csrc/{source}.cu", replaces=replaces,
             launches=launches[name], **{"library_ms": None, **records[name]})
        for name, (source, replaces) in KERNELS.items()
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase_tp_ranks
        sys.exit(tp_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
