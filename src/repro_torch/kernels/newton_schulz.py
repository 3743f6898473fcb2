"""Wrappers of the Newton-Schulz kernels (``csrc/newton_schulz.cu``,
``csrc/newton_schulz_tc.cu``, ``csrc/small_p.cu``).

``newton_schulz_whole`` and ``newton_schulz_tiled`` replace
``repro/kernels/newton_schulz.py:37`` (``_ns_kernel``): one CTA per
``(p, n)`` matrix, with Y resident in shared memory (whole) or swept in
column tiles through the output buffer (tiled), IEEE fp32 on the CUDA
cores. ``newton_schulz_tc`` replaces the same TPU kernel on the tensor
cores for p <= 64: one thread block cluster per matrix, Y kept in its
CTAs' shared memory for every iteration, 3xTF32 ``wgmma``, the partial
grams summed through distributed shared memory. ``newton_schulz_tc128``
is its counterpart for 64 < p <= 128 (same source): clusters of up to 16
CTAs, two 64-column chunks of Y a CTA, the gram reduce-scattered and
gathered over distributed shared memory, a persistent grid of clusters
walking the stack. ``newton_schulz_stream`` (same source, row 9s) takes the
same p past n = 2048, at n % 4 == 0: Y streams through a TMA ring in the
shared memory of one CTA a matrix once an iteration (one read and one write
of Y). ``newton_schulz_cluster`` (``csrc/small_p.cu``, row
9cl) replaces it for p < 32 at n % 4 == 0: one matrix a thread block
cluster of 2, 4 or 8 CTAs, Y held in their shared memory through every
iteration (IEEE fp32 on the CUDA cores), a persistent grid of clusters
walking the stack. ``newton_schulz_large``
(``csrc/large_p.cu``) replaces it for p > 128 (past p = 136 the CUDA-core
tiled kernel's two (p, p) grams outgrow a block; below, it lost to the
large route on the card): each iteration a gram launch and an apply
launch, the gram between them in HBM and L2, all issued by one C call, on
the CUDA cores where n % 4 != 0; ``newton_schulz_large_tc`` is the same
on the tensor cores (3xTF32 ``wgmma`` fed by TMA), the route at n % 4 ==
0.

All of them take a ``(B, p, n)`` fp32 stack ``x`` and write
``NS_iters(x / ||x||_F)`` to ``out`` (a new tensor, or ``x`` itself).
``mask`` (a ``(B,)`` bool tensor, with ``out=x``) limits the work to the
matrices it selects: the others keep their values and their ``dist``
entries bit for bit. ``dist`` (``(B,)`` fp32), where given, receives ``||Y Y^T - I||_F``
of every processed matrix. On a CPU tensor they run the plain version
(``ref.newton_schulz_ref``); on a CUDA tensor they check the operands,
launch on the current stream and raise if the launch fails. There is no
fallback. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build, large_p, ref
from .fused_step import check_operand, cluster_lib

_P = ctypes.c_void_p
_I = ctypes.c_int


def tc_lib() -> ctypes.CDLL:
    """The loaded ``newton_schulz_tc.cu`` library, built on first use."""
    lib_ = build.load("newton_schulz_tc")
    if not getattr(lib_, "_typed", False):
        lib_.newton_schulz_tc.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib_.newton_schulz_tc128.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib_.ns_tc_cluster.argtypes = [_I]
        lib_.ns_tc_smem_bytes.argtypes = [_I]
        lib_.ns_tc128_cluster.argtypes = [_I]
        lib_.ns_tc128_smem_bytes.argtypes = [_I]
        lib_.ns_tc128_max_clusters.argtypes = [_I]
        lib_.newton_schulz_stream.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib_.ns_stream_smem_bytes.argtypes = []
        lib_.ns_stream_max_clusters.argtypes = []
        for fn in (lib_.newton_schulz_tc, lib_.newton_schulz_tc128, lib_.ns_tc_cluster,
                   lib_.ns_tc_smem_bytes, lib_.ns_tc128_cluster, lib_.ns_tc128_smem_bytes,
                   lib_.ns_tc128_max_clusters, lib_.newton_schulz_stream,
                   lib_.ns_stream_smem_bytes, lib_.ns_stream_max_clusters):
            fn.restype = _I
        lib_._typed = True
    return lib_


def lib() -> ctypes.CDLL:
    """The loaded ``newton_schulz.cu`` library, built on first use."""
    lib_ = build.load("newton_schulz")
    if not getattr(lib_, "_typed", False):
        lib_.newton_schulz_whole.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib_.newton_schulz_tiled.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib_.ns_whole_smem_bytes.argtypes = [_I, _I]
        lib_.ns_tiled_smem_bytes.argtypes = [_I, _I]
        for fn in (lib_.newton_schulz_whole, lib_.newton_schulz_tiled,
                   lib_.ns_whole_smem_bytes, lib_.ns_tiled_smem_bytes):
            fn.restype = _I
        lib_._typed = True
    return lib_


def run_plain(x, iters, *, out, mask=None, dist=None):
    """The plain version with the wrappers' ``out``/``mask``/``dist``."""
    y = ref.newton_schulz_ref(x, iters)
    d = ref.manifold_distance_ref(y) if dist is not None else None
    if mask is not None:
        y = torch.where(mask[:, None, None], y, x)
        if d is not None:
            d = torch.where(mask, d, dist)
    out.copy_(y)
    if d is not None:
        dist.copy_(d)
    return out


def _check_operands(x, out, mask, dist):
    if x.dim() != 3:
        raise ValueError(f"x must be a (B, p, n) stack, got {tuple(x.shape)}")
    dev = x.device
    bsz = x.shape[0]
    check_operand("x", x, tuple(x.shape), torch.float32, dev)
    check_operand("out", out, tuple(x.shape), torch.float32, dev)
    if mask is not None:
        check_operand("mask", mask, (bsz,), torch.bool, dev)
    if dist is not None:
        check_operand("dist", dist, (bsz,), torch.float32, dev)


def _launch(entry, x, iters, out, mask, dist, *extra, lib=lib):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_operands(x, out, mask, dist)
    dev = x.device

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib(), entry)(ptr(x), ptr(out), ptr(mask), ptr(dist),
                                    *x.shape, int(iters), *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry} kernel launch failed for (B, p, n) = {tuple(x.shape)}: "
            f"cudaError {err}"
        )
    return out


def _run(entry, x, iters, out, mask, dist, *extra, lib=lib):
    out = torch.empty_like(x) if out is None else out
    if mask is not None and out is not x:
        raise ValueError("a mask needs out=x: masked-off matrices keep x")
    if x.device.type == "cpu":
        return run_plain(x, iters, out=out, mask=mask, dist=dist)
    return _launch(entry, x, iters, out, mask, dist, *extra, lib=lib)


def newton_schulz_whole(x, iters=12, *, out=None, mask=None, dist=None):
    """Whole-matrix Newton-Schulz: one CTA per ``(p, n)`` matrix, Y in
    shared memory for all iterations (``ops.ns_whole_smem_bytes``)."""
    res = _run("newton_schulz_whole", x, iters, out, mask, dist)
    if x.device.type == "cuda":
        newton_schulz_whole.launches += 1
    return res


def newton_schulz_tiled(x, iters=12, *, tile_n=64, out=None, mask=None,
                        dist=None):
    """Tiled Newton-Schulz: one CTA per matrix sweeping ``tile_n``-wide
    column tiles of Y in place, once per iteration, with two (p, p) grams
    in shared memory (``ops.ns_tiled_smem_bytes``)."""
    res = _run("newton_schulz_tiled", x, iters, out, mask, dist, int(tile_n))
    if x.device.type == "cuda":
        newton_schulz_tiled.launches += 1
    return res


def newton_schulz_tc(x, iters=12, *, out=None, mask=None, dist=None):
    """Tensor-core Newton-Schulz for ``p <= 64``: one cluster of
    ``ops.ns_tc_cluster(n)`` CTAs per matrix, each keeping its 64-column
    chunks of Y in shared memory through every iteration
    (``ops.ns_tc_smem_bytes``)."""
    res = _run("newton_schulz_tc", x, iters, out, mask, dist, lib=tc_lib)
    if x.device.type == "cuda":
        newton_schulz_tc.launches += 1
    return res


def newton_schulz_tc128(x, iters=12, *, out=None, mask=None, dist=None):
    """Tensor-core Newton-Schulz for ``64 < p <= 128`` (any p <= 128
    runs, but its products keep 128 rows: at p <= 64 ``newton_schulz_tc``
    is about 4x faster, the readings beside ``ops.NS_TC_MAX_P``): clusters of ``ops.ns_tc128_cluster(n)`` CTAs (16 at n = 2048),
    each keeping at most two 64-column chunks of Y in shared memory
    through every iteration (``ops.ns_tc128_smem_bytes``), as many
    clusters as the card keeps resident walking the stack."""
    res = _run("newton_schulz_tc128", x, iters, out, mask, dist, lib=tc_lib)
    if x.device.type == "cuda":
        newton_schulz_tc128.launches += 1
    return res


def newton_schulz_stream(x, iters=12, *, out=None, mask=None, dist=None):
    """Tensor-core Newton-Schulz for ``64 < p <= 128`` past n = 2048 (any
    p <= 128 runs), n % 4 == 0 with 16-byte aligned rows and at least
    ``ops.NS_STREAM_STAGES`` 64-column chunks: one matrix a CTA, streaming
    its chunks of Y through a ring of TMA stages once an iteration
    (``ops.ns_stream_smem_bytes``); a persistent grid of one CTA an SM
    walks the stack."""
    res = _run("newton_schulz_stream", x, iters, out, mask, dist, lib=tc_lib)
    if x.device.type == "cuda":
        newton_schulz_stream.launches += 1
    return res


def newton_schulz_cluster(x, iters=12, *, out=None, mask=None, dist=None, cluster=None):
    """Newton-Schulz for p < 32, n % 4 == 0: one matrix a thread block
    cluster of ``ops.ns_cluster(p, n)`` CTAs (``cluster`` forces 2, 4 or
    8), each holding its columns of Y in shared memory through every
    iteration (``ops.ns_cluster_smem_bytes``), as many clusters as the card
    keeps resident walking the stack."""
    if cluster:
        res = _run("newton_schulz_cluster_c", x, iters, out, mask, dist, int(cluster),
                   lib=cluster_lib)
    else:
        res = _run("newton_schulz_cluster", x, iters, out, mask, dist, lib=cluster_lib)
    if x.device.type == "cuda":
        newton_schulz_cluster.launches += 1
    return res


def newton_schulz_large(x, iters=12, *, out=None, mask=None, dist=None,
                        runner=None):
    """Newton-Schulz for p > 128 (``csrc/large_p.cu``): each iteration a
    self gram and an apply spread over many blocks, ping-ponging between
    ``out`` and a scratch, the Frobenius prescale read off the first
    gram's trace (``large_p.newton_schulz``); the matrices that ``mask``
    clears are neither read nor written, nor are their ``dist`` entries.
    ``runner`` (a ``large_p.Runner``) launches elsewhere than on x's card:
    the CPU tests' emulated build."""
    out = torch.empty_like(x) if out is None else out
    if mask is not None and out is not x:
        raise ValueError("a mask needs out=x: masked-off matrices keep x")
    if runner is None and x.device.type == "cpu":
        return run_plain(x, iters, out=out, mask=mask, dist=dist)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_operands(x, out, mask, dist)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.newton_schulz(runner or large_p.runner(x), x, iters, out, mask, dist)
    newton_schulz_large.launches += 1
    return out


def newton_schulz_large_tc(x, iters=12, *, out=None, mask=None, dist=None,
                           runner=None):
    """:func:`newton_schulz_large` on the tensor cores
    (``large_p.newton_schulz_tc``: one C call that issues every 3xTF32
    gram and apply, n % 4 == 0; each iteration writes Y + E (-Y/2), E = Y
    Y^T - I)."""
    out = torch.empty_like(x) if out is None else out
    if mask is not None and out is not x:
        raise ValueError("a mask needs out=x: masked-off matrices keep x")
    if runner is None and x.device.type == "cpu":
        return run_plain(x, iters, out=out, mask=mask, dist=dist)
    if runner is None and x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_operands(x, out, mask, dist)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
        large_p.newton_schulz_tc(runner or large_p.runner(x), x, iters, out, mask, dist)
    newton_schulz_large_tc.launches += 1
    return out


newton_schulz_whole.launches = 0
newton_schulz_tiled.launches = 0
newton_schulz_tc.launches = 0
newton_schulz_tc128.launches = 0
newton_schulz_stream.launches = 0
newton_schulz_cluster.launches = 0
newton_schulz_large.launches = 0
newton_schulz_large_tc.launches = 0
