"""The large-p route: gram-then-apply launches of ``csrc/large_p.cu``.

For p > 128 one matrix's (p, p) grams no longer fit one block's shared
memory (at p = 256 one fp32 gram is 256 KB), so the group step runs as the
TPU's tiled kernels do, in phases with the (p, p) operands between them,
here in HBM and L2: grams ``O = L R^T`` over n (``large_gram``) and applies
``out = f(base, P_1 Y_1, ...)`` (``large_apply``), each spread over many
blocks. This module holds the library, the two launch helpers and the
phases that the four wrappers share: ``fused_step.fused_step_large`` (and
its Landing branch), ``pogo_update.pogo_update_large``,
``landing_field.landing_field_large`` and
``newton_schulz.newton_schulz_large``.

:class:`Runner` carries the loaded library, the stream and the SM count,
so that the CPU tests can run the same phases through the g++-emulated
build of the source (``tests/cuda_emu/large_p_harness.cpp``) on CPU
tensors. Grams are stored ``(B, Pp, Pp)`` with ``Pp`` = p rounded up to
64 and zero past p. A gram splits n into slices when its tiles alone
would leave the card idle (:func:`slices`); their partials are summed in
a fixed order, so every launch repeats bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
TILE = 64  # kT: output tiles are 64 x 64
CHUNK = 32  # kK: slices are whole chunks
# The fewest columns a gram's n-slice takes: below it the slices' partials
# (a 64 x 64 tile each) cost more to write and sum than the columns.
MIN_SLICE = 256
OPS = {"leap": 0, "land": 1, "land_step": 2, "field": 3, "ns": 4}  # ApplyOp
BASE_KINDS = {"none": 0, "trace": 1, "vadam": 2}


def lib() -> ctypes.CDLL:
    """The loaded ``large_p.cu`` library, built on first use."""
    lib_ = build.load("large_p")
    if not getattr(lib_, "_typed", False):
        type_library(lib_)
    return lib_


def type_library(lib_: ctypes.CDLL) -> None:
    """Set the C signatures of ``large_p.cu``'s entries on ``lib_`` (the
    card's build, or the emulated one of the CPU tests)."""
    lib_.large_gram.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    lib_.large_apply.argtypes = [_I] + [_P] * 9 + [_I] * 4 + [_P]
    lib_.large_padded.argtypes = [_I]
    lib_.large_gram_tiles.argtypes = [_I, _I]
    for fn in (lib_.large_gram, lib_.large_apply, lib_.large_padded,
               lib_.large_gram_tiles):
        fn.restype = _I
    lib_._typed = True


def padded(p: int) -> int:
    """Row stride and row count of a stored gram (``large_padded``)."""
    return -(-p // TILE) * TILE


def gram_tiles(p: int, moments: bool) -> int:
    """Output tiles of a gram (``large_gram_tiles``): all of phase 1's,
    or a self gram's on and above the diagonal."""
    nt = -(-p // TILE)
    return nt * nt if moments else nt * (nt + 1) // 2


def slices(bsz: int, tiles: int, n: int, sms: int,
           min_slice: int = MIN_SLICE) -> tuple[int, int]:
    """``(slices, slice_len)`` of a gram's n-axis: enough slices that
    ``bsz x tiles x slices`` blocks fill the card twice over, none shorter
    than ``min_slice`` columns, each a whole number of 32-column chunks."""
    want = -(-2 * sms // (bsz * tiles))
    count = max(1, min(want, n // min_slice))
    length = -(-(-(-n // count)) // CHUNK) * CHUNK
    return -(-n // length), length


@dataclasses.dataclass
class Runner:
    """Where the phases launch: the library (``lib()``, or the CPU tests'
    emulated build), the CUDA stream (None there) and the SM count that
    :func:`slices` fills. ``min_slice`` lets the tests split small n."""

    lib: ctypes.CDLL
    stream: int | None
    sms: int
    min_slice: int = MIN_SLICE
    launches: int = 0  # CUDA launches through this runner (each slice sum too)


def runner(x: torch.Tensor) -> Runner:
    """The card's runner for a CUDA tensor: its current stream, its SMs."""
    props = torch.cuda.get_device_properties(x.device)
    return Runner(lib(), torch.cuda.current_stream(x.device).cuda_stream,
                  props.multi_processor_count)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"large_p {what} launch failed for (B, p, n) = "
                           f"{tuple(shape)}: cudaError {err}")


def gram(run: Runner, x, *, g=None, mu=None, mu_out=None, scal=None,
         base_kind: str = "none", nesterov: bool = False, mask=None):
    """A gram of the ``(B, p, n)`` stack ``x``. With ``g`` (phase 1):
    ``(A, BT, sq)``, ``A = X X^T`` and ``BT = Geu X^T``, Geu formed from
    ``g`` and ``mu`` by the base stage, which writes mu' to ``mu_out``
    (never ``mu`` itself) and vadam's per-block sums of g^2 to ``sq``
    (``(B, -)``, else None). Else ``(X X^T, None, None)``. ``mask`` skips
    the matrices it clears (their grams stay unwritten)."""
    bsz, p, n = x.shape
    moments = g is not None
    tiles = gram_tiles(p, moments)
    count, length = slices(bsz, tiles, n, run.sms, run.min_slice)
    pp = padded(p)
    out0 = x.new_empty((bsz, pp, pp))
    out1 = x.new_empty((bsz, pp, pp)) if moments else None
    part = x.new_empty((bsz * tiles * count * (2 if moments else 1) * TILE * TILE,)) \
        if count > 1 else None
    sq = x.new_empty((bsz, -(-p // TILE) * count)) \
        if moments and base_kind == "vadam" else None
    err = run.lib.large_gram(
        _ptr(x), _ptr(g), _ptr(mu), _ptr(mu_out), _ptr(scal), _ptr(sq), _ptr(mask),
        _ptr(out0), _ptr(out1), _ptr(part), bsz, p, n, count, length, int(moments),
        BASE_KINDS[base_kind], int(nesterov), run.stream)
    _check(err, "gram", x.shape)
    run.launches += 2 if count > 1 else 1
    return out0, out1, sq


def apply(run: Runner, op: str, pa, ya, out, *, scal, pb=None, yg=None, x=None,
          scol=None, mask=None, first: bool = False):
    """``out = op(...)`` over the ``(B, p, n)`` stack (``large_apply``):
    ``pa`` (and ``pb``) stored grams, ``ya`` the Y of ``pa``'s product
    (with ``yg``: Geu = h0 ya + yg), ``x`` the Y of B X and A X and the
    base of ``leap``, ``land_step`` and ``field``. ``out`` may alias no Y
    operand: a block reads every row of its column tile of each."""
    bsz, p, n = ya.shape
    for t in (ya, yg, x):
        if t is not None and t.data_ptr() == out.data_ptr():
            raise ValueError(f"large_p {op}: out must not alias an operand")
    err = run.lib.large_apply(
        OPS[op], _ptr(pa), _ptr(pb), _ptr(ya), _ptr(yg), _ptr(x), _ptr(scal),
        _ptr(scol), _ptr(mask), _ptr(out), bsz, p, n, int(first), run.stream)
    _check(err, op, ya.shape)
    run.launches += 1
    return out


def fused(run: Runner, x, g, scal, *, method: str, lam: float, base_kind: str,
          nesterov: bool, mu, nu, pv, inplace: bool):
    """The fused group step as ``repro/kernels/fused_step.py:608-721``'s
    phases: phase 1's gram with the base stage; the inter-phase scalars
    (vadam's nu' and s, O(B) torch ops as JAX does them in jnp); POGO's M,
    C = M M^T and X' = (1 + lam) M - lam C M with the distance from the
    gram identity on C (torch products, plain XLA in JAX), or Landing's X'
    and the distance from W = X' X'^T. ``scal`` is ``fused_step.pack_scal``'s
    vector. Returns ``(x', mu', nu', dist, finite)``; ``inplace`` writes
    them over ``x``, ``mu`` and ``nu`` (mu' through a scratch: phase 1 reads
    mu after the blocks of tile column 0 have written their mu')."""
    p = x.shape[1]
    mu2 = torch.empty_like(mu) if base_kind != "none" else None
    a, bt, sq = gram(run, x, g=g, mu=mu, mu_out=mu2, scal=scal, base_kind=base_kind,
                     nesterov=nesterov)
    scol = nu2 = None
    if base_kind == "vadam":
        b2, eps, c1, c2 = scal[4], scal[5], scal[6], scal[7]
        nu2 = b2 * nu + (1.0 - b2) * sq.sum(dim=1)
        scol = ((scal[2] / c1) / (torch.sqrt(nu2 / c2) + eps)).contiguous()
    geu = dict(ya=g) if base_kind == "none" else dict(ya=mu2, yg=g if nesterov else None)
    if method == "pogo":
        m = torch.empty_like(x)
        apply(run, "leap", a, out=m, pb=bt, x=x, scal=scal, scol=scol, **geu)
        c = gram(run, m)[0]
        x_out = x if inplace else torch.empty_like(x)
        apply(run, "land", c, m, x_out, scal=scal)
        w = ref.pogo_gram_identity_ref(c[:, :p, :p], lam)
    else:
        x2 = torch.empty_like(x)
        apply(run, "land_step", a, out=x2, pb=bt, x=x, scal=scal, scol=scol, **geu)
        w = gram(run, x2)[0][:, :p, :p]
        x_out = x.copy_(x2) if inplace else x2
    dist = ref._residual_norm(w, pv).to(torch.float32)
    if inplace:
        mu2 = mu.copy_(mu2) if mu2 is not None else None
        nu2 = nu.copy_(nu2) if nu2 is not None else None
    return x_out, mu2, nu2, dist, torch.isfinite(dist)


def pogo_update(run: Runner, x, g, scal, out):
    """POGO's update ``X' = (1 + lam) M - lam (M M^T) M``, ``M = X - eta/2
    (A G - B X)``, as ``repro/kernels/pogo_update.py:143``'s three phases:
    A and BT; M into a scratch; C; X' into ``out`` (which may be ``x``:
    the last phase reads M alone)."""
    a, bt, _ = gram(run, x, g=g, scal=scal)
    m = torch.empty_like(x)
    apply(run, "leap", a, g, m, pb=bt, x=x, scal=scal)
    c = gram(run, m)[0]
    return apply(run, "land", c, m, out, scal=scal)


def landing_field(run: Runner, x, g, scal, out):
    """Landing's field ``1/2 (A G - B X) + lam (A X - X)`` as
    ``repro/kernels/landing_field.py:79``'s two phases."""
    a, bt, _ = gram(run, x, g=g, scal=scal)
    return apply(run, "field", a, g, out, pb=bt, x=x, scal=scal)


def newton_schulz(run: Runner, x, iters: int, out, mask, dist):
    """``iters`` Newton-Schulz iterations of the ``(B, p, n)`` stack into
    ``out``: a self gram and an apply each, ping-ponging between ``out``
    and a scratch so that no apply writes over the iterate it reads (the
    last lands in ``out``), the Frobenius prescale read off the first
    gram's trace; then, with ``dist``, ``||Y Y^T - I||_F`` of every
    matrix that ``mask`` selects (all without one)."""
    if iters < 1:
        raise ValueError(f"the large Newton-Schulz route takes iters >= 1, got {iters}")
    p = x.shape[1]
    tmp = torch.empty_like(x)
    src = x
    if iters % 2 and out.data_ptr() == x.data_ptr():
        src = tmp.copy_(x)  # iteration 1 writes out, which is x
    for k in range(1, iters + 1):
        dst = out if (iters - k) % 2 == 0 else tmp
        gm = gram(run, src, mask=mask)[0]
        apply(run, "ns", gm, src, dst, scal=None, mask=mask, first=k == 1)
        src = dst
    if dist is not None:
        d = ref._residual_norm(gram(run, out, mask=mask)[0][:, :p, :p]).to(torch.float32)
        dist.copy_(d if mask is None else torch.where(mask, d, dist))
    return out
