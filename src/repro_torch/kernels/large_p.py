"""The large-p route: gram-then-apply launches of ``csrc/large_p.cu``.

For p > 128 one matrix's (p, p) grams no longer fit one block's shared
memory (at p = 256 one fp32 gram is 256 KB), so the group step runs as the
TPU's tiled kernels do, in phases with the (p, p) operands between them,
here in HBM and L2: grams ``O = L R^T`` over n and applies ``out =
f(base, P_1 Y_1, ...)``, each spread over many blocks. Two sets of
kernels do it: on the tensor cores (``large_tc_*``: 3xTF32 ``wgmma`` fed
by TMA, the (p, p) operands stored with their lo pieces; ``*_tc`` below,
the wrappers ``fused_step.fused_step_large_tc`` and its Landing branch,
``pogo_update.pogo_update_large_tc``, ``landing_field.landing_field_large_tc``
and ``newton_schulz.newton_schulz_large_tc``) where n % 4 == 0, and on the
CUDA cores (``large_gram``, ``large_apply``; the wrappers without
``_tc``) where a row stride TMA cannot take. This module holds the
library, the launch helpers and the phases those wrappers share.

:class:`Runner` carries the loaded library, the stream and the SM count,
so that the CPU tests can run the same phases through the g++-emulated
build of the source (``tests/cuda_emu/large_p_harness.cpp``) on CPU
tensors. The CUDA cores' grams are stored ``(B, Pp, Pp)`` with ``Pp`` = p
rounded up to 64, the tensor cores' ``(B, Pq, Pq)`` with ``Pq`` = p
rounded up to 128, zero past p. A gram splits n into slices when its
blocks alone would leave the card idle (:func:`slices`); their partials
are summed in a fixed order, so every launch repeats bit for bit.
Newton-Schulz's iterations go to the card in one C call on either route.
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
OPS = {"leap": 0, "land": 1, "land_step": 2, "field": 3, "ns": 4, "identity": 5}  # ApplyOp
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
    lib_.large_newton_schulz.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib_.large_tc_gram.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib_.large_tc_apply.argtypes = [_I] + [_P] * 11 + [_I] * 4 + [_P]
    lib_.large_base_stage.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib_.large_base_blocks.argtypes = [_I, _I]
    lib_.large_tc_apply_items.argtypes = [_I, _I]
    lib_.large_tc_newton_schulz.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    lib_.large_tc_padded.argtypes = [_I]
    lib_.large_tc_gram_blocks.argtypes = [_I, _I]
    for fn in (lib_.large_gram, lib_.large_apply, lib_.large_padded,
               lib_.large_gram_tiles, lib_.large_newton_schulz, lib_.large_tc_gram,
               lib_.large_tc_apply, lib_.large_tc_newton_schulz, lib_.large_tc_padded,
               lib_.large_tc_gram_blocks, lib_.large_tc_apply_items, lib_.large_base_stage,
               lib_.large_base_blocks):
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


def _ns_start(x, iters: int, out):
    """The scratch of a Newton-Schulz ping-pong and the stack its first
    iteration reads: a copy of x in the scratch when ``out`` is x and
    ``iters`` is odd (iteration 1 writes out)."""
    if iters < 1:
        raise ValueError(f"the large Newton-Schulz route takes iters >= 1, got {iters}")
    tmp = torch.empty_like(x)
    src = tmp.copy_(x) if iters % 2 and out.data_ptr() == x.data_ptr() else x
    return tmp, src


def newton_schulz(run: Runner, x, iters: int, out, mask, dist):
    """``iters`` Newton-Schulz iterations of the ``(B, p, n)`` stack into
    ``out`` by ``large_newton_schulz``, one C call that issues every gram,
    slice sum and apply (a self gram and an apply an iteration,
    ping-ponging between ``out`` and a scratch so that no apply writes over
    the iterate it reads; the Frobenius prescale read off the first gram's
    trace); then, with ``dist``, ``||Y Y^T - I||_F`` of every matrix that
    ``mask`` selects (all without one)."""
    bsz, p, n = x.shape
    tmp, src = _ns_start(x, iters, out)
    tiles = gram_tiles(p, False)
    count, length = slices(bsz, tiles, n, run.sms, run.min_slice)
    pp = padded(p)
    gm = x.new_empty((bsz, pp, pp))
    part = x.new_empty((bsz * tiles * count * TILE * TILE,)) if count > 1 else None
    err = run.lib.large_newton_schulz(
        _ptr(src), _ptr(out), _ptr(tmp), _ptr(gm), _ptr(part), _ptr(mask), bsz, p, n, iters,
        count, length, run.stream)
    _check(err, "newton-schulz", x.shape)
    run.launches += iters * (3 if count > 1 else 2)
    if dist is not None:
        d = ref._residual_norm(gram(run, out, mask=mask)[0][:, :p, :p]).to(torch.float32)
        dist.copy_(d if mask is None else torch.where(mask, d, dist))
    return out


# ------------------------------------------------------- the tensor cores
#
# The same phases on csrc/large_p.cu's tensor-core kernels (``large_tc_*``,
# n % 4 == 0): the base stage as its own launch, then grams that store
# their (p, p) operands (B, Pq, Pq), Pq = p rounded up to TC_BLOCK, each
# with its lo pieces (phase 1: the self gram E_A = X X^T - I and the cross
# gram B = X Geu^T; later self grams E = G - I); every apply writes its
# output as its base plus a correction on the tensor cores.

TC_BLOCK = 128  # a tensor-core gram or apply block is 128 x 128
DSQ_SLOTS = 8  # kDsqSlots: a gram block's parts of its distance


def tc_padded(p: int) -> int:
    """Row stride and row count of a tensor-core gram (``large_tc_padded``)."""
    return -(-p // TC_BLOCK) * TC_BLOCK


def tc_gram_blocks(p: int, cross: bool) -> int:
    """Blocks of a tensor-core gram (``large_tc_gram_blocks``), 128 x 128
    each: all of a cross gram's, or a self gram's on and above the
    diagonal."""
    nb = tc_padded(p) // TC_BLOCK
    return nb * nb if cross else nb * (nb + 1) // 2


def gram_tc(run: Runner, x, *, g=None, mask=None, eye: bool = True, lo: bool = True,
            dist: bool = False, pv=None):
    """A tensor-core gram of the ``(B, p, n)`` stack ``x``, ``(G, G lo, d)``:
    the self gram ``X X^T``, minus the identity when ``eye``, or with ``g``
    the cross gram ``X g^T`` (phase 1's B, ``g`` the Geu of
    :func:`base_stage`, or g itself; no identity). With ``dist`` (a self
    gram) ``d = ||G + I_p - I_pv||_F`` per matrix (``pv`` valid-row
    counts, or None), its squares summed in the kernel, else None. ``lo``
    False skips the lo pieces (None). ``mask`` skips the matrices it
    clears."""
    bsz, p, n = x.shape
    cross = g is not None
    blocks = tc_gram_blocks(p, cross)
    count, length = slices(bsz, blocks, n, run.sms, run.min_slice)
    pq = tc_padded(p)
    out = x.new_empty((bsz, pq, pq))
    lo_ = x.new_empty((bsz, pq, pq)) if lo else None
    part = x.new_empty((bsz * blocks * count * TC_BLOCK * TC_BLOCK,)) if count > 1 else None
    dsq = x.new_empty((bsz, DSQ_SLOTS * blocks)) if dist else None
    err = run.lib.large_tc_gram(
        _ptr(x), _ptr(g), _ptr(mask), _ptr(pv), _ptr(out), _ptr(lo_), _ptr(part), _ptr(dsq),
        bsz, p, n, count, length, int(eye and not cross), run.stream)
    _check(err, "tensor-core gram", x.shape)
    run.launches += 2 if count > 1 else 1
    return out, lo_, torch.sqrt(dsq.sum(dim=1)) if dist else None


def base_stage(run: Runner, g, mu, scal, base_kind: str, nesterov: bool):
    """Phase 1's base stage on the tensor-core route (``large_base_stage``):
    ``(mu', Geu, sq)``: mu' and (nesterov) Geu = h0 mu' + g new stacks,
    else Geu is mu'; vadam's per-block sums of g^2, ``(B, blocks)``, else
    None."""
    bsz, p, n = g.shape
    mu2 = torch.empty_like(mu)
    geu = torch.empty_like(g) if nesterov else None
    sq = g.new_empty((bsz, run.lib.large_base_blocks(p, n))) if base_kind == "vadam" else None
    err = run.lib.large_base_stage(_ptr(g), _ptr(mu), _ptr(scal), _ptr(mu2), _ptr(geu),
                                   _ptr(sq), bsz, p, n, BASE_KINDS[base_kind], run.stream)
    _check(err, "base stage", g.shape)
    run.launches += 1
    return mu2, mu2 if geu is None else geu, sq


def apply_tc(run: Runner, op: str, pa, pa_lo, ya, out, *, scal, pb=None, pb_lo=None, x=None,
             scol=None, pv=None, rows=0):
    """``out = op(...)`` on the tensor cores (``large_tc_apply``): ``pa``
    and ``pb`` with their lo pieces as :func:`gram_tc` stores them, ``ya``
    the Y of ``pa``'s product (Geu, M or Y), ``x`` the Y of B and of lam's
    term; ``out`` aliases none of them. ``identity``
    (:func:`_gram_identity_tc`) writes sums of squares to ``out``."""
    bsz, p, n = ya.shape
    for t in (ya, x):
        if t is not None and t.data_ptr() == out.data_ptr():
            raise ValueError(f"large_p {op}: out must not alias an operand")
    err = run.lib.large_tc_apply(
        OPS[op], _ptr(pa), _ptr(pa_lo), _ptr(pb), _ptr(pb_lo), _ptr(ya), _ptr(x), _ptr(scal),
        _ptr(scol), None, _ptr(pv), _ptr(out), bsz, p, n, rows, run.stream)
    _check(err, f"tensor-core {op}", ya.shape)
    run.launches += 1
    return out


def _gram_identity_tc(run: Runner, e, e_lo, lam: float, p: int, pv):
    """POGO's distance ``||X' X'^T - I_pv||_F`` from the stored ``E = C - I``
    ``(B, Pq, Pq)`` by the gram identity, ``X' X'^T - I = (1 - 2 lam) E +
    (lam^2 - 2 lam) E^2 + lam^2 E^3``, on the same kernels: E^2 a self
    gram of E, then one apply (``identity``) that forms the sum and sums
    its squares a block at a time."""
    bsz, pq, _ = e.shape
    e2 = gram_tc(run, e, eye=False, lo=False)[0]
    sq = e.new_empty((bsz, 2 * run.lib.large_tc_apply_items(pq, pq)))
    scal = torch.tensor([0.0, lam, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0], device=e.device)
    apply_tc(run, "identity", e, e_lo, e2, sq, x=e, scal=scal, pv=pv, rows=p)
    return torch.sqrt(sq.sum(dim=1))


def fused_tc(run: Runner, x, g, scal, *, method: str, lam: float, base_kind: str,
             nesterov: bool, mu, nu, pv, inplace: bool):
    """:func:`fused` on the tensor cores: the base stage (mu', Geu, vadam's
    sums), phase 1's E_A and B; then POGO's M, E_C = M M^T - I and X' = M -
    lam E_C M, the distance from the gram identity expanded in E_C
    (:func:`_gram_identity_tc`), or Landing's X' and the distance from the
    gram of X' (its squares summed in the kernel)."""
    p = x.shape[1]
    mu2 = sq = None
    geu = g
    if base_kind != "none":
        mu2, geu, sq = base_stage(run, g, mu, scal, base_kind, nesterov)
    ea, ea_lo, _ = gram_tc(run, x)
    b, b_lo, _ = gram_tc(run, x, g=geu)
    scol = nu2 = None
    if base_kind == "vadam":
        b2, eps, c1, c2 = scal[4], scal[5], scal[6], scal[7]
        nu2 = b2 * nu + (1.0 - b2) * sq.sum(dim=1)
        scol = ((scal[2] / c1) / (torch.sqrt(nu2 / c2) + eps)).contiguous()
    two = dict(pb=b, pb_lo=b_lo, x=x, scal=scal, scol=scol)
    if method == "pogo":
        m = torch.empty_like(x)
        apply_tc(run, "leap", ea, ea_lo, geu, m, **two)
        e, e_lo, _ = gram_tc(run, m)
        x_out = x if inplace else torch.empty_like(x)
        apply_tc(run, "land", e, e_lo, m, x_out, scal=scal)
        dist = _gram_identity_tc(run, e, e_lo, lam, p, pv)
    else:
        x2 = torch.empty_like(x)
        apply_tc(run, "land_step", ea, ea_lo, geu, x2, **two)
        dist = gram_tc(run, x2, lo=False, dist=True, pv=pv)[2]
        x_out = x.copy_(x2) if inplace else x2
    if inplace:
        mu2 = mu.copy_(mu2) if mu2 is not None else None
        nu2 = nu.copy_(nu2) if nu2 is not None else None
    return x_out, mu2, nu2, dist, torch.isfinite(dist)


def pogo_update_tc(run: Runner, x, g, scal, out):
    """:func:`pogo_update` on the tensor cores: E_A and B; M into a
    scratch; E_C; X' into ``out`` (which may be ``x``)."""
    ea, ea_lo, _ = gram_tc(run, x)
    b, b_lo, _ = gram_tc(run, x, g=g)
    m = torch.empty_like(x)
    apply_tc(run, "leap", ea, ea_lo, g, m, pb=b, pb_lo=b_lo, x=x, scal=scal)
    e, e_lo, _ = gram_tc(run, m)
    return apply_tc(run, "land", e, e_lo, m, out, scal=scal)


def landing_field_tc(run: Runner, x, g, scal, out):
    """:func:`landing_field` on the tensor cores: E_A and B, then the
    field."""
    ea, ea_lo, _ = gram_tc(run, x)
    b, b_lo, _ = gram_tc(run, x, g=g)
    return apply_tc(run, "field", ea, ea_lo, g, out, pb=b, pb_lo=b_lo, x=x, scal=scal)


def newton_schulz_tc(run: Runner, x, iters: int, out, mask, dist):
    """:func:`newton_schulz` on the tensor cores, one C call
    (``large_tc_newton_schulz``): the first gram is G = X X^T (its trace
    the prescale), later ones E = Y Y^T - I, each with its lo pieces, and
    each apply writes Y + E (-Y/2); then, with ``dist``, ``||E||_F`` of
    the last iterate's gram."""
    bsz, p, n = x.shape
    tmp, src = _ns_start(x, iters, out)
    blocks = tc_gram_blocks(p, False)
    count, length = slices(bsz, blocks, n, run.sms, run.min_slice)
    pq = tc_padded(p)
    hi, lo = x.new_empty((bsz, pq, pq)), x.new_empty((bsz, pq, pq))
    part = x.new_empty((bsz * blocks * count * TC_BLOCK * TC_BLOCK,)) if count > 1 else None
    err = run.lib.large_tc_newton_schulz(
        _ptr(src), _ptr(out), _ptr(tmp), _ptr(hi), _ptr(lo), _ptr(part), _ptr(mask), bsz, p,
        n, iters, count, length, run.stream)
    _check(err, "tensor-core newton-schulz", x.shape)
    run.launches += iters * (3 if count > 1 else 2)
    if dist is not None:
        d = gram_tc(run, out, mask=mask, lo=False, dist=True)[2]
        dist.copy_(d if mask is None else torch.where(mask, d, dist))
    return out
