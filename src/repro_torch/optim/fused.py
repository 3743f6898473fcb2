"""Linear-base moment layout contract for the fused group step (port of
``repro.optim.fused``, same rules and slot layout).

The fused group-step kernel (``kernels/csrc/fused_step.cu``) replays the base
optimizer *inside* the CUDA kernel so the moment buffers are read and
written in the same HBM pass as the manifold update. That only works for
base optimizers whose update rule and state layout the kernel knows how
to reproduce bit-for-bit:

  * ``none``  — no base optimizer (``base_optimizer=None``) or a pure
    ``identity()`` / ``scale(f)`` chain;
  * ``trace`` — momentum: ``mu' = decay * mu + g`` (optionally Nesterov),
    state = ``TraceState(momentum=<param tree>)``;
  * ``vadam`` — VAdam (Ling et al. 2022): per-matrix *scalar* second
    moment, state = ``ScaleByVAdamState(count, mu=<param tree>,
    nu=<lead-dims tree>)``.

:func:`resolve_fused_base` inspects a ``GradientTransformation``'s
structural ``tag`` (set by ``optim.trace`` / ``optim.scale_by_vadam`` /
``optim.chain`` / ...) and returns a :class:`FusedBase` describing the
kind, hyperparameters, a trailing scalar factor, and two accessors that
map between the base optimizer's state pytree and the orthoptimizer's flat
(mu tree, nu tree) slot view. ``None`` means the base is opaque: the
orthoptimizer then runs it first and takes the two-stage group step.

Chain rules: every link must be tagged; at most one stateful link
(``trace`` | ``vadam``); ``scale`` links are folded into ``post_scale``
but only *after* the stateful link — a scale in front would change the
stored moments, breaking state bit-compatibility with the unfused path.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from .alias import ScaleByVAdamState, TraceState
from .transform import GradientTransformation

PyTree = Any


class FusedBase(NamedTuple):
    """How the fused kernel replays a linear base optimizer.

    ``kind`` selects the in-kernel stage; ``hyper`` its static
    hyperparameters (``()`` | ``(decay, nesterov)`` | ``(b1, b2, eps)``);
    ``post_scale`` a scalar applied to the base output (folded ``scale``
    links). ``get_slots(base_state) -> (mu_tree, nu_tree, count)`` and
    ``set_slots(base_state, mu_tree, nu_tree) -> base_state`` move the
    moment buffers in and out of the base state (``set_slots`` also
    advances the stateful link's own step counter where it has one).
    """

    kind: str
    hyper: tuple
    post_scale: float
    get_slots: Callable[[PyTree], tuple]
    set_slots: Callable[[PyTree, PyTree, PyTree], PyTree]


def _none_base(post_scale: float = 1.0) -> FusedBase:
    return FusedBase(
        kind="none",
        hyper=(),
        post_scale=post_scale,
        get_slots=lambda state: (None, None, None),
        set_slots=lambda state, mu, nu: state,
    )


def _trace_base(decay: float, nesterov: bool, post_scale: float) -> FusedBase:
    return FusedBase(
        kind="trace",
        hyper=(float(decay), bool(nesterov)),
        post_scale=post_scale,
        get_slots=lambda state: (state.momentum, None, None),
        set_slots=lambda state, mu, nu: TraceState(momentum=mu),
    )


def _vadam_base(b1: float, b2: float, eps: float, post_scale: float) -> FusedBase:
    return FusedBase(
        kind="vadam",
        hyper=(float(b1), float(b2), float(eps)),
        post_scale=post_scale,
        get_slots=lambda state: (state.mu, state.nu, state.count),
        set_slots=lambda state, mu, nu: ScaleByVAdamState(
            count=state.count + 1, mu=mu, nu=nu
        ),
    )


def _reindex(base: FusedBase, idx: int, n: int) -> FusedBase:
    """Lift a link-level FusedBase to the chain's tuple-of-states layout."""

    def get(state):
        return base.get_slots(state[idx])

    def set_(state, mu, nu):
        new = list(state)
        new[idx] = base.set_slots(state[idx], mu, nu)
        return tuple(new)

    return base._replace(get_slots=get, set_slots=set_)


_STATEFUL = ("trace", "vadam")


def resolve_fused_base(
    base: Optional[GradientTransformation],
) -> Optional[FusedBase]:
    """Return the fused-kernel description of ``base``, or ``None``.

    ``None`` (no base optimizer) resolves to the ``"none"`` kind — the
    fused step still wins there (telemetry + update in one pass).
    """
    if base is None:
        return _none_base()
    tag = getattr(base, "tag", None)
    if tag is None:
        return None
    head = tag[0]
    if head == "identity":
        return _none_base()
    if head == "scale":
        return _none_base(post_scale=float(tag[1]))
    if head == "trace":
        return _trace_base(tag[1], tag[2], post_scale=1.0)
    if head == "vadam":
        return _vadam_base(tag[1], tag[2], tag[3], post_scale=1.0)
    if head == "chain":
        links = [resolve_fused_base(t) for t in tag[1]]
        if any(link is None for link in links):
            return None
        stateful = [
            (i, link) for i, link in enumerate(links) if link.kind in _STATEFUL
        ]
        if len(stateful) > 1:
            return None
        post = 1.0
        if not stateful:
            for link in links:
                post *= link.post_scale
            return _none_base(post_scale=post)
        idx, core = stateful[0]
        # A scale in FRONT of the stateful link would change the stored
        # moments (s*g enters the buffer) — state would no longer be
        # bit-compatible with the unfused path, so refuse to fuse.
        if any(link.post_scale != 1.0 for link in links[:idx]):
            return None
        for link in links[idx + 1:]:
            post *= link.post_scale
        return _reindex(core._replace(post_scale=core.post_scale * post),
                        idx, len(links))
    return None
