"""Decoder-only LM of the dense family (``repro.models.transformer``).

The parameter tree is the JAX package's: ``embed``, ``final_norm`` and
``unit``, a tuple with one dict per block kind of the repeating unit whose
leaves are stacked over the unit's repeats, ``(L, ...)``. Where JAX scans
over the stack, the port loops over layer views of it (one ``unbind`` per
leaf, so each leaf's gradient is stacked back in one pass), and
``remat="full"`` checkpoints every block (``torch.utils.checkpoint``,
non-reentrant). Only the ``attn`` block kind is ported; the other
families raise.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from . import attention, layers

_NOT_PORTED = "models + training stack"


def _check(cfg):
    unit, _, tail = cfg.layer_plan()
    if set(unit) | set(tail) != {"attn"}:
        raise NotImplementedError(
            f"block pattern {cfg.block_pattern} is not ported yet (ROADMAP: {_NOT_PORTED})")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported yet "
                                  f"(ROADMAP: {_NOT_PORTED})")


def _init_block(gen, cfg, device):
    return {
        "norm1": layers.rmsnorm_init(cfg.d_model, device),
        "inner": attention.init_attention(gen, cfg, device),
        "norm2": layers.rmsnorm_init(cfg.d_model, device),
        "ffn": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_activation, device),
    }


def _stack(blocks: list) -> dict:
    """One tree whose leaves stack the blocks' leaves over a new axis 0."""
    td = tree.flatten(blocks[0])[1]
    cols = zip(*(tree.leaves(b) for b in blocks))
    return tree.unflatten(td, [torch.stack(c) for c in cols])


def init_params(gen: torch.Generator, cfg, device="cpu") -> dict:
    """Random fp32 parameters from ``gen``, the tree of
    ``repro.models.transformer.init_params`` (other draws: JAX's threefry
    streams cannot be reproduced; ``convert.params_from_jax`` carries JAX
    weights over)."""
    _check(cfg)
    unit, n_rep, tail = cfg.layer_plan()
    params: dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, device)
    if n_rep > 0:
        params["unit"] = tuple(
            _stack([_init_block(gen, cfg, device) for _ in range(n_rep)])
            for _ in unit)
    if tail:
        params["tail"] = tuple(_init_block(gen, cfg, device) for _ in tail)
    params["final_norm"] = layers.rmsnorm_init(cfg.d_model, device)
    return params


def _apply_block(p, x: torch.Tensor, cfg, positions=None) -> torch.Tensor:
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + attention.attention_apply(p["inner"], h, cfg, positions=positions,
                                      window=cfg.attention_window)
    h2 = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(p["ffn"], h2, cfg.mlp_activation)


def _block_call(p, x, cfg, positions):
    if cfg.remat == "none":
        return _apply_block(p, x, cfg, positions)
    leaves, td = tree.flatten(p)

    def fn(x, *leaves):
        return _apply_block(tree.unflatten(td, leaves), x, cfg, positions)

    return checkpoint(fn, x, *leaves, use_reentrant=False)


def _run_blocks(params, x: torch.Tensor, cfg, positions=None) -> torch.Tensor:
    """Every layer in order: the unit's repeats, then the tail."""
    unit, n_rep, tail = cfg.layer_plan()
    if n_rep > 0:
        stacks = [tree.flatten(s) for s in params["unit"]]
        layer_views = [([t.unbind(0) for t in leaves], td) for leaves, td in stacks]
        for r in range(n_rep):
            for views, td in layer_views:
                x = _block_call(tree.unflatten(td, [v[r] for v in views]), x, cfg,
                                positions)
    for p in params.get("tail", ()):
        x = _block_call(p, x, cfg, positions)
    return x


def forward(params, cfg, tokens: torch.Tensor, *, positions=None) -> torch.Tensor:
    """Token ids ``(B, S)`` to final-norm hidden states ``(B, S, d)``."""
    _check(cfg)
    x = layers.embed(params["embed"], tokens, cfg.dtype)
    x = _run_blocks(params, x, cfg, positions)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def loss_fn(params, cfg, batch, aux_weight: float = 0.01):
    """Next-token CE. ``batch``: ``{tokens, labels}`` of shape ``(B, S)``.
    The dense family has no auxiliary loss; ``aux`` is zero as in JAX."""
    hidden = forward(params, cfg, batch["tokens"])
    embed_params = params.get("unembed", params["embed"])
    ce = layers.chunked_cross_entropy(hidden, embed_params, batch["labels"],
                                      cfg.loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
