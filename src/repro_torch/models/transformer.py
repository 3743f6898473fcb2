"""Decoder-only LM of the dense family (``repro.models.transformer``).

The parameter tree is the JAX package's: ``embed``, ``final_norm`` and
``unit``, a tuple with one dict per block kind of the repeating unit whose
leaves are stacked over the unit's repeats, ``(L, ...)``. Where JAX scans
over the stack, the port loops over layer views of it (one ``unbind`` per
leaf, so each leaf's gradient is stacked back in one pass), and
``remat="full"`` checkpoints every block (``torch.utils.checkpoint``,
non-reentrant) when autograd is on. Only the ``attn`` block kind is
ported; the other families raise.

Serving: ``prefill`` (the flash kernel in every layer), the one-request
dense ``decode_step`` and the engine's paged ``decode_step_paged`` and
``prefill_chunk``, over caches whose ``"unit"`` leaves keep JAX's
leading ``(n_rep, ...)`` axis. They run without autograd and write new
K/V into the caches in place (``models/attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import health as health_mod
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


def _apply_block(p, x: torch.Tensor, cfg, positions=None, cache=None, paged=None):
    """One attention block; returns ``(x, new_cache)``."""
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if paged is not None and cache is not None:
        block_tables, write_mask = paged
        attn_out, new_cache = attention.paged_attention_apply(
            p["inner"], h, cfg, cache, positions=positions,
            block_tables=block_tables, write_mask=write_mask,
            window=cfg.attention_window)
    else:
        attn_out, new_cache = attention.attention_apply(
            p["inner"], h, cfg, positions=positions, window=cfg.attention_window,
            cache=cache)
    x = x + attn_out
    h2 = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + layers.mlp_apply(p["ffn"], h2, cfg.mlp_activation), new_cache


def _block_call(p, x, cfg, positions, cache, paged):
    if cfg.remat == "none" or cache is not None or not torch.is_grad_enabled():
        return _apply_block(p, x, cfg, positions, cache, paged)
    leaves, td = tree.flatten(p)

    def fn(x, *leaves):
        return _apply_block(tree.unflatten(td, leaves), x, cfg, positions)[0]

    return checkpoint(fn, x, *leaves, use_reentrant=False), None


def _layer_cache(c, r: int):
    """Layer ``r``'s view of a cache stacked over the unit's repeats."""
    return type(c)(*(leaf[r] for leaf in c))


def _run_blocks(params, x: torch.Tensor, cfg, positions=None, caches=None,
                paged=None):
    """Every layer in order: the unit's repeats, then the tail. Returns
    ``(x, new_caches)`` (None without caches)."""
    unit, n_rep, tail = cfg.layer_plan()
    new_caches: dict[str, Any] = {}
    if n_rep > 0:
        stacks = [tree.flatten(s) for s in params["unit"]]
        layer_views = [([t.unbind(0) for t in leaves], td) for leaves, td in stacks]
        unit_caches = caches["unit"] if caches is not None else None
        for r in range(n_rep):
            for i, (views, td) in enumerate(layer_views):
                c = None if unit_caches is None else _layer_cache(unit_caches[i], r)
                x, _ = _block_call(tree.unflatten(td, [v[r] for v in views]), x,
                                   cfg, positions, c, paged)
        if unit_caches is not None:  # K/V went in place; dense indices advance
            new_caches["unit"] = tuple(
                c._replace(index=c.index + x.shape[1])
                if isinstance(c, attention.KVCache) else c for c in unit_caches)
    if tail:
        tail_caches = caches.get("tail") if caches is not None else None
        new_tail = []
        for i, p in enumerate(params["tail"]):
            c = None if tail_caches is None else tail_caches[i]
            x, nc = _block_call(p, x, cfg, positions, c, paged)
            new_tail.append(nc)
        if tail_caches is not None:
            new_caches["tail"] = tuple(new_tail)
    return x, (new_caches if caches is not None else None)


def _forward(params, cfg, tokens, positions=None, caches=None, paged=None):
    _check(cfg)
    x = layers.embed(params["embed"], tokens, cfg.dtype)
    x, new_caches = _run_blocks(params, x, cfg, positions, caches, paged)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), new_caches


def forward(params, cfg, tokens: torch.Tensor, *, positions=None) -> torch.Tensor:
    """Token ids ``(B, S)`` to final-norm hidden states ``(B, S, d)``."""
    return _forward(params, cfg, tokens, positions)[0]


def loss_fn(params, cfg, batch, aux_weight: float = 0.01):
    """Next-token CE. ``batch``: ``{tokens, labels}`` of shape ``(B, S)``.
    The dense family has no auxiliary loss; ``aux`` is zero as in JAX."""
    hidden = forward(params, cfg, batch["tokens"])
    embed_params = params.get("unembed", params["embed"])
    ce = layers.chunked_cross_entropy(hidden, embed_params, batch["labels"],
                                      cfg.loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def logits_from_hidden(params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 vocab logits of hidden states."""
    return layers.unembed(params.get("unembed", params["embed"]), hidden)


# ---------------------------------------------------------------------- caches


def _each_block(cfg, build):
    """``{"unit": (build((n_rep,)) per unit slot), "tail": (build(()),
    ...)}``: ``build`` gets the leading stacked axes of its leaves."""
    unit, n_rep, tail = cfg.layer_plan()
    out: dict[str, Any] = {}
    if n_rep > 0:
        out["unit"] = tuple(build((n_rep,)) for _ in unit)
    if tail:
        out["tail"] = tuple(build(()) for _ in tail)
    return out


def init_cache(cfg, batch: int, cache_len: int, device="cpu"):
    """Dense caches of the one-request decode: per attention block a
    ``KVCache`` of ``(batch, min(cache_len, window), KV, hd)``; the unit's
    leaves stacked over its repeats, ``(n_rep, ...)``."""
    _check(cfg)
    window = cfg.attention_window
    eff = min(cache_len, window) if window else cache_len
    return _each_block(cfg, lambda lead: attention.init_kv_cache(
        batch, eff, cfg, cfg.dtype, device, lead))


def init_paged_cache(cfg, n_slots: int, n_blocks: int, block_size: int,
                     device="cpu"):
    """Serving cache: per attention block a ``PagedKVCache`` pool of
    ``n_blocks`` blocks of ``block_size`` positions, shared by the slots,
    block 0 reserved (``n_slots`` sizes the per-slot state of recurrent
    blocks, which the port does not have)."""
    _check(cfg)
    return _each_block(cfg, lambda lead: attention.init_paged_kv_cache(
        n_blocks, block_size, cfg, cfg.dtype, device, lead))


@dataclasses.dataclass(frozen=True)
class CacheLeafLayout:
    """The layout of one cache leaf, which serving code programs against.

    role: ``"kv"`` (dense per-slot K/V rows), ``"index"`` (the shared
    write position), ``"state"`` (per-slot recurrent state) or ``"pool"``
    (the paged block pool, shared by the slots and never reset per slot).
    ``slot_axis``: the axis the engine's slot id indexes (1 for leaves
    stacked over the unit's repeats, 0 otherwise), or None for shared
    leaves. A leaf of the tree module, so a layout tree has its cache
    tree's structure and ``tree.flatten`` pairs their leaves.
    """

    role: str
    slot_axis: Optional[int] = None


def _cache_layout(cfg, paged: bool):
    _check(cfg)

    def build(lead):
        if paged:
            pool = CacheLeafLayout("pool", None)
            return attention.PagedKVCache(k=pool, v=pool)
        kv = CacheLeafLayout("kv", len(lead))
        return attention.KVCache(k=kv, v=kv, index=CacheLeafLayout("index", None))

    return _each_block(cfg, build)


def cache_layout(cfg):
    """Layout metadata of :func:`init_cache` (the same tree structure)."""
    return _cache_layout(cfg, paged=False)


def paged_cache_layout(cfg):
    """Layout metadata of :func:`init_paged_cache` (the same structure)."""
    return _cache_layout(cfg, paged=True)


# -------------------------------------------------------------- prefill/decode


@torch.no_grad()
def prefill(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over the prompts ``(B, S)``, the flash kernel in every layer;
    returns the last position's fp32 logits ``(B, 1, V)``."""
    hidden = forward(params, cfg, tokens)
    return logits_from_hidden(params, cfg, hidden[:, -1:])


@torch.no_grad()
def decode_step(params, cfg, tokens: torch.Tensor, caches):
    """One-token decode ``(B, 1)`` over dense caches, at the position of
    their index. Returns ``(logits, new_caches)``."""
    idx = _find_cache_index(caches)
    positions = idx.long().reshape(1, 1).expand(tokens.shape[0], 1)
    hidden, new_caches = _forward(params, cfg, tokens, positions, caches)
    return logits_from_hidden(params, cfg, hidden), new_caches


@torch.no_grad()
def decode_step_paged(params, cfg, tokens: torch.Tensor, caches, *,
                      block_tables: torch.Tensor, lengths: torch.Tensor,
                      write_mask: torch.Tensor, poison_mask=None):
    """One-token decode over the paged cache. ``tokens``: ``(B, 1)``;
    ``lengths``: ``(B,)``, the cached positions per slot (the new token is
    written at ``lengths[b]``); ``write_mask``: ``(B,)`` bool, False rows
    (free or still-prefilling slots riding in the batch) write to the null
    block. ``poison_mask`` (``(B,)`` bool, optional) forces NaN logits in
    its rows before the health reduction: the fault-injection hook.

    Returns ``(logits, new_caches, health)``; ``health.finite`` is the
    ``(B,)`` per-slot all-finite mask of the logits."""
    positions = lengths.long()[:, None]
    hidden, new_caches = _forward(params, cfg, tokens, positions, caches,
                                  (block_tables.long(), write_mask[:, None]))
    logits = logits_from_hidden(params, cfg, hidden)
    if poison_mask is not None:
        logits = torch.where(poison_mask[:, None, None], float("nan"), logits)
    return logits, new_caches, health_mod.from_logits(logits, per_row=True)


@torch.no_grad()
def prefill_chunk(params, cfg, tokens: torch.Tensor, caches, *,
                  block_table: torch.Tensor, start: int, n_valid: int, slot: int):
    """Prefill of one chunk of one request, in one dispatch that writes
    only into that request's blocks. ``tokens``: ``(1, C)``, prompt
    positions ``start .. start + C - 1``, padding past ``n_valid`` (its
    writes go to the null block); ``block_table``: ``(1, max_blocks)``.
    ``slot`` addresses per-slot recurrent state, which the ported
    attention-only blocks do not have.

    Returns ``(logits, new_caches, health)``: the fp32 logits at prompt
    position ``start + n_valid - 1`` (``(1, 1, V)``), the cache and a
    scalar all-finite verdict."""
    del slot  # no per-slot state in the attention-only family
    c = tokens.shape[1]
    ar = torch.arange(c, device=tokens.device)
    positions = (start + ar)[None]
    write_mask = (ar < n_valid)[None]
    hidden, new_caches = _forward(params, cfg, tokens, positions, caches,
                                  (block_table.long(), write_mask))
    logits = logits_from_hidden(params, cfg, hidden[:, n_valid - 1:n_valid])
    return logits, new_caches, health_mod.from_logits(logits)


def _find_cache_index(caches):
    """The write index of the first attention cache (layer 0 of a stack)."""
    for key in ("unit", "tail"):
        for c in caches.get(key, ()):
            if isinstance(c, attention.KVCache):
                return c.index[0] if c.index.dim() > 0 else c.index
    return None
