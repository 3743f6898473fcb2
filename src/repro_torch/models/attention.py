"""GQA attention with RoPE, causal and sliding-window, with the KV caches
of serving (``repro.models.attention``).

Per-head Q/K projections are stored per head, ``(H, head_dim, d_model)``:
those are the paper's St(p, n) matrices (``p = head_dim <= n =
d_model``), and the orthoptimizer updates the whole ``(layers, H, p, n)``
stack in one group.

Full-sequence attention has two routes. With autograd on (training) it
is the JAX package's blocked online softmax (``_flash_attend``) in plain
PyTorch ops: query blocks times key blocks, an ``(acc, m, l)`` carry per
query block, fp32 scores from bf16 operands, p rounded to the compute
dtype before ``p @ v`` as in JAX. That is the training path in both
packages: the flash kernel has no backward. With autograd off (the
prefill, any no-grad forward) it is ``kernels.ops.flash_attention``, the
port of the TPU flash kernel, which keeps p in fp32.

Serving attends over caches in plain PyTorch ops, with the contractions
of the JAX code (fp32 scores, softmax, probabilities in the compute
dtype, fp32 ``p @ v``): the dense ``KVCache`` of the one-request oracle
(a ring for sliding windows) and the ``PagedKVCache`` block pool of the
engine. Unlike JAX, the port writes new K/V into a cache in place and
returns the same storage; only the dense cache's ``index`` is a new
tensor. No library attention is called here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from . import layers

NEG_INF = -(2.0**30)


def init_attention(gen: torch.Generator, cfg, device="cpu"):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=gen.device).to(device)

    return {
        "q_proj": normal((h, hd, d), d**-0.5),
        "k_proj": normal((kvh, hd, d), d**-0.5),
        "v_proj": normal((kvh, hd, d), d**-0.5),
        "o_proj": normal((h, hd, d), (h * hd) ** -0.5),
    }


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, cache_len, KV, hd)
    v: torch.Tensor  # (B, cache_len, KV, hd)
    index: torch.Tensor  # int32 scalar: next write position (a ring for SWA)


class PagedKVCache(NamedTuple):
    """Paged K/V storage: a shared pool of fixed-size blocks, ``(n_blocks,
    block_size, KV, hd)`` (a leading ``n_rep`` axis when stacked over the
    unit's repeats). Per-request positions live in the engine's block
    tables and lengths (``serve/kv_cache.py``). Block 0 is the reserved
    null block: the allocator never hands it out, and masked writes go
    there."""

    k: torch.Tensor
    v: torch.Tensor


def init_paged_kv_cache(n_blocks: int, block_size: int, cfg, dtype,
                        device="cpu", lead: tuple = ()) -> PagedKVCache:
    """Zero pools; ``lead`` prepends stacked axes (the unit's repeats)."""
    shape = (*lead, n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def init_kv_cache(batch: int, cache_len: int, cfg, dtype, device="cpu",
                  lead: tuple = ()) -> KVCache:
    """A zero dense cache at index 0; ``lead`` prepends stacked axes."""
    shape = (*lead, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros(lead, dtype=torch.int32, device=device))


def _project(params, x: torch.Tensor, name: str) -> torch.Tensor:
    """``einsum("bsd,hkd->bshk")`` with fp32 accumulation, cast to x's dtype."""
    w = layers.cast(params[name], x.dtype)  # (H, hd, d)
    h, hd, d = w.shape
    out = layers.matmul_f32(x.reshape(-1, d), w.reshape(h * hd, d).t())
    return out.reshape(*x.shape[:-1], h, hd).to(x.dtype)


def _flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int], block_q: int = 512,
                  block_k: int = 512) -> torch.Tensor:
    """Online-softmax blockwise attention over ``(B, S, H, hd)`` queries and
    ``(B, S, KV, hd)`` keys and values; the sequence pads to whole blocks
    and padded keys are masked. Internally the layout is ``(B * KV,
    bq * G, .)`` so that every score and value product is one batched
    matrix product."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    scale = hd**-0.5
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    nq = -(-sq // block_q)
    nk = -(-sk // block_k)
    dev = q.device

    def pad(t, blocks, blk):
        extra = blocks * blk - t.shape[1]
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra)) if extra else t

    # (b, KV, S, G, hd) and (b, KV, S, hd)
    qp = pad(q, nq, block_q).reshape(b, nq * block_q, kvh, groups, hd).permute(0, 2, 1, 3, 4)
    kp = pad(k, nk, block_k).permute(0, 2, 1, 3)
    vp = pad(v, nk, block_k).permute(0, 2, 1, 3)
    kpos_all = torch.arange(nk * block_k, device=dev)
    outs = []
    for i in range(nq):
        q_blk = qp[:, :, i * block_q:(i + 1) * block_q].reshape(b * kvh, block_q * groups, hd)
        qpos = torch.arange(i * block_q, (i + 1) * block_q, device=dev)
        qpos = qpos[:, None].expand(block_q, groups).reshape(-1)  # per row of q_blk
        acc = torch.zeros((b * kvh, block_q * groups, hd), dtype=torch.float32, device=dev)
        m_run = torch.full((b * kvh, block_q * groups), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b * kvh, block_q * groups), dtype=torch.float32, device=dev)
        for j in range(nk):
            kblk = kp[:, :, j * block_k:(j + 1) * block_k].reshape(b * kvh, block_k, hd)
            vblk = vp[:, :, j * block_k:(j + 1) * block_k].reshape(b * kvh, block_k, hd)
            kpos = kpos_all[j * block_k:(j + 1) * block_k]
            s = layers.matmul_f32(q_blk, kblk.transpose(-1, -2)) * scale
            mask = (kpos < sk)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + pexp.sum(dim=-1)
            pv = layers.matmul_f32(pexp.to(v.dtype), vblk)
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run[..., None], 1e-30))
    out = torch.cat([o.reshape(b, kvh, block_q, groups, hd) for o in outs], dim=2)
    out = out.permute(0, 2, 1, 3, 4).reshape(b, nq * block_q, h, hd)[:, :sq]
    return out.to(q.dtype)


def _attend_cache(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                  valid: torch.Tensor, v_dtype) -> torch.Tensor:
    """Attention of ``(B, S, H, hd)`` queries over a cache's ``(B, T, KV,
    hd)`` keys and values where ``valid`` ``(B, 1, 1, S, T)`` holds; JAX's
    ``bskgh,btkh->bkgst`` scores in fp32, softmax, probabilities in
    ``v_dtype``, ``bkgst,btkh->bskgh`` in fp32. Returns fp32 ``(B, S, H,
    hd)``."""
    b, s, h, hd = q.shape
    t, kvh = k_all.shape[1], k_all.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(b * kvh, g * s, hd)
    kt = k_all.to(q.dtype).permute(0, 2, 3, 1).reshape(b * kvh, hd, t)
    scores = layers.matmul_f32(qg, kt).reshape(b, kvh, g, s, t) * (hd**-0.5)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_dtype).reshape(b * kvh, g * s, t)
    vv = v_all.to(v_dtype).permute(0, 2, 1, 3).reshape(b * kvh, t, hd)
    out = layers.matmul_f32(probs, vv).reshape(b, kvh, g, s, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def _out_proj(params, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` with fp32 accumulation, in x's dtype."""
    b, s, _ = x.shape
    w_o = layers.cast(params["o_proj"], x.dtype)  # (H, hd, d)
    h, hd, d = w_o.shape
    y = layers.matmul_f32(out.reshape(-1, h * hd), w_o.reshape(h * hd, d))
    return y.reshape(b, s, d).to(x.dtype)


def attention_apply(params, x: torch.Tensor, cfg, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None,
                    cache: Optional[KVCache] = None):
    """Returns ``(out, new_cache)``. Without a cache: full-sequence
    attention, the flash kernel when autograd is off and the blocked
    ``_flash_attend`` when it is on (training), and ``new_cache`` is
    None. With a cache (decode): K/V written at ``cache.index`` (mod
    cache_len for the SWA ring), then attention over the cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if cache is not None:
            positions = positions + cache.index.long()
    q = layers.rope(_project(params, x, "q_proj"), positions, cfg.rope_theta)
    k = layers.rope(_project(params, x, "k_proj"), positions, cfg.rope_theta)
    v = _project(params, x, "v_proj")
    if cache is None:
        if torch.is_grad_enabled():
            out = _flash_attend(q, k, v, causal=causal, window=window,
                                block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
        return _out_proj(params, out, x), None

    cache_len = cache.k.shape[1]
    write_pos = cache.index.long()
    if window is not None:
        write_pos = torch.remainder(write_pos, cache_len)
    slots = write_pos + torch.arange(s, device=x.device)
    cache.k.index_copy_(1, slots, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slots, v.to(cache.v.dtype))
    new_cache = KVCache(k=cache.k, v=cache.v, index=cache.index + s)
    t_pos = torch.arange(cache_len, device=x.device)
    q_pos = positions[:, None, None, :, None]
    if window is not None:
        # ring: slot t holds the absolute position newest - age(t)
        newest = new_cache.index.long() - 1
        abs_pos = newest - torch.remainder(write_pos - t_pos, cache_len)
        valid = (abs_pos >= 0) & (abs_pos <= q_pos) & (abs_pos > q_pos - window)
    else:
        valid = (t_pos < new_cache.index.long()) & (t_pos <= q_pos)
    out = _attend_cache(q, new_cache.k, new_cache.v, valid, v.dtype)
    return _out_proj(params, out.to(x.dtype), x), new_cache


def paged_attention_apply(params, x: torch.Tensor, cfg, cache: PagedKVCache, *,
                          positions: torch.Tensor, block_tables: torch.Tensor,
                          write_mask: torch.Tensor, window: Optional[int] = None):
    """Serving attention over the paged KV pool, decode and chunked
    prefill in one entry point. ``positions``: ``(B, S)`` absolute token
    positions; ``block_tables``: ``(B, max_blocks)`` physical block ids
    (0 = null); ``write_mask``: ``(B, S)`` bool, False writes go to the
    null block 0 at offset 0.

    Writes each token's K/V at ``block_tables[b, pos // bs][pos % bs]`` in
    place, then attends over the gathered logical cache
    ``pool[block_tables]`` with the causal (and window) mask on absolute
    positions, with the dense decode's contractions. Masked writes land
    on the null block in no fixed order (``index_put_`` with repeated
    indices); no read ever sees them. Returns ``(out, cache)``."""
    b, s, _ = x.shape
    blk = cache.k.shape[-3]
    max_blocks = block_tables.shape[-1]
    q = layers.rope(_project(params, x, "q_proj"), positions, cfg.rope_theta)
    k = layers.rope(_project(params, x, "k_proj"), positions, cfg.rope_theta)
    v = _project(params, x, "v_proj")

    logical = torch.clamp(positions // blk, 0, max_blocks - 1)
    phys = torch.gather(block_tables, 1, logical)
    phys = torch.where(write_mask, phys, 0)
    offs = torch.where(write_mask, positions % blk, 0)
    cache.k.index_put_((phys, offs), k.to(cache.k.dtype))
    cache.v.index_put_((phys, offs), v.to(cache.v.dtype))

    k_all = cache.k[block_tables].reshape(b, max_blocks * blk, *cache.k.shape[-2:])
    v_all = cache.v[block_tables].reshape(b, max_blocks * blk, *cache.v.shape[-2:])
    t_pos = torch.arange(max_blocks * blk, device=x.device)
    q_pos = positions[:, None, None, :, None]
    valid = t_pos <= q_pos
    if window is not None:
        valid = valid & (t_pos > q_pos - window)
    out = _attend_cache(q, k_all, v_all, valid, v.dtype)
    return _out_proj(params, out.to(x.dtype), x), cache
