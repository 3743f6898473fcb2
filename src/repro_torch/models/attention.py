"""GQA attention with RoPE, causal and sliding-window, for training
(``repro.models.attention`` without the KV caches of serving).

Per-head Q/K projections are stored per head, ``(H, head_dim, d_model)``:
those are the paper's St(p, n) matrices (``p = head_dim <= n =
d_model``), and the orthoptimizer updates the whole ``(layers, H, p, n)``
stack in one group.

Attention is the JAX package's blocked online softmax (``_flash_attend``)
in plain PyTorch ops: query blocks times key blocks, an ``(acc, m, l)``
carry per query block, fp32 scores from bf16 operands. The repo's
flash-attention kernel (``repro/kernels/flash_attention.py``) is a
separate port; no library attention is called here.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def attention_apply(params, x: torch.Tensor, cfg, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (training, no cache)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = layers.rope(_project(params, x, "q_proj"), positions, cfg.rope_theta)
    k = layers.rope(_project(params, x, "k_proj"), positions, cfg.rope_theta)
    v = _project(params, x, "v_proj")
    out = _flash_attend(q, k, v, causal=causal, window=window,
                        block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
    w_o = layers.cast(params["o_proj"], x.dtype)  # (H, hd, d)
    h, hd, d = w_o.shape
    y = layers.matmul_f32(out.reshape(-1, h * hd), w_o.reshape(h * hd, d))
    return y.reshape(b, s, d).to(x.dtype)
