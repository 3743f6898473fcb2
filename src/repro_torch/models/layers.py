"""Dense layers of the port (``repro.models.layers``), functional.

Parameters are plain dicts of fp32 tensors, as the JAX package's trees.
Layers compute in ``cfg.compute_dtype`` (bf16 by default): each weight is
cast per use, and every product of two bf16 operands accumulates in fp32
(:func:`matmul_f32`, JAX's ``preferred_element_type=float32``) before the
result is cast back where the JAX code casts it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two low-precision operands, accumulated and returned
    in fp32; the gradients come back in the operands' dtype, from the
    cotangent cast to it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 for 2-D ``(m, k) x (k, n)`` or batched ``(B, m, k)
    x (B, k, n)`` operands of one dtype."""
    if a.dtype == torch.float32:
        return a @ b
    return _MatmulF32.apply(a, b)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k) @ w (k, n)``, fp32 accumulation, cast back to x's dtype."""
    out = matmul_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_shape, scale=None,
               device="cpu") -> torch.Tensor:
    """Normal(0, 1/sqrt(in_dim)) dense weight of shape ``(in_dim, *out_shape)``."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    scale = scale if scale is not None else in_dim**-0.5
    return scale * torch.randn((in_dim, *out_shape), generator=gen,
                               device=gen.device).to(device)


def rmsnorm_init(dim: int, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, device="cpu"):
    # 1/sqrt(d) keeps untrained logits ~N(0, 1) after the final RMSNorm.
    return {"table": dim**-0.5 * torch.randn((vocab, dim), generator=gen,
                                             device=gen.device).to(device)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(tokens, cast(params["table"], dtype))


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Vocab logits in fp32 (a stable softmax-CE)."""
    table = cast(params["table"], x.dtype)
    out = matmul_f32(x.reshape(-1, x.shape[-1]), table.t())
    return out.reshape(*x.shape[:-1], table.shape[0])


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             activation: str = "swiglu", device="cpu"):
    if activation == "swiglu":
        return {"w_gate": dense_init(gen, d_model, d_ff, device=device),
                "w_up": dense_init(gen, d_model, d_ff, device=device),
                "w_down": dense_init(gen, d_ff, d_model, device=device)}
    return {"w_up": dense_init(gen, d_model, d_ff, device=device),
            "w_down": dense_init(gen, d_ff, d_model, device=device)}


def mlp_apply(params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    dt = x.dtype
    if activation == "swiglu":
        h = F.silu(_mm(x, cast(params["w_gate"], dt))) * _mm(x, cast(params["w_up"], dt))
    else:
        h = F.gelu(_mm(x, cast(params["w_up"], dt)), approximate="tanh")
    return _mm(h, cast(params["w_down"], dt))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim of ``(..., seq, heads, head_dim)``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _chunk_loss(h, y, table):
    logits = unembed({"table": table}, h)  # fp32 (b, chunk, V)
    mask = (y >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp_min(y, 0)[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(hidden: torch.Tensor, embed_params, labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE without keeping full ``(B, S, V)`` logits: each
    sequence chunk recomputes its logits in the backward pass (JAX's
    ``jax.checkpoint`` around ``chunk_loss``). ``labels < 0`` are masked."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for t0 in range(0, s, chunk):
        t, m = checkpoint(_chunk_loss, hidden[:, t0:t0 + chunk],
                          labels[:, t0:t0 + chunk], embed_params["table"],
                          use_reentrant=False)
        total = total + t
        count = count + m
    return total / torch.clamp_min(count, 1.0)
