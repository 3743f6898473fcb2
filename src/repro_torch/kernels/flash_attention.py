"""Wrapper of the flash-attention forward kernel (``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces ``repro/kernels/flash_attention.py:88``
(``_flash_fwd_kernel``): one CTA per (64-row query tile, batch x head),
a loop over 64-key tiles with the online softmax in registers, fp32
arithmetic on bf16 or fp32 inputs, the output in q's dtype. It takes the
model's layout directly, ``q (B, Sq, H, hd)`` and ``k``, ``v`` ``(B, Sk,
KV, hd)`` with ``H % KV == 0``, and reads each query head's KV head in
place (no repeat, no transpose, no padding), so ``Sk`` is the true key
length.

On a CPU tensor it runs the plain version, ``ref.flash_attention_fwd_ref``
on the ``(B * H, S, hd)`` layout of the JAX oracle, with the KV heads
repeated; on a CUDA tensor it checks the operands, launches on the
current stream and raises if the launch fails. There is no fallback. The
wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lib() -> ctypes.CDLL:
    """The loaded ``flash_attention.cu`` library, built on first use."""
    lib_ = build.load("flash_attention")
    if not getattr(lib_, "_typed", False):
        lib_.flash_attention_fwd.argtypes = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
        lib_.flash_attention_fwd.restype = _I
        lib_.flash_attention_smem_bytes.argtypes = [_I]
        lib_.flash_attention_smem_bytes.restype = _I
        lib_._typed = True
    return lib_


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, hd)`` -> ``(B * H, S, hd)``."""
    b, s, h, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)


def run_plain(q, k, v, *, causal: bool, window: Optional[int]):
    """The plain version on the model layout: KV heads repeated per query
    head, ``ref.flash_attention_fwd_ref`` on ``(B * H, S, hd)``."""
    b, sq, h, hd = q.shape
    groups = h // k.shape[2]
    kr = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vr = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    out = ref.flash_attention_fwd_ref(_heads_first(q), _heads_first(kr),
                                      _heads_first(vr), causal=causal,
                                      window=window)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Attention forward of ``(B, Sq, H, hd)`` queries over ``(B, Sk, KV,
    hd)`` keys and values; returns ``(B, Sq, H, hd)`` in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, H, hd) and two (B, Sk, KV, hd)")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: want None or >= 1")
    if q.device.type == "cpu":
        return run_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one of "
                         f"{list(_DTYPES)} for all three")
    if not 1 <= hd <= 128:
        raise ValueError(f"head_dim {hd} outside [1, 128]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, h, kvh, hd, int(causal),
            int(window or 0), float(hd**-0.5), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed for q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}: cudaError {err}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
