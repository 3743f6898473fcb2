"""Wrappers of the flash-attention forward kernels.

``flash_attention_fwd`` replaces ``repro/kernels/flash_attention.py:88``
(``_flash_fwd_kernel``) and picks a kernel by dtype and head dimension
(``plan``):

* bf16: ``flash_attention_tc`` (``csrc/flash_attention_tc.cu``), the bf16
  tensor cores through ``wgmma`` with TMA-fed K/V tiles. p keeps fp32
  quality: PV runs on the three bf16 pieces of the fp32 p.
* fp32 at hd % 4 == 0: ``flash_attention_tf32``
  (``csrc/flash_attention_tf32.cu``), 3xTF32 ``wgmma`` with TMA-fed K/V
  tiles, every product within ~2^-21 of fp32's.
* fp32 at hd % 4 != 0 (rows whose bytes TMA cannot address; no model here
  has one): ``flash_attention_fp32`` (``csrc/flash_attention.cu``), IEEE
  fp32 on the CUDA cores.

All three take the model's layout directly, ``q (B, Sq, H, hd)`` and ``k``,
``v`` ``(B, Sk, KV, hd)`` with ``H % KV == 0``, read each query head's KV
head in place (no repeat, no transpose, no key padding), so ``Sk`` is the
true key length, and return the output in q's dtype.

On a CPU tensor ``flash_attention_fwd`` runs the plain version,
``ref.flash_attention_fwd_ref`` on the ``(B * H, S, hd)`` layout of the JAX
oracle, with the KV heads repeated; on a CUDA tensor it checks the
operands, launches one kernel on the current stream and raises if the
launch fails. There is no fallback. Each kernel's wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def lib() -> ctypes.CDLL:
    """The loaded ``flash_attention.cu`` library (fp32), built on first use."""
    lib_ = build.load("flash_attention")
    if not getattr(lib_, "_typed", False):
        lib_.flash_attention_fwd.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
        lib_.flash_attention_fwd.restype = _I
        lib_.flash_attention_smem_bytes.argtypes = [_I]
        lib_.flash_attention_smem_bytes.restype = _I
        lib_._typed = True
    return lib_


def tc_lib() -> ctypes.CDLL:
    """The loaded ``flash_attention_tc.cu`` library (bf16), built on first use."""
    lib_ = build.load("flash_attention_tc")
    if not getattr(lib_, "_typed", False):
        lib_.flash_attention_tc_fwd.argtypes = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
        lib_.flash_attention_tc_fwd.restype = _I
        lib_.flash_attention_tc_smem_bytes.argtypes = [_I]
        lib_.flash_attention_tc_smem_bytes.restype = _I
        lib_._typed = True
    return lib_


def tf32_lib() -> ctypes.CDLL:
    """The loaded ``flash_attention_tf32.cu`` library (fp32, hd % 4 == 0),
    built on first use."""
    lib_ = build.load("flash_attention_tf32")
    if not getattr(lib_, "_typed", False):
        lib_.flash_attention_tf32_fwd.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
        lib_.flash_attention_tf32_fwd.restype = _I
        lib_.flash_attention_tf32_smem_bytes.argtypes = [_I]
        lib_.flash_attention_tf32_smem_bytes.restype = _I
        lib_._typed = True
    return lib_


def plan(dtype: torch.dtype, hd: int) -> str:
    """The kernel wrapper that a CUDA call of ``dtype`` and head dimension
    ``hd`` launches: the bf16 tensor-core kernel, the 3xTF32 one for fp32
    rows whose bytes are a multiple of 16 (TMA's rule), the CUDA-core
    kernel for the other fp32 rows."""
    if dtype == torch.bfloat16:
        return "flash_attention_tc"
    if dtype == torch.float32:
        return "flash_attention_tf32" if hd % 4 == 0 else "flash_attention_fp32"
    raise ValueError(f"no flash kernel for {dtype}")


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


def _raise_on(err: int, name: str, q, k) -> None:
    if err >= 10000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{err - 10000}) for q {tuple(q.shape)}, k {tuple(k.shape)}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed for q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}: cudaError {err}")


def _launch_args(q, k, v, out):
    """The pointers and shape that both launchers take first."""
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kvh)


def flash_attention_fp32(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The CUDA-core kernel on checked fp32 CUDA operands."""
    hd = q.shape[-1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib().flash_attention_fwd(
            *_launch_args(q, k, v, out), hd, int(causal),
            int(window or 0), float(hd**-0.5), stream)
    _raise_on(err, "flash_attention_fp32", q, k)
    flash_attention_fp32.launches += 1
    return out


def _tma_operand(t: torch.Tensor, ld: int) -> torch.Tensor:
    """``t`` with rows of ``ld`` columns (zeros past hd) at a 16-byte
    aligned address, as the tensor maps need; a copy only where it is not."""
    if t.shape[-1] != ld:
        return F.pad(t, (0, ld - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_tf32(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The 3xTF32 tensor-core kernel on checked fp32 CUDA operands with hd %
    4 == 0 (rows of a multiple of 16 bytes, as the tensor maps need)."""
    hd = q.shape[-1]
    if hd % 4 or k.shape[1] < 1:
        raise ValueError(f"flash_attention_tf32 needs hd % 4 == 0 and a key: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    q, k, v = (_tma_operand(t, hd) for t in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = tf32_lib().flash_attention_tf32_fwd(
            *_launch_args(q, k, v, out), hd, int(causal),
            int(window or 0), float(hd**-0.5), stream)
    _raise_on(err, "flash_attention_tf32", q, k)
    flash_attention_tf32.launches += 1
    return out


def flash_attention_tc(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The tensor-core kernel on checked bf16 CUDA operands. The tensor maps
    need rows whose bytes are a multiple of 16: a head dimension that is not
    a multiple of 8 is padded with zero columns in a copy (no model here has
    one)."""
    hd = q.shape[-1]
    if k.shape[1] < 1:
        raise ValueError("flash_attention_tc needs at least one key")
    ld = -(-hd // 8) * 8
    q, k, v = (_tma_operand(t, ld) for t in (q, k, v))
    out = torch.empty(q.shape[:-1] + (hd,), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = tc_lib().flash_attention_tc_fwd(
            *_launch_args(q, k, v, out), ld, hd,
            int(causal), int(window or 0), float(hd**-0.5), stream)
    _raise_on(err, "flash_attention_tc", q, k)
    flash_attention_tc.launches += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Attention forward of ``(B, Sq, H, hd)`` queries over ``(B, Sk, KV,
    hd)`` keys and values; returns ``(B, Sq, H, hd)`` in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, H, hd) and two (B, Sk, KV, hd)")
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: want None or >= 1")
    if q.device.type == "cpu":
        return run_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    dtypes = (torch.float32, torch.bfloat16)
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one of "
                         f"{list(dtypes)} for all three")
    if not 1 <= hd <= 128:
        raise ValueError(f"head_dim {hd} outside [1, 128]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    return KERNELS[plan(q.dtype, hd)](q, k, v, causal=causal, window=window)


flash_attention_fp32.launches = 0
flash_attention_tf32.launches = 0
flash_attention_tc.launches = 0
KERNELS = {k.__name__: k for k in (flash_attention_fp32, flash_attention_tf32,
                                   flash_attention_tc)}
