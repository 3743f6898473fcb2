"""The port's flash-attention forward (``repro_torch.kernels.ops.
flash_attention``, its plain version on the CPU) against the JAX package's
Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``),
its model-layout oracle (``repro.models.attention._flash_attend``) and its
flat oracle (``repro.kernels.ref.flash_attention_fwd_ref``).

The cases are ``tests/test_flash_kernel.py``'s: aligned causal and
non-causal, a sliding window of 64, S = 200 (not a multiple of the
block), bf16. Tolerances: fp32 atol 2e-5 / rtol 1e-4, the Pallas tests'
(fp32 sums in another order); bf16 3e-2, the Pallas bf16 test's (the
kernel keeps p in fp32 where ``_flash_attend`` rounds it to bf16).

The Pallas wrapper pads the keys to whole blocks and masks with the
padded length, so non-causal attention with S not a multiple of the
block gives the zero padding keys softmax weight. The port masks with the
true length: ``test_reference_fault_non_causal_unaligned`` pins both.

The bf16 tensor-core kernel runs PV three times, on the three bf16 pieces
of the fp32 p (p_hi, p_mid, p_lo): ``test_split_p_keeps_fp32_p_to_one_output_ulp``
holds a plain attention that does the same to the JAX oracle (fp32 p) at
one output ulp per element (atol 1e-6 / rtol 1/64, the kernel's card
tolerance), and shows that p in bf16 alone misses it. Two pieces pass at
these shapes but missed on a few outputs near zero per million on the
card at the prefill's shapes (4 x 2048 tokens).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, s, h, kvh, hd, seed=0, bf16=False):
    """Numpy inputs for both packages (bf16-representable when ``bf16``)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)):
        a = rng.standard_normal(shape).astype(np.float32)
        if bf16:
            a = torch.from_numpy(a).bfloat16().float().numpy()
        out.append(a)
    return out


def _port(arrs, bf16=False, **kw):
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(a).to(dt) for a in arrs)
    return tops.flash_attention(q, k, v, **kw).float().numpy()


def _jax(fn, arrs, bf16=False, **kw):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v = (jnp.asarray(a, dt) for a in arrs)
    return np.asarray(fn(q, k, v, **kw), np.float32)


def _pallas(arrs, bf16=False, **kw):
    return _jax(jops.flash_attention, arrs, bf16, block_q=128, block_k=128,
                interpret=True, **kw)


def _oracle(arrs, bf16=False, causal=True, window=None):
    return _jax(jattn._flash_attend, arrs, bf16, causal=causal, window=window,
                block_q=64, block_k=64)


CASES = [  # (b, s, h, kvh, hd), causal, window
    ((1, 128, 2, 2, 64), True, None),
    ((1, 128, 2, 2, 64), False, None),
    ((2, 256, 4, 2, 32), True, None),
    ((2, 256, 4, 2, 32), False, None),
    ((1, 256, 2, 2, 32), True, 64),
    ((1, 200, 2, 1, 32), True, None),
]


@pytest.mark.parametrize("shape,causal,window", CASES)
def test_matches_pallas_kernel(shape, causal, window):
    arrs = _qkv(*shape)
    np.testing.assert_allclose(_port(arrs, causal=causal, window=window),
                               _pallas(arrs, causal=causal, window=window), **F32)


@pytest.mark.parametrize("shape,causal,window",
                         CASES + [((1, 200, 2, 1, 32), False, None),
                                  ((1, 200, 3, 1, 40), True, 48)])
def test_matches_model_layout_oracle(shape, causal, window):
    arrs = _qkv(*shape, seed=1)
    np.testing.assert_allclose(_port(arrs, causal=causal, window=window),
                               _oracle(arrs, causal=causal, window=window), **F32)


def test_bf16_matches_pallas_kernel_and_oracle():
    arrs = _qkv(1, 128, 2, 2, 64, bf16=True)
    got = _port(arrs, bf16=True, causal=True)
    np.testing.assert_allclose(got, _pallas(arrs, bf16=True, causal=True), **BF16)
    np.testing.assert_allclose(got, _oracle(arrs, bf16=True), **BF16)


def test_reference_fault_non_causal_unaligned():
    """S = 200, block 128: the Pallas kernel weights the 56 zero padding
    keys (masked with the padded 256), the port does not."""
    arrs = _qkv(1, 200, 2, 1, 32)
    want = _oracle(arrs, causal=False)
    pallas_err = np.abs(_pallas(arrs, causal=False) - want).max()
    assert pallas_err > 1e-2, pallas_err
    np.testing.assert_allclose(_port(arrs, causal=False), want, **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
def test_flat_ref_matches_jax_ref(causal, window):
    """``flash_attention_fwd_ref`` on ``(BH, S, hd)``, the kernel's oracle."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((4, 64, 16)).astype(np.float32) for _ in range(3))
    got = tref.flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=window)
    want = jref.flash_attention_fwd_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flat_ref_takes_every_key_and_no_padding():
    """More keys than queries, non-causal, at no multiple of any block: the
    port's ref weights every key, as JAX's ref does on the unpadded keys;
    the padding that JAX's wrapper adds is not there to take weight."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 50, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 70, 8)).astype(np.float32) for _ in range(2))
    got = tref.flash_attention_fwd_ref(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = jref.flash_attention_fwd_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_wrapper_checks_operands_and_counts_no_cpu_launch():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k)  # 4 heads over 3 KV heads
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q, window=0)
    before = tops.launches()
    tfa.flash_attention_fwd(q, q, q)
    tfa.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert tops.launches() == before  # the plain version ran, for both dtypes
    assert {"flash_attention_fp32", "flash_attention_tc"} <= set(tops.launches())


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.bfloat16, 5, "flash_attention_tc"),
    (torch.float32, 64, "flash_attention_tf32"),   # SmolLM-360M's heads
    (torch.float32, 128, "flash_attention_tf32"),  # internlm2-1.8b's
    (torch.float32, 4, "flash_attention_tf32"),
    (torch.float32, 40, "flash_attention_tf32"),
    (torch.float32, 62, "flash_attention_fp32"),   # rows of 248 bytes: no tensor map
    (torch.float32, 5, "flash_attention_fp32"),
    (torch.float32, 127, "flash_attention_fp32"),
])
def test_plan_by_dtype_and_head_dim(dtype, hd, want):
    """fp32 goes to the 3xTF32 kernel where TMA can address its rows (hd %
    4 == 0), else to the CUDA-core kernel; bf16 always to its own. Each
    name is a wrapper that counts its launches."""
    assert tfa.plan(dtype, hd) == want
    assert tfa.KERNELS[want].__name__ == want and want in tops.launches()
    with pytest.raises(ValueError):
        tfa.plan(torch.float16, hd)


ULP_TOL = dict(atol=1e-6, rtol=1 / 64)  # one bf16 output ulp per element


def _plain_split_attention(q, k, v, *, causal, window, pieces):
    """Attention on ``(BH, S, hd)`` in fp32 whose PV takes p as the
    tensor-core kernel does: p = exp(s - rowmax) in fp32, l its fp32 row
    sum, the output (sum over the pieces of P_c V) / l, where each piece is
    the bf16 rounding of what the pieces before it leave of p (three in
    the kernel; one is p in bf16)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = (qf @ kf.transpose(-1, -2)) * hd**-0.5
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None], s, tref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.zeros_like(qf)
    for _ in range(pieces):
        piece = p.bfloat16().float()
        out = out + piece @ vf
        p = p - piece
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def _flat(arrs):
    """Model-layout numpy inputs -> ``(B * H, S, hd)`` with KV heads repeated."""
    q, k, v = (torch.from_numpy(a) for a in arrs)
    groups = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    return [tfa._heads_first(t).numpy() for t in (q, k, v)]


@pytest.mark.parametrize("shape,causal,window", CASES)
def test_split_p_keeps_fp32_p_to_one_output_ulp(shape, causal, window):
    flat = _flat(_qkv(*shape, seed=4, bf16=True))
    want = _jax(jref.flash_attention_fwd_ref, flat, bf16=True, causal=causal,
                window=window)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in flat)
    got = _plain_split_attention(q, k, v, causal=causal, window=window, pieces=3)
    np.testing.assert_allclose(got.float().numpy(), want, **ULP_TOL)
    one = _plain_split_attention(q, k, v, causal=causal, window=window, pieces=1)
    err = np.abs(one.float().numpy() - want)
    missed = int((err > ULP_TOL["atol"] + ULP_TOL["rtol"] * np.abs(want)).sum())
    assert missed > 0, "p in bf16 alone kept one output ulp: the split would buy nothing"
