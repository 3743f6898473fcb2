"""The port's serving path (``repro_torch.serve``, ``models.transformer``'s
caches, ``launch.serve``) against the JAX package's, on the CPU, at
``smollm-360m``'s smoke config in fp32 (``tests/test_serve.py``'s
``smollm_f32``), from the same weights (``convert.params_from_jax``).

* The host bookkeeping (allocator, block tables, ``reset_slot``) passes
  ``tests/test_serve.py``'s cases.
* From the same params and the same cache (``convert.cache_from_jax``),
  ``decode_step``, ``decode_step_paged`` and ``prefill_chunk`` give JAX's
  logits within atol 1e-5 (fp32 sums in another order) and write the
  same K/V; ``prefill`` gives JAX's ``prefill`` logits (fp32 within 1e-5;
  bf16, where the flash kernel keeps p in fp32 and JAX's blocked attention
  rounds it to bf16, within 5e-2).
* Tokens are compared with the tie rule (``serve/parity.py``): equal, or
  parting only where the reference's top-2 margin is under the logit
  error measured between the two paths.
* ``tests/test_faults.py``'s engine cases run on both engines under the
  same requests and ``FaultPlan``: the same terminal states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.models import ortho as jortho
from repro.models import transformer as jtfm
from repro.serve import engine as jengine
from repro.serve import kv_cache as jkv
from repro_torch import faults as tfaults
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import serve as tlaunch
from repro_torch.models import ortho as tortho
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import CacheLeafLayout
from repro_torch.serve import (
    AdmissionError,
    BlockAllocator,
    BlockTables,
    DeadlineExceededError,
    DivergenceError,
    FaultEvent,
    FaultPlan,
    FoldFeasibilityError,
    PreemptedError,
    RejectReason,
    Request,
    RequestState,
    ServeEngine,
    SwapCorruptError,
    blocks_needed,
    extract_constraint_set,
    fold_constraint_set,
    gather_slot_kv,
    generate_reference,
    is_terminal,
    reset_slot,
    scatter_slot_kv,
    snapshot_checksum,
)
from repro_torch.serve import parity

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config("smollm-360m", smoke=True), compute_dtype=dtype),
            dataclasses.replace(tget_config("smollm-360m", smoke=True), compute_dtype=dtype))


@pytest.fixture(scope="module")
def models():
    """``(jax_params, port_params, jax_cfg, port_cfg)``, fp32 smoke model."""
    jcfg, tcfg = _cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


@pytest.fixture(scope="module")
def folded(models):
    """The same, with the q/k stacks projected onto the manifold."""
    jp, _, jcfg, tcfg = models
    jp = jortho.project_init(jp, jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), jcfg, tcfg


def _prompt(rng, lo=3, hi=10):
    return rng.integers(0, 100, size=(int(rng.integers(lo, hi + 1)),)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _assert_oracle(params, cfg, req, rec):
    """``req``'s tokens against the port's ``generate_reference``, tie rule."""
    ref_logits: list = []
    ref = generate_reference(params, cfg, req.prompt, req.max_new_tokens, logits=ref_logits)
    res = parity.compare_tokens(req.out_tokens, ref, ref_logits, rec[req.uid],
                                limit=parity.LOGIT_LIMITS[cfg.compute_dtype])
    assert res["ok"], f"request {req.uid}: {res}"


# --------------------------------------------------------------- kv_cache


class TestBlockAllocator:
    def test_block_zero_reserved(self):
        a = BlockAllocator(8)
        got = a.alloc(7)
        assert got is not None and 0 not in got and len(set(got)) == 7
        assert a.alloc(1) is None

    def test_alloc_is_all_or_nothing(self):
        a = BlockAllocator(6)
        assert a.alloc(3) is not None
        assert a.alloc(3) is None
        assert a.n_free == 2
        assert a.alloc(2) is not None
        assert a.n_free == 0

    def test_free_returns_blocks(self):
        a = BlockAllocator(6)
        a.free(a.alloc(4))
        assert a.n_free == 5 and a.n_used == 0

    def test_double_free_raises(self):
        a = BlockAllocator(6)
        blocks = a.alloc(2)
        a.free(blocks)
        with pytest.raises(ValueError):
            a.free(blocks)

    def test_foreign_free_raises(self):
        with pytest.raises(ValueError):
            BlockAllocator(6).free([3])

    def test_same_blocks_as_jax(self):
        """The same sequence of allocs and frees hands out the same ids."""
        ta, ja = BlockAllocator(12), jkv.BlockAllocator(12)
        for k, free in ((3, False), (4, True), (2, False), (5, True)):
            tb, jb = ta.alloc(k), ja.alloc(k)
            assert tb == jb
            if free:
                ta.free(tb)
                ja.free(jb)


class TestBlockTables:
    def test_assign_release_roundtrip(self):
        t = BlockTables(2, 4)
        t.assign(0, [5, 7, 2])
        assert t.owned(0) == [5, 7, 2]
        assert list(t.array[0]) == [5, 7, 2, 0]
        assert list(t.array[1]) == [0, 0, 0, 0]
        assert t.release(0) == [5, 7, 2]
        assert list(t.array[0]) == [0, 0, 0, 0]

    def test_double_assign_raises(self):
        t = BlockTables(2, 4)
        t.assign(0, [1])
        with pytest.raises(ValueError):
            t.assign(0, [2])


def test_blocks_needed_ceil():
    assert [blocks_needed(n, 4) for n in (1, 4, 5, 16)] == [1, 1, 2, 4]


def test_reset_slot_is_layout_driven():
    caches = {
        "state_f": torch.ones((4, 3)),
        "state_i32": torch.ones((4, 3), dtype=torch.int32),
        "state_ax1": torch.ones((2, 4, 3)),
        "pool": torch.ones((8, 2)),
    }
    layouts = {
        "state_f": CacheLeafLayout("state", 0),
        "state_i32": CacheLeafLayout("state", 0),
        "state_ax1": CacheLeafLayout("state", 1),
        "pool": CacheLeafLayout("pool", None),
    }
    out = reset_slot(caches, layouts, 1)
    for name in ("state_f", "state_i32"):
        arr = out[name]
        assert arr[1].sum() == 0 and arr[0].sum() == 3 and arr[2:].sum() == 6
    assert out["state_ax1"][:, 1].sum() == 0 and out["state_ax1"][:, 0].sum() == 6
    assert out["pool"].sum() == 16


def test_cache_layouts_match_jax():
    """Roles and slot axes leaf by leaf, dense and paged."""
    jcfg, tcfg = _cfgs()
    for jl, tl in ((jtfm.cache_layout(jcfg), ttfm.cache_layout(tcfg)),
                   (jtfm.paged_cache_layout(jcfg), ttfm.paged_cache_layout(tcfg))):
        want = [(x.role, x.slot_axis) for x in jax.tree.leaves(jl)]
        from repro_torch import tree
        assert [(x.role, x.slot_axis) for x in tree.leaves(tl)] == want


# ------------------------------------------------------ model entry points


def _jax_dense_cache(jp, jcfg, tokens, cache_len):
    c = jtfm.init_cache(jcfg, tokens.shape[0], cache_len)
    for t in range(tokens.shape[1]):
        _, c = jtfm.decode_step(jp, jcfg, jnp.asarray(tokens[:, t:t + 1]), c)
    return c


def test_decode_step_matches_jax(models):
    jp, tp, jcfg, tcfg = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jc = _jax_dense_cache(jp, jcfg, toks[:, :6], 12)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), ttfm.init_cache(tcfg, 2, 12))
    jl, jc2 = jtfm.decode_step(jp, jcfg, jnp.asarray(toks[:, 6:]), jc)
    tl, tc2 = ttfm.decode_step(tp, tcfg, torch.from_numpy(toks[:, 6:]).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for a, b in zip(jax.tree.leaves(jc2), tc2["unit"][0]):
        np.testing.assert_allclose(_np(b), _np(a), atol=ATOL, rtol=0)


def test_decode_step_sliding_window_ring_matches_jax(models):
    """A window of 4 over 9 steps: the ring wraps twice."""
    jp, tp, jcfg, tcfg = models
    jcfg = dataclasses.replace(jcfg, attention_window=4)
    tcfg = dataclasses.replace(tcfg, attention_window=4)
    toks = np.random.default_rng(1).integers(0, 500, (1, 9)).astype(np.int32)
    jc, tc = jtfm.init_cache(jcfg, 1, 16), ttfm.init_cache(tcfg, 1, 16)
    assert tc["unit"][0].k.shape[2] == 4
    for t in range(9):
        jl, jc = jtfm.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = ttfm.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def _paged_setup(jp, jcfg, tcfg, rng):
    """A JAX paged pool with two slots prefilled (8 and 5 tokens, blocks
    of 4), and the port's copy of it."""
    jc = jtfm.init_paged_cache(jcfg, 2, 9, 4)
    tables = np.array([[3, 7, 1, 0], [2, 5, 0, 0]], np.int32)
    lengths = np.array([8, 5], np.int32)
    for slot in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (1, 8)).astype(np.int32)
        _, jc, _ = jtfm.prefill_chunk(jp, jcfg, jnp.asarray(toks), jc,
                                      block_table=jnp.asarray(tables[slot:slot + 1]),
                                      start=0, n_valid=int(lengths[slot]), slot=slot)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), ttfm.init_paged_cache(tcfg, 2, 9, 4))
    return jc, tc, tables, lengths


@pytest.mark.parametrize("poison", [False, True])
def test_decode_step_paged_matches_jax(models, poison):
    jp, tp, jcfg, tcfg = models
    rng = np.random.default_rng(2)
    jc, tc, tables, lengths = _paged_setup(jp, jcfg, tcfg, rng)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    mask = np.array([True, False])
    pm = np.array([False, True]) if poison else None
    jl, jc2, jh = jtfm.decode_step_paged(
        jp, jcfg, jnp.asarray(tok), jc, block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lengths), write_mask=jnp.asarray(mask),
        poison_mask=None if pm is None else jnp.asarray(pm))
    tl, tc2, th = ttfm.decode_step_paged(
        tp, tcfg, torch.from_numpy(tok).long(), tc, block_tables=torch.from_numpy(tables),
        lengths=torch.from_numpy(lengths), write_mask=torch.from_numpy(mask),
        poison_mask=None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert th.finite.tolist() == np.asarray(jh.finite).tolist()
    # the written row 0 lands at block 1 (position 8), row 1 in the null block
    for a, b in zip(jax.tree.leaves(jc2), tc2["unit"][0]):
        np.testing.assert_allclose(_np(b)[:, 1:], _np(a)[:, 1:], atol=ATOL, rtol=0)


def test_prefill_chunk_matches_jax(models):
    jp, tp, jcfg, tcfg = models
    rng = np.random.default_rng(3)
    jc, tc, tables, lengths = _paged_setup(jp, jcfg, tcfg, rng)
    toks = rng.integers(0, jcfg.vocab_size, (1, 4)).astype(np.int32)
    jl, jc2, jh = jtfm.prefill_chunk(jp, jcfg, jnp.asarray(toks), jc,
                                     block_table=jnp.asarray(tables[1:2]), start=5,
                                     n_valid=3, slot=1)
    tl, tc2, th = ttfm.prefill_chunk(tp, tcfg, torch.from_numpy(toks).long(), tc,
                                     block_table=torch.from_numpy(tables[1:2]), start=5,
                                     n_valid=3, slot=1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert bool(th.finite) and bool(jh.finite)
    for a, b in zip(jax.tree.leaves(jc2), tc2["unit"][0]):
        np.testing.assert_allclose(_np(b)[:, 1:], _np(a)[:, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 5e-2)])
def test_prefill_matches_jax(dtype, atol):
    """Flash blocks (8) smaller than the prompt (20, not a multiple) on the
    JAX side; the port's no-grad forward runs the flash route."""
    jcfg, tcfg = _cfgs(dtype)
    jcfg = dataclasses.replace(jcfg, flash_block_q=8, flash_block_k=8)
    jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(jtfm.prefill(jp, jcfg, jnp.asarray(toks)), np.float32)
    got = ttfm.prefill(tp, tcfg, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_no_grad_forward_takes_the_flash_route(models, monkeypatch):
    """With autograd off full-sequence attention calls ops.flash_attention;
    with it on (training) the blocked attention. Same function, fp32."""
    _, tp, _, tcfg = models
    calls = []
    real = ttfm.attention.ops.flash_attention
    monkeypatch.setattr(ttfm.attention.ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 500, (1, 11)))
    with torch.no_grad():
        a = ttfm.forward(tp, tcfg, toks)
    assert len(calls) == tcfg.num_layers
    b = ttfm.forward(tp, tcfg, toks)
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=ATOL, rtol=0)


def test_cache_from_jax_checks_shapes(models):
    _, _, jcfg, tcfg = models
    jc = jax.tree.map(np.asarray, jtfm.init_cache(jcfg, 1, 8))
    with pytest.raises(ValueError):
        cache_from_jax(jc, ttfm.init_cache(tcfg, 1, 9))


# ----------------------------------------------------------- the engine


def test_burst_matches_jax_reference(models):
    """The port's engine on ``test_serve.py``'s 32-request burst against the
    JAX package's ``generate_reference``, tie rule."""
    jp, tp, jcfg, tcfg = models
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=_prompt(rng, 3, 12),
                    max_new_tokens=int(rng.integers(2, 9))) for i in range(32)]
    eng = ServeEngine(tp, tcfg, n_slots=4, n_blocks=65, block_size=4, prefill_chunk=5)
    rec = parity.record_logits(eng)
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == 32
    decode = jengine._dense_decode_callable(jcfg)
    for r in reqs:
        want = jserve.generate_reference(jp, jcfg, r.prompt, r.max_new_tokens)
        ref_logits = []  # JAX's logits for the tie rule
        caches = jtfm.init_cache(jcfg, 1, len(r.prompt) + r.max_new_tokens)
        for t in list(r.prompt) + want[:-1]:
            lg, caches = decode(jp, jnp.full((1, 1), int(t), jnp.int32), caches)
            ref_logits.append(torch.from_numpy(np.asarray(lg, np.float32)[0, 0]))
        ref_logits = ref_logits[len(r.prompt) - 1:]
        res = parity.compare_tokens(r.out_tokens, want, ref_logits, rec[r.uid],
                                    limit=parity.LOGIT_LIMITS[tcfg.compute_dtype])
        assert res["ok"], f"request {r.uid}: {res}"
    s = eng.stats
    assert s["finished"] == 32
    for k in ("preemptions", "swapped_out", "swapped_in", "preempted", "expired",
              "cancelled", "failed", "watchdog_trips", "weight_drift_trips"):
        assert s[k] == 0


def test_slot_reuse_and_block_accounting(models):
    _, tp, _, tcfg = models
    eng = ServeEngine(tp, tcfg, n_slots=2, n_blocks=17, block_size=4)
    rng = np.random.default_rng(3)
    for uid in range(7):
        eng.submit(Request(uid=uid, prompt=_prompt(rng), max_new_tokens=3))
    assert len(eng.run()) == 7
    per_slot = eng.stats["admissions_per_slot"]
    assert sum(per_slot) == 7 and max(per_slot) > 1
    assert eng.allocator.n_used == 0 and eng.allocator.n_free == 16
    assert np.all(eng.tables.array == 0)


def test_prefill_does_not_touch_neighbor_blocks(models):
    _, tp, _, tcfg = models
    eng = ServeEngine(tp, tcfg, n_slots=2, n_blocks=33, block_size=4, prefill_chunk=4)
    rng = np.random.default_rng(4)
    eng.submit(Request(uid=0, prompt=_prompt(rng, 8, 8), max_new_tokens=8))
    while eng.slot_state[0] != "decode":
        eng.step()
    victim = torch.tensor(eng.tables.owned(0))
    before = [c.k[:, victim].clone() for c in eng.caches["unit"]]
    eng.submit(Request(uid=1, prompt=_prompt(rng, 9, 9), max_new_tokens=2))
    eng._admit()
    assert eng.slot_state[1] == "prefill"
    eng._prefill_tick()
    for b, c in zip(before, eng.caches["unit"]):
        assert torch.equal(b, c.k[:, victim])


def test_chunked_and_whole_prefill_are_equivalent(models):
    _, tp, _, tcfg = models
    prompt = np.arange(11, dtype=np.int32)
    outs = []
    for chunk in (3, 64):
        eng = ServeEngine(tp, tcfg, n_slots=1, n_blocks=17, block_size=4,
                          prefill_chunk=chunk)
        rec = parity.record_logits(eng)
        req = Request(uid=0, prompt=prompt, max_new_tokens=6)
        eng.submit(req)
        eng.run()
        _assert_oracle(tp, tcfg, req, rec)
        outs.append((req.out_tokens, rec[0]))
    res = parity.compare_tokens(outs[0][0], outs[1][0], outs[1][1], outs[0][1],
                                limit=parity.LOGIT_LIMITS[tcfg.compute_dtype])
    assert res["ok"], res


class TestAdmission:
    def _engine(self, tp, tcfg, **kw):
        kw.setdefault("n_slots", 2)
        kw.setdefault("n_blocks", 9)
        kw.setdefault("block_size", 4)
        return ServeEngine(tp, tcfg, **kw)

    def test_rejections_are_typed(self, models):
        _, tp, _, tcfg = models
        eng = self._engine(tp, tcfg)
        with pytest.raises(AdmissionError) as e:
            eng.submit(Request(uid=0, prompt=np.zeros((0,), np.int32)))
        assert e.value.reason is RejectReason.EMPTY_PROMPT
        rej = eng.try_submit(Request(uid=1, prompt=np.zeros((40,), np.int32),
                                     max_new_tokens=4))
        assert rej.reason is RejectReason.TOO_LONG and rej.retry_after_ticks is None
        assert eng.try_submit(Request(uid=2, prompt=np.zeros((28,), np.int32),
                                      max_new_tokens=4)) is None
        rej = eng.try_submit(Request(uid=3, prompt=np.arange(4, dtype=np.int32),
                                     max_new_tokens=0))
        assert rej.reason is RejectReason.ZERO_NEW_TOKENS

    def test_queue_full_hint(self, models):
        _, tp, _, tcfg = models
        eng = self._engine(tp, tcfg, max_queue=1)
        rng = np.random.default_rng(0)
        eng.submit(Request(uid=0, prompt=_prompt(rng)))
        rej = eng.try_submit(Request(uid=1, prompt=_prompt(rng)))
        assert rej.reason is RejectReason.QUEUE_FULL and rej.retry_after_ticks >= 1
        assert eng.stats["rejected"] == {"queue_full": 1}

    def test_fifo_head_of_line_blocks(self, models):
        _, tp, _, tcfg = models
        eng = self._engine(tp, tcfg, n_blocks=7, block_size=2)
        rng = np.random.default_rng(1)
        a = Request(uid=0, prompt=_prompt(rng, 2, 2), max_new_tokens=6)
        b = Request(uid=1, prompt=_prompt(rng, 4, 4), max_new_tokens=4)
        c = Request(uid=2, prompt=_prompt(rng, 1, 1), max_new_tokens=1)
        for r in (a, b, c):
            eng.submit(r)
        eng.step()
        admitted = {r.uid for r in eng.slot_req if r is not None}
        assert 0 in admitted and 2 not in admitted
        eng.run()
        assert b.t_admit <= c.t_admit and len(eng.finished) == 3


# ------------------------------------------------------------- fold


class TestFold:
    def test_roundtrip_preserves_params(self, folded):
        _, tp, _, tcfg = folded
        res = fold_constraint_set(tp, tcfg, extract_constraint_set(tp, tcfg))
        assert res.n_leaves == len(tortho.extract_constrained(tp, tcfg))
        assert res.max_distance < 1e-3
        for a, b in zip(tortho.extract_constrained(tp, tcfg),
                        tortho.extract_constrained(res.params, tcfg)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

    def test_distance_matches_jax(self, folded):
        jp, tp, jcfg, tcfg = folded
        got, path = jserve.feasibility_distance(jp, jcfg)
        want = fold_constraint_set(tp, tcfg, extract_constraint_set(tp, tcfg))
        assert want.worst_path == path
        np.testing.assert_allclose(want.max_distance, got, atol=1e-6)

    def test_infeasible_stack_raises(self, folded):
        _, tp, _, tcfg = folded
        leaves = tortho.extract_constrained(tp, tcfg)
        bad = tortho.merge_constrained(tp, tcfg, tuple(2.0 * x for x in leaves))
        with pytest.raises(FoldFeasibilityError) as e:
            fold_constraint_set(tp, tcfg, extract_constraint_set(bad, tcfg))
        assert e.value.distance > e.value.atol and e.value.path

    def test_no_constrained_families_raises(self, models):
        _, tp, _, tcfg = models
        with pytest.raises(ValueError):
            extract_constraint_set(tp, dataclasses.replace(tcfg, ortho_families=()))

    def test_folded_params_serve(self, folded):
        _, tp, _, tcfg = folded
        res = fold_constraint_set(tp, tcfg, extract_constraint_set(tp, tcfg))
        eng = ServeEngine(res.params, tcfg, n_slots=2, n_blocks=17, block_size=4)
        rec = parity.record_logits(eng)
        req = Request(uid=0, prompt=np.arange(7, dtype=np.int32), max_new_tokens=5)
        eng.submit(req)
        eng.run()
        _assert_oracle(res.params, tcfg, req, rec)


def test_launcher_smoke_on_cpu(capsys):
    assert tlaunch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                         "--requests", "4", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "folded 2 constrained leaves" in out and "served 4/4 requests" in out


def test_launcher_variable_prompts_and_swap(capsys):
    res = tlaunch.run(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                       "--requests", "12", "--min-prompt-len", "8", "--prompt-len",
                       "48", "--max-new", "8", "--slots", "4", "--blocks", "12",
                       "--block-size", "16", "--preemption", "swap"])
    lens = {len(r.prompt) for r in res["requests"]}
    assert len(lens) > 1 and min(lens) >= 8 and max(lens) <= 48
    assert all(r.state is RequestState.FINISHED for r in res["terminal"])
    assert res["engine"].stats["swapped_in"] == res["engine"].stats["swapped_out"] > 0


# ------------------------------------------------------------ faults


def test_fault_plan_matches_jax():
    for seed in (7, 8, 21):
        want = jserve.FaultPlan.random(seed, n_events=8, max_tick=40, n_slots=4).events
        got = FaultPlan.random(seed, n_events=8, max_tick=40, n_slots=4).events
        assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    mixed = tfaults.SERVE_FAULT_KINDS + tfaults.TRAIN_FAULT_KINDS
    assert mixed == tfaults.FAULT_KINDS
    with pytest.raises(ValueError):
        FaultEvent("segfault", tick=1)


def test_fault_plan_window_and_one_shot():
    plan = FaultPlan((FaultEvent("alloc_exhaust", tick=3, duration=2),))
    assert [plan.alloc_blocked(t) for t in (2, 3, 4, 5)] == [False, True, True, False]
    plan = FaultPlan((FaultEvent("corrupt_swap", tick=0),))
    buf = np.zeros(16, np.uint8)
    assert plan.corrupt_swap(1, uid=5, buffers=[buf]) and buf.sum() == 0xFF
    assert not plan.corrupt_swap(2, uid=6, buffers=[buf])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_roundtrip_is_bit_exact_with_jax_crc(models, dtype):
    """Gather a mid-decode slot, scatter it into other blocks, gather again:
    the same bytes. The crc equals JAX's ``snapshot_checksum`` of the same
    bytes (bf16 as uint16 views of the device bits)."""
    jp, _, jcfg, _ = models
    tcfg = dataclasses.replace(_cfgs()[1], compute_dtype=dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    eng = ServeEngine(tp, tcfg, n_slots=2, n_blocks=17, block_size=4)
    eng.submit(Request(uid=0, prompt=np.arange(7, dtype=np.int32), max_new_tokens=8))
    for _ in range(4):
        eng.step()
    assert eng.slot_state[0] == "decode"
    phys = eng.tables.owned(0)
    pool1, state1 = gather_slot_kv(eng.caches, eng.layouts, 0, phys)
    crc1 = snapshot_checksum(pool1 + state1)
    assert crc1 == jkv.snapshot_checksum(pool1 + state1)
    if dtype == "bfloat16":  # the same bits as JAX's bf16 arrays
        as_jax = [np.asarray(jnp.asarray(torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).float().numpy(), jnp.bfloat16)) for a in pool1]
        assert jkv.snapshot_checksum(as_jax) == crc1
    relocated = eng.allocator.alloc(len(phys))
    assert set(relocated) != set(phys)
    scatter_slot_kv(eng.caches, eng.layouts, 0, relocated, pool1, state1)
    pool2, state2 = gather_slot_kv(eng.caches, eng.layouts, 0, relocated)
    assert snapshot_checksum(pool2 + state2) == crc1
    for a, b in zip(pool1, pool2):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _both_engines(models, reqs_spec, plan_fn=None, run_kw=None, **kw):
    """The same requests and plan through JAX's engine and the port's;
    returns ``(port_engine, port_reqs, jax_reqs, rec, plans)``."""
    jp, tp, jcfg, tcfg = models
    out = []
    for eng_cls, req_cls, params, cfg, plan_cls in (
            (jserve.ServeEngine, jserve.Request, jp, jcfg, jserve.FaultPlan),
            (ServeEngine, Request, tp, tcfg, FaultPlan)):
        plan = plan_fn(plan_cls) if plan_fn is not None else None
        eng = eng_cls(params, cfg, fault_plan=plan, **kw)
        rec = parity.record_logits(eng) if eng_cls is ServeEngine else None
        reqs = [req_cls(**spec) for spec in reqs_spec]
        for r in reqs:
            eng.submit(r)
        eng.run(**(run_kw or {}))
        out.append((eng, reqs, rec, plan))
    (_, jreqs, _, jplan), (teng, treqs, rec, tplan) = out
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
    for tr, jr in zip(treqs, jreqs):
        assert tr.n_preemptions == jr.n_preemptions
        assert type(tr.error).__name__ == type(jr.error).__name__
    if jplan is not None:
        assert [f[:2] for f in tplan.fired] == [f[:2] for f in jplan.fired]
    return teng, treqs, jreqs, rec


def _specs(rng, n, lo, hi, new_lo, new_hi, **extra):
    return [dict(uid=i, prompt=_prompt(rng, lo, hi),
                 max_new_tokens=int(rng.integers(new_lo, new_hi)), **extra)
            for i in range(n)]


def _check_finished(models, reqs, rec):
    _, tp, _, tcfg = models
    for r in reqs:
        if r.state is RequestState.FINISHED:
            _assert_oracle(tp, tcfg, r, rec)


def test_swap_out_restore_through_engine(models):
    _, tp, _, tcfg = models
    eng = ServeEngine(tp, tcfg, n_slots=2, n_blocks=17, block_size=4, preemption="swap")
    rec = parity.record_logits(eng)
    req = Request(uid=0, prompt=np.arange(6, dtype=np.int32), max_new_tokens=8)
    eng.submit(req)
    for _ in range(4):
        eng.step()
    assert eng.slot_state[0] == "decode" and len(req.out_tokens) >= 2
    eng._swap_out(0)
    assert req.state is RequestState.SWAPPED and eng.allocator.n_used == 0
    eng.run()
    assert req.state is RequestState.FINISHED
    assert eng.stats["swapped_out"] == 1 and eng.stats["swapped_in"] == 1
    _assert_oracle(tp, tcfg, req, rec)


def test_overload_burst_preemption_matches_jax(models):
    rng = np.random.default_rng(11)
    specs = _specs(rng, 32, 3, 12, 2, 9, deadline_ticks=600)
    for i in (0, 5, 9):
        specs[i] = dict(uid=i, prompt=_prompt(rng, 4, 8), max_new_tokens=24,
                        deadline_ticks=600)
    peak = sum(-(-(len(s["prompt"]) + s["max_new_tokens"]) // 4) for s in specs[:8])
    eng, reqs, _, rec = _both_engines(
        models, specs, run_kw=dict(max_ticks=650), n_slots=4, block_size=4,
        n_blocks=max(9, peak // 3) + 1, prefill_chunk=5, preemption="swap",
        preempt_after_ticks=2, max_preemptions=2)
    assert all(is_terminal(r.state) for r in reqs)
    s = eng.stats
    assert s["preemptions"] > 0 and s["swapped_in"] > 0
    finished = [r for r in reqs if r.state is RequestState.FINISHED]
    assert len(finished) >= 28 and any(r.n_preemptions for r in finished)
    _check_finished(models, reqs, rec)
    assert eng.allocator.n_used == 0 and len(eng.swap_pool) == 0


def test_kill_mode_preemption_matches_jax(models):
    rng = np.random.default_rng(12)
    specs = [dict(uid=0, prompt=_prompt(rng, 4, 6), max_new_tokens=20)]
    specs += [dict(uid=i, prompt=_prompt(rng, 3, 6), max_new_tokens=3) for i in range(1, 8)]
    eng, reqs, _, rec = _both_engines(
        models, specs, n_slots=2, n_blocks=9, block_size=4, preemption="kill",
        preempt_after_ticks=2, max_preemptions=1)
    preempted = [r for r in reqs if r.state is RequestState.PREEMPTED]
    assert preempted and eng.stats["preempted"] == len(preempted)
    assert all(isinstance(r.error, PreemptedError) for r in preempted)
    _check_finished(models, reqs, rec)


def test_deadline_expires_queued_request_matches_jax(models):
    specs = [dict(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=24),
             dict(uid=1, prompt=np.arange(20, dtype=np.int32), max_new_tokens=8,
                  deadline_ticks=3)]
    eng, reqs, _, _ = _both_engines(models, specs, n_slots=1, n_blocks=9, block_size=4)
    assert reqs[0].state is RequestState.FINISHED
    assert reqs[1].state is RequestState.EXPIRED
    assert isinstance(reqs[1].error, DeadlineExceededError)
    assert reqs[1].error.budget == "deadline" and eng.stats["expired"] == 1


def test_ttft_budget_via_delayed_prefill_matches_jax(models):
    specs = [dict(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4,
                  ttft_budget_ticks=4)]
    _, reqs, _, _ = _both_engines(
        models, specs,
        plan_fn=lambda P: P((jserve.FaultEvent("delay_prefill", tick=0, duration=8)
                             if P is jserve.FaultPlan else
                             FaultEvent("delay_prefill", tick=0, duration=8),)),
        run_kw=dict(max_ticks=20), n_slots=1, n_blocks=9, block_size=4)
    assert reqs[0].state is RequestState.EXPIRED and reqs[0].error.budget == "ttft"


def test_cancel_in_every_nonterminal_state(models):
    _, tp, _, tcfg = models
    eng = ServeEngine(tp, tcfg, n_slots=2, n_blocks=17, block_size=4, preemption="swap")
    queued = Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=4)
    eng.submit(queued)
    assert eng.cancel(0) and queued.state is RequestState.CANCELLED
    running = Request(uid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=8)
    eng.submit(running)
    for _ in range(3):
        eng.step()
    assert running.state is RequestState.DECODE
    assert eng.cancel(1) and running.state is RequestState.CANCELLED
    assert eng.allocator.n_used == 0
    swapped = Request(uid=2, prompt=np.arange(4, dtype=np.int32), max_new_tokens=8)
    eng.submit(swapped)
    for _ in range(3):
        eng.step()
    eng._swap_out([s for s, r in enumerate(eng.slot_req) if r is swapped][0])
    assert swapped.state is RequestState.SWAPPED
    assert eng.cancel(2) and swapped.state is RequestState.CANCELLED
    assert len(eng.swap_pool) == 0
    assert not eng.cancel(2) and not eng.cancel(99)
    assert eng.stats["cancelled"] == 3 and not eng.has_work()


def _event(P, kind, **kw):
    return (jserve.FaultEvent if P is jserve.FaultPlan else FaultEvent)(kind, **kw)


def test_alloc_exhaust_matches_jax(models):
    specs = [dict(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4)]
    _, reqs, jreqs, rec = _both_engines(
        models, specs, plan_fn=lambda P: P((_event(P, "alloc_exhaust", tick=0, duration=3),)),
        run_kw=dict(max_ticks=40), n_slots=2, n_blocks=17, block_size=4)
    assert reqs[0].state is RequestState.FINISHED
    assert reqs[0].admit_tick == jreqs[0].admit_tick >= 3
    _check_finished(models, reqs, rec)


def test_nan_fault_quarantines_only_the_victim_matches_jax(models):
    rng = np.random.default_rng(13)
    specs = [dict(uid=i, prompt=_prompt(rng, 4, 6), max_new_tokens=8) for i in range(2)]
    base, base_reqs, _, _ = _both_engines(models, specs, n_slots=2, n_blocks=17,
                                          block_size=4)
    assert base._poison_fn is None
    eng, reqs, _, _ = _both_engines(
        models, specs, plan_fn=lambda P: P((_event(P, "nan_logits", tick=3, slot=0),)),
        run_kw=dict(max_ticks=40), n_slots=2, n_blocks=17, block_size=4)
    assert eng._poison_fn is not None
    victims = [r for r in reqs if r.state is RequestState.FAILED]
    assert len(victims) == 1
    assert isinstance(victims[0].error, DivergenceError) and victims[0].error.slot == 0
    assert eng.stats["watchdog_trips"] == 1
    survivor = [r for r in reqs if r is not victims[0]][0]
    assert survivor.out_tokens == base_reqs[survivor.uid].out_tokens


def test_corrupt_swap_fails_only_the_victim_matches_jax(models):
    rng = np.random.default_rng(14)
    specs = [dict(uid=0, prompt=_prompt(rng, 4, 6), max_new_tokens=20)]
    specs += [dict(uid=i, prompt=_prompt(rng, 3, 6), max_new_tokens=3) for i in range(1, 8)]
    eng, reqs, _, rec = _both_engines(
        models, specs, plan_fn=lambda P: P((_event(P, "corrupt_swap", tick=0),)),
        run_kw=dict(max_ticks=400), n_slots=2, n_blocks=9, block_size=4,
        preemption="swap", preempt_after_ticks=2)
    failed = [r for r in reqs if r.state is RequestState.FAILED]
    assert len(failed) == 1 and isinstance(failed[0].error, SwapCorruptError)
    _check_finished(models, reqs, rec)
    assert eng.allocator.n_used == 0


def test_random_chaos_plan_matches_jax(models):
    rng = np.random.default_rng(15)
    specs = _specs(rng, 10, 3, 8, 2, 7, deadline_ticks=300)
    eng, reqs, _, _ = _both_engines(
        models, specs,
        plan_fn=lambda P: P.random(21, n_events=8, max_tick=30, n_slots=2),
        run_kw=dict(max_ticks=400), n_slots=2, n_blocks=9, block_size=4,
        preemption="swap", preempt_after_ticks=2)
    assert all(is_terminal(r.state) for r in reqs) and eng.allocator.n_used == 0


def test_weight_drift_trips_watchdog(folded):
    _, tp, _, tcfg = folded
    eng = ServeEngine(tp, tcfg, n_slots=1, n_blocks=9, block_size=4,
                      weight_check_interval=1)
    req = Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=6)
    eng.submit(req)
    eng.run()
    assert req.state is RequestState.FINISHED and eng.weight_healthy
    assert eng.stats["weight_checks"] >= 1 and eng.stats["weight_drift_trips"] == 0
    leaves = tortho.extract_constrained(eng.params, tcfg)
    eng.params = tortho.merge_constrained(eng.params, tcfg, tuple(2.0 * x for x in leaves))
    eng.submit(Request(uid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2))
    eng.run()
    assert not eng.weight_healthy and eng.stats["weight_drift_trips"] >= 1
    rej = eng.try_submit(Request(uid=2, prompt=np.arange(4, dtype=np.int32),
                                 max_new_tokens=2))
    assert rej is not None and rej.reason is RejectReason.UNHEALTHY
