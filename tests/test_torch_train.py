"""The port's training stack against the JAX package's, on the CPU, at
``smollm-360m``'s smoke config.

* ``host_batch`` gives bit-identical tokens; ``DataIterator`` replays a
  step's batch.
* Three steps of ``make_train_step`` from the same weights and data, the
  fused kernel path on and off, the watchdog on and off: loss, grad norm,
  feasibility and every parameter and moment within atol 1e-4 / rtol 1e-3
  of the JAX step (fp32 compute; the difference is fp32 summation order,
  grown over three AdamW and POGO steps), ``health_finite`` equal.
* The loop: exact resume, the crash checkpoint, rollback on a non-finite
  loss (``tests/test_train_loop.py``, ``tests/test_train_chaos.py:113-162``);
  fault plans are not ported and raise.
* Checkpoints: a JAX-written trainer checkpoint restores in the port and
  a port-written one in JAX, bit for bit; bf16 leaves round-trip without
  ``ml_dtypes``; corrupt payloads are named and skipped.
* The launcher runs ``--smoke --device cpu`` and prints ``done:``.
"""

import dataclasses
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.core import api as japi
from repro.data import pipeline as jdata
from repro.models import ortho as jortho
from repro.models import transformer as jtfm
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import api as tapi
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import ortho as tortho
from repro_torch.models import transformer as ttfm
from repro_torch.train import loop as tloop
from repro_torch.train import train_step as tts

STEP_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are small, and the suite runs in
    several worker processes at once, where torch's thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jget_config("smollm-360m", smoke=True), **kw),
            dataclasses.replace(tget_config("smollm-360m", smoke=True), **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jortho.project_init(jtfm.init_params(jax.random.PRNGKey(0), jcfg), jcfg)


def _port_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")


@pytest.mark.parametrize("kind", ["markov", "uniform", "copy"])
def test_host_batch_is_bit_identical(kind):
    for step in (0, 3, 17):
        cfg = dict(vocab_size=512, seq_len=33, global_batch=4, seed=5, kind=kind)
        want = jdata.host_batch(jdata.DataConfig(**cfg), step)
        got = tdata.host_batch(tdata.DataConfig(**cfg), step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_iterator_replays_a_step():
    it = tdata.DataIterator(tdata.DataConfig(512, 16, 2, seed=1), device="cpu")
    first = [next(it) for _ in range(3)]
    it.step = 1
    again = next(it)
    assert torch.equal(again["tokens"], first[1]["tokens"])
    assert again["tokens"].device.type == "cpu"


def _train_cfgs(use_kernel, watchdog):
    kw = dict(warmup_steps=2, decay_steps=10, learning_rate=1e-2,
              pogo_learning_rate=0.3, pogo_use_kernel=use_kernel)
    return (jts.TrainConfig(**kw, ortho_watchdog=japi.WatchdogConfig() if watchdog else None),
            tts.TrainConfig(**kw, ortho_watchdog=tapi.WatchdogConfig() if watchdog else None))


@pytest.mark.parametrize("watchdog", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_steps_match_jax(jax_params, use_kernel, watchdog):
    jcfg, tcfg = _cfgs()
    jtc, ttc = _train_cfgs(use_kernel, watchdog)
    jstep, jopt = jts.make_train_step(jcfg, jtc)
    tstep, topt = tts.make_train_step(tcfg, ttc)
    jp, tp = jax_params, _port_params(jax_params)
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(jstep)
    dcfg = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=2)
    jit_ = jdata.DataIterator(jdata.DataConfig(**dcfg))
    tit = tdata.DataIterator(tdata.DataConfig(**dcfg), device="cpu")
    for _ in range(3):
        jp, js, jm = jstep(jp, js, next(jit_))
        tp, ts, tm = tstep(tp, ts, next(tit))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **STEP_TOL)
        np.testing.assert_allclose(float(tm["ortho_distance"]),
                                   float(jm["ortho_distance"]), atol=1e-5)
        assert float(tm["ortho_distance"]) < 1e-3
        assert float(tm["health_finite"]) == float(jm["health_finite"]) == 1.0
    for a, b in zip(jax.tree.leaves((jp, js)), tree.leaves((tp, ts))):
        np.testing.assert_allclose(b.numpy().astype(np.float64),
                                   np.asarray(a).astype(np.float64), **STEP_TOL)
    if watchdog:
        assert tapi.watchdog_summary(ts) == japi.watchdog_summary(js)


def _setup(steps=100):
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params = tortho.project_init(ttfm.init_params(gen, tcfg), tcfg)
    tc = tts.TrainConfig(warmup_steps=5, decay_steps=steps, learning_rate=1e-2,
                         pogo_learning_rate=0.3, pogo_use_kernel=True,
                         ortho_watchdog=tapi.WatchdogConfig())
    step_fn, optimizer = tts.make_train_step(tcfg, tc)
    data = tdata.DataIterator(
        tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=8, seed=1),
        device="cpu")
    return step_fn, params, optimizer.init(params), data


def test_loss_decreases_under_constraints():
    step_fn, params, opt_state, data = _setup(40)
    lc = tloop.LoopConfig(total_steps=40, log_every=10)
    _, _, _, history = tloop.train(step_fn, params, opt_state, data, lc)
    losses = [h[1]["loss"] for h in history]
    assert losses[-1] < losses[0] - 0.5, losses
    assert max(h[1]["ortho_distance"] for h in history) < 1e-3


def test_resume_is_exact(tmp_path):
    """10 straight steps against 5 + resume + 5: the same final loss and
    params, bit for bit."""
    d1 = str(tmp_path / "a")
    lc = tloop.LoopConfig(total_steps=10, log_every=1)
    p_full, _, _, hist_full = tloop.train(*_setup(), lc)
    lc5 = tloop.LoopConfig(total_steps=5, log_every=1, checkpoint_dir=d1, save_every=5,
                           async_save=False)
    tloop.train(*_setup(), lc5)
    lc10 = tloop.LoopConfig(total_steps=10, log_every=1, checkpoint_dir=d1, save_every=100)
    p_res, _, s_res, hist_res = tloop.train(*_setup(), lc10)
    assert s_res == 10
    assert hist_res[-1][1]["loss"] == hist_full[-1][1]["loss"]
    for a, b in zip(tree.leaves(p_full), tree.leaves(p_res)):
        assert torch.equal(a, b)


def test_crash_writes_checkpoint(tmp_path):
    d1 = str(tmp_path / "crash")
    step_fn, params, opt_state, data = _setup()
    calls = {"n": 0}

    def exploding_step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("injected node failure")
        return step_fn(p, o, b)

    lc = tloop.LoopConfig(total_steps=10, log_every=1, checkpoint_dir=d1,
                          save_every=100, async_save=False)
    with pytest.raises(RuntimeError, match="injected"):
        tloop.train(exploding_step, params, opt_state, data, lc)
    assert tckpt.latest_step(d1) == 3


def test_rollback_recovers_from_nan(tmp_path):
    """A non-finite loss at the fifth call rolls back to the last
    checkpoint, skips that batch and drains to completion, healthy."""
    step_fn, params, opt_state, data = _setup(10)
    calls = {"n": 0}

    def poisoned_once(p, o, b):
        calls["n"] += 1
        p2, o2, m = step_fn(p, o, b)
        if calls["n"] == 5:
            m = dict(m, loss=torch.tensor(float("nan")))
        return p2, o2, m

    lc = tloop.LoopConfig(total_steps=10, log_every=1, checkpoint_dir=str(tmp_path),
                          save_every=4, rollback=True)
    _, _, step, hist = tloop.train(poisoned_once, params, opt_state, data, lc)
    assert step == 10
    assert all(np.isfinite(h[1]["loss"]) and h[1]["health_finite"] == 1.0 for h in hist)
    assert calls["n"] == 10  # steps 0-4, rolled back to 4, step 4 skipped, 5-9


def test_rollback_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tloop.train(*_setup(2), tloop.LoopConfig(total_steps=2, rollback=True))


def test_rollback_budget_exhausts(tmp_path):
    step_fn, params, opt_state, data = _setup(4)

    def always_nan(p, o, b):
        p2, o2, m = step_fn(p, o, b)
        return p2, o2, dict(m, loss=torch.tensor(float("nan")))

    lc = tloop.LoopConfig(total_steps=4, checkpoint_dir=str(tmp_path), save_every=100,
                          rollback=True, max_rollbacks=2)
    with pytest.raises(RuntimeError, match="rollback budget"):
        tloop.train(always_nan, params, opt_state, data, lc)


def test_fault_plans_are_not_ported():
    with pytest.raises(NotImplementedError, match="faults.py"):
        tloop.train(*_setup(2), tloop.LoopConfig(total_steps=2), fault_plan=object())


def test_drift_scales_the_selected_leaves():
    _, params, _, _ = _setup(2)
    out = tloop.drift(params, 0.5, select=lambda path: "q_proj" in path)
    q0 = params["unit"][0]["inner"]["q_proj"]
    assert torch.equal(out["unit"][0]["inner"]["q_proj"], 1.5 * q0)
    assert out["unit"][0]["inner"]["k_proj"] is params["unit"][0]["inner"]["k_proj"]


def _jax_trained(jax_params, steps=2):
    jcfg, _ = _cfgs()
    jtc, _ = _train_cfgs(True, True)
    jstep, jopt = jts.make_train_step(jcfg, jtc)
    p, s = jax_params, jopt.init(jax_params)
    it = jdata.DataIterator(jdata.DataConfig(jcfg.vocab_size, 16, 4, seed=2))
    for _ in range(steps):
        p, s, _ = jax.jit(jstep)(p, s, next(it))
    return p, s


def _port_like(jax_params):
    _, tcfg = _cfgs()
    _, ttc = _train_cfgs(True, True)
    _, topt = tts.make_train_step(tcfg, ttc)
    tp = _port_params(jax_params)
    return tp, topt.init(tp)


def test_jax_checkpoint_restores_in_port(jax_params, tmp_path):
    p, s = _jax_trained(jax_params)
    jckpt.save(str(tmp_path), 2, (p, s))
    step, (tp, ts) = tckpt.restore_latest(str(tmp_path), _port_like(jax_params))
    assert step == 2
    for a, b in zip(jax.tree.leaves((p, s)), tree.leaves((tp, ts))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
    assert tapi.watchdog_summary(ts) == japi.watchdog_summary(s)
    # and the same state converted directly
    ts2 = train_state_from_jax([np.asarray(a) for a in jax.tree.leaves(s)],
                               _port_like(jax_params)[1])
    for a, b in zip(tree.leaves(ts), tree.leaves(ts2)):
        assert torch.equal(a, b)


def test_port_checkpoint_restores_in_jax(jax_params, tmp_path):
    p, s = _jax_trained(jax_params, steps=1)
    tp, ts = tckpt.restore(*_save_jax(tmp_path, p, s), _port_like(jax_params))
    tckpt.save(str(tmp_path / "port"), 7, (tp, ts))
    back = jckpt.restore(str(tmp_path / "port"), 7, (p, s))
    for a, b in zip(jax.tree.leaves((p, s)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _save_jax(tmp_path, p, s):
    jckpt.save(str(tmp_path / "jax"), 1, (p, s))
    return str(tmp_path / "jax"), 1


def test_bf16_leaves_round_trip(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    tckpt.save(str(tmp_path), 1, {"w": x, "n": torch.tensor(3, dtype=torch.int32)})
    man = json.load(open(tmp_path / "step_000000001" / "manifest.json"))
    assert man["leaves"][1]["dtype"] == "bfloat16"
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16), "n": torch.tensor(0, dtype=torch.int32)}
    back = tckpt.restore(str(tmp_path), 1, like)
    assert torch.equal(back["w"], x) and int(back["n"]) == 3
    jback = jckpt.restore(str(tmp_path), 1, {"w": jnp.zeros((3, 5), jnp.bfloat16),
                                             "n": jnp.zeros([], jnp.int32)})
    np.testing.assert_array_equal(np.asarray(jback["w"], np.float32), x.float().numpy())


def test_corrupt_checkpoint_is_named_and_skipped(tmp_path):
    like = {"w": torch.zeros(4, 4)}
    tckpt.save(str(tmp_path), 1, {"w": torch.ones(4, 4)}, keep_last=5)
    path = tckpt.save(str(tmp_path), 2, {"w": 2 * torch.ones(4, 4)}, keep_last=5)
    leaf = os.path.join(path, "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF  # one flipped payload byte: numpy still loads it
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(tckpt.CheckpointCorruptError, match="crc32"):
        tckpt.restore(str(tmp_path), 2, like)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        step, back = tckpt.restore_latest(str(tmp_path), like)
    assert step == 1 and torch.equal(back["w"], torch.ones(4, 4))
    open(leaf, "wb").write(b"garbage")
    with pytest.raises(tckpt.CheckpointCorruptError, match="expected 64 payload bytes"):
        tckpt.restore(str(tmp_path), 2, like)
    shutil.rmtree(path)
    assert tckpt.latest_step(str(tmp_path)) == 1


def test_keep_last_collects_old_steps(tmp_path):
    for s in range(5):
        tckpt.save(str(tmp_path), s, {"w": torch.full((2,), float(s))}, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000004"]
    t = tckpt.save_async(str(tmp_path), 5, {"w": torch.ones(2)}, keep_last=2)
    t.join()
    assert tckpt.latest_step(str(tmp_path)) == 5


def test_launcher_smoke_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tlaunch.main(["--arch", "smollm-360m", "--smoke", "--steps", "3",
                           "--device", "cpu", "--global-batch", "2", "--seq-len", "16",
                           "--pogo-kernel", "--watchdog"])
    assert rc == 0
    assert "done: step=3" in out.getvalue()
    assert "watchdog: {'repairs': 0" in out.getvalue()


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "test"], "sharded schedules"),
    (["--distributed"], "sharded schedules"),
    (["--ortho-grouping", "padded"], "ragged megagroups"),
])
def test_launcher_refuses_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tlaunch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", *argv])


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
