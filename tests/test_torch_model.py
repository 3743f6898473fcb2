"""The port's dense model (``repro_torch.models``) against the JAX
package's, on the CPU, at ``smollm-360m``'s smoke config.

* The param tree has the JAX tree's paths and shapes, and the
  orthogonality helpers (labels, extract/merge, the init projection,
  feasibility telemetry) agree.
* From the same weights (``convert.params_from_jax``) and tokens, the loss
  and every gradient match ``tfm.loss_fn`` / ``jax.grad``: with
  ``compute_dtype="float32"`` at atol 1e-5 / rtol 1e-4 (loss) and atol
  2e-5 / rtol 1e-3 (grads: fp32 sums over the batch in another order);
  in bf16, where the packages round the same products at other places,
  loss within 2e-2 absolute and each gradient leaf within 5% relative
  Frobenius error. The flash blocks (8) are smaller than the sequence
  (20), which is not a multiple of them, and the loss chunk splits it
  with a remainder.
* ``remat="full"`` gives the same loss and gradients as ``"none"``, bit
  for bit (the recomputation runs the same operations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ortho as jortho
from repro.models import transformer as jtfm
from repro_torch import tree
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ortho as tortho
from repro_torch.models import transformer as ttfm
from repro_torch.train.train_step import loss_and_grads

SMALL = dict(flash_block_q=8, flash_block_k=8, loss_chunk=8)


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
    kw = {**SMALL, **kw}
    return (dataclasses.replace(jget_config("smollm-360m", smoke=True), **kw),
            dataclasses.replace(tget_config("smollm-360m", smoke=True), **kw))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    p = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jortho.project_init(p, jcfg)


def _batch(cfg, b=2, s=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def test_param_tree_matches_jax(jax_params):
    _, tcfg = _cfgs()
    tp = ttfm.init_params(torch.Generator().manual_seed(0), tcfg)
    want = [(_jax_path(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(jax_params)[0]]
    got = [("/".join(map(str, p)), tuple(x.shape)) for p, x in tree.flatten_with_path(tp)]
    assert got == want
    assert all(x.dtype == torch.float32 for x in tree.leaves(tp))


def test_ortho_helpers_match_jax(jax_params):
    jcfg, tcfg = _cfgs()
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    assert tree.leaves(tortho.label_tree(tp, tcfg)) == \
        jax.tree.leaves(jortho.label_tree(jax_params, jcfg))
    assert tortho.orthogonal_leaf_info(tp, tcfg) == [
        (p, tuple(s)) for p, s in jortho.orthogonal_leaf_info(jax_params, jcfg)]
    leaves = tortho.extract_constrained(tp, tcfg)
    assert [tuple(x.shape) for x in leaves] == [(4, 1, 40, 120), (4, 3, 40, 120)]
    merged = tortho.merge_constrained(tp, tcfg, [2 * x for x in leaves])
    assert torch.equal(tortho.extract_constrained(merged, tcfg)[0], 2 * leaves[0])
    with pytest.raises(ValueError, match="extra leaves"):
        tortho.merge_constrained(tp, tcfg, list(leaves) + [leaves[0]])
    np.testing.assert_allclose(float(tortho.max_manifold_distance(tp, tcfg)),
                               float(jortho.max_manifold_distance(jax_params, jcfg)),
                               atol=1e-6)


def test_project_init_matches_jax():
    jcfg, tcfg = _cfgs()
    raw = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    want = jortho.project_init(raw, jcfg)
    got = tortho.project_init(params_from_jax(jax.tree.map(np.asarray, raw),
                                              device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    assert float(tortho.max_manifold_distance(got, tcfg)) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(jax_params, dtype):
    jcfg, tcfg = _cfgs(compute_dtype=dtype)
    batch = _batch(jcfg)
    (jloss, _), jgrads = jax.value_and_grad(jtfm.loss_fn, has_aux=True)(
        jax_params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    tloss, tgrads = loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=1e-4)
    else:
        assert abs(float(tloss) - float(jloss)) < 2e-2
    for (path, g), jg in zip(tree.flatten_with_path(tgrads), jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), jg, atol=2e-5, rtol=1e-3,
                                       err_msg=str(path))
        else:
            err = np.linalg.norm(g.numpy() - jg) / max(np.linalg.norm(jg), 1e-12)
            assert err < 5e-2, (path, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_full_equals_none(jax_params, dtype):
    _, t_none = _cfgs(compute_dtype=dtype, remat="none")
    _, t_full = _cfgs(compute_dtype=dtype, remat="full")
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in _batch(t_none).items()}
    l0, g0 = loss_and_grads(tp, t_none, batch)
    l1, g1 = loss_and_grads(tp, t_full, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)


def test_microbatches_match_jax_train_step(jax_params):
    """Two microbatches: the mean loss and the averaged gradients of the
    two halves, as the JAX step's scan computes them."""
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    batch = _batch(jcfg, b=4)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in range(2)]
    outs = [jax.value_and_grad(jtfm.loss_fn, has_aux=True)(
        jax_params, jcfg, {k: jnp.asarray(v) for k, v in h.items()}) for h in halves]
    jloss = sum(float(o[0][0]) for o in outs) / 2
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    tloss, tgrads = loss_and_grads(
        tp, tcfg, {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()},
        microbatches=2)
    np.testing.assert_allclose(float(tloss), jloss, atol=1e-5, rtol=1e-4)
    for g, a, b in zip(tree.leaves(tgrads), jax.tree.leaves(outs[0][1]),
                       jax.tree.leaves(outs[1][1])):
        np.testing.assert_allclose(g.numpy(), (np.asarray(a) + np.asarray(b)) / 2,
                                   atol=2e-5, rtol=1e-3)


def test_other_families_raise():
    with pytest.raises(NotImplementedError, match="models \\+ training stack"):
        tget_config("falcon-mamba-7b")
    _, tcfg = _cfgs(block_pattern=("rglru", "attn"))
    with pytest.raises(NotImplementedError, match="models \\+ training stack"):
        ttfm.init_params(torch.Generator().manual_seed(0), tcfg)
