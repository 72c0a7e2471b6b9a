"""The port's auxiliary-loss bilevel problem (paper Sec. 4.2, continued
pretraining: ``repro_torch.core.problems.make_auxiliary_spec``) against the
JAX package's ``repro.core.problems.make_auxiliary_spec`` on gemma3-1b's
``SMOKE`` config, with the JAX weights and meta parameters carried over by
``repro_torch.convert`` and token batches from one numpy seed:

* the base loss (ft LM loss + the MetaWeightNet-weighted mean of the pt
  per-sequence losses) and the meta loss (the ft LM loss) within 1e-5
  relative, and their gradients in theta and lam within 5e-5 relative plus
  5e-5 of the leaf's largest entry (a gradient sums over every token);
* three SAMA meta steps from one state, warm rows and base Adam eps 1e-3,
  held as ``tests/test_torch_sama.py`` holds the data-optimization spec
  (its ``_run_pair`` and tolerances);
* both with and without the uncertainty feature;
* the nested ``{"ft", "pt"}`` batch through the scale layer: the bf16
  policy's cast boundary within ``test_torch_scale.py``'s 2e-2, and a
  SAMA step at microbatch M = 2 against JAX's;
* the CE launches a step on the CUDA route (stubbed here by the plain
  versions): 2K + 5 forwards, 2K + 1 backwards, what ``chip_smoke.py``
  phase 20 holds the card to;
* the auxiliary corpus through ``dataopt.score_dataset`` against JAX's,
  and the nested batch through the single-sync schedule's per-leaf
  slicing on the one-rank host mesh (equal to the Engine step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import scale as jscale  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import api, configs, convert, optim, scale, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.core.sama import value_and_grad  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from test_torch_sama import _np_tree, _run_pair  # noqa: E402

LOSS = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL = 5e-5
LOW_RTOL = 2e-2  # a bf16 policy's losses (tests/test_torch_scale.py)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small models are dominated by many tiny
    ops, whose thread pools spin against the other test workers' on a
    shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gemma_pair():
    jm = JaxModel(jconfigs.get_smoke_config("gemma3-1b"))
    jparams = jm.init(jax.random.PRNGKey(21))
    tm = Model(configs.get_smoke_config("gemma3-1b"), device="cpu")
    return jm, jparams, tm, convert.params_from_jax(_np_tree(jparams), device="cpu")


def _specs(jm, tm, use_uncertainty):
    return (jproblems.make_auxiliary_spec(jm.lm_loss, jm.per_example,
                                          use_uncertainty=use_uncertainty),
            problems.make_auxiliary_spec(tm.lm_loss, tm.per_example,
                                         use_uncertainty=use_uncertainty))


def _lam(use_uncertainty, seed=5):
    return _np_tree(jproblems.init_data_optimization_lam(
        jax.random.PRNGKey(seed), reweight=True, use_uncertainty=use_uncertainty))


def _aux_batches(vocab, k=2, b=4, s=16, seed=30):
    """The K ft base batches are row permutations of the meta batch's
    sequences (warm Adam rows, tests/test_torch_sama.py ``_bert_batches``);
    the pt batches are other sequences, half of them uniform tokens."""
    def batches(i):
        r = np.random.default_rng(seed + i)
        ft = r.integers(0, vocab, (b, s)).astype(np.int32)
        pt = r.integers(0, vocab, (k, b, s)).astype(np.int32)
        pt[:, ::2] = (pt[:, ::2] * 31 + 7) % vocab  # some structure in half the rows
        perms = np.stack([r.permutation(b) for _ in range(k)])
        return {"ft": {"tokens": ft[perms]}, "pt": {"tokens": pt}}, {"ft": {"tokens": ft}}
    return batches


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _t(x):
    return tree.tree_map(torch.from_numpy, x)


def _assert_grads(got, want):
    g_leaves, g_paths = tree.tree_flatten(convert.params_to_numpy(got))
    w_leaves, w_paths = tree.tree_flatten(_np_tree(want))
    assert g_paths == w_paths
    for path, a, b in zip(g_paths, g_leaves, w_leaves):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * max(float(np.max(np.abs(b))), 1e-30),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("use_uncertainty", [False, True])
def test_losses_and_gradients_match_jax(gemma_pair, use_uncertainty):
    jm, jparams, tm, tparams = gemma_pair
    jspec, tspec = _specs(jm, tm, use_uncertainty)
    lam = _lam(use_uncertainty)
    base, meta = _aux_batches(tm.cfg.vocab_size)(0)
    base = jax.tree_util.tree_map(lambda x: x[0], base)
    tlam = convert.params_from_jax(lam, device="cpu")
    for jfn, tfn, batch in ((jspec.base_scalar, tspec.base_scalar, base),
                            (jspec.meta_scalar, tspec.meta_scalar, meta)):
        jloss, (jg_theta, jg_lam) = jax.value_and_grad(jfn, argnums=(0, 1))(
            jparams, _j(lam), _j(batch))
        tloss, tg_theta = value_and_grad(tfn, 0)(tparams, tlam, _t(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS)
        _assert_grads(tg_theta, jg_theta)
        if tfn is tspec.base_scalar:
            _, tg_lam = value_and_grad(tfn, 1)(tparams, tlam, _t(batch))
            _assert_grads(tg_lam, jg_lam)
    # the meta loss reads only the ft batch, as in JAX
    assert float(tspec.meta_scalar(tparams, tlam, _t(meta))) == pytest.approx(
        float(tm.lm_loss(tparams, _t(meta["ft"]))), rel=0, abs=0)


@pytest.mark.parametrize("use_uncertainty", [False, True])
def test_sama_meta_steps_match_jax(gemma_pair, use_uncertainty):
    """Three SAMA meta steps, each from the JAX learner's state carried
    across, base Adam eps 1e-3 on warm rows (ROADMAP queue 3)."""
    jm, jparams, tm, _ = gemma_pair
    jspec, tspec = _specs(jm, tm, use_uncertainty)
    kw = dict(meta_opt="adam", meta_lr=3e-3, method="sama", unroll_steps=2)
    jlearner = japi.MetaLearner(jspec, base_opt=joptim.adam(1e-3, eps=1e-3), **kw)
    jlearner.init(jparams, _j(_lam(use_uncertainty)))
    tlearner = api.MetaLearner(tspec, base_opt=optim.adam(1e-3, eps=1e-3), **kw)
    _run_pair(jlearner, tlearner, _aux_batches(tm.cfg.vocab_size), steps=3)


def test_bf16_policy_cast_boundary_matches_jax(gemma_pair):
    """apply_to_spec casts the nested batch's float leaves (none: tokens
    pass through untouched) and theta; the losses come back f32 within
    2e-2 of JAX's under the bf16 policy."""
    jm, jparams, tm, tparams = gemma_pair
    jspec, tspec = _specs(jm, tm, False)
    lam = _lam(False)
    base, meta = _aux_batches(tm.cfg.vocab_size)(1)
    base = jax.tree_util.tree_map(lambda x: x[0], base)
    jw = jscale.apply_to_spec(jspec, jscale.resolve_policy("bf16"))
    tw = scale.apply_to_spec(tspec, scale.resolve_policy("bf16"))
    cast = scale.cast_floats(_t(base), torch.bfloat16)
    assert {x.dtype for x in tree.tree_leaves(cast)} == {torch.int32}
    tlam = convert.params_from_jax(lam, device="cpu")
    for jfn, tfn, batch in ((jw.base_scalar, tw.base_scalar, base),
                            (jw.meta_scalar, tw.meta_scalar, meta)):
        tloss = tfn(tparams, tlam, _t(batch))
        assert tloss.dtype == torch.float32
        np.testing.assert_allclose(float(tloss), float(jfn(jparams, _j(lam), _j(batch))),
                                   rtol=LOW_RTOL)


def test_sama_meta_step_at_microbatch_2_matches_jax(gemma_pair):
    """The nested batch split into M = 2 microbatches along its batch axis
    (``scale.accum.split_batch`` maps over the tree): one SAMA step against
    JAX's at the same M."""
    jm, jparams, tm, _ = gemma_pair
    jspec, tspec = _specs(jm, tm, False)
    kw = dict(meta_opt="adam", meta_lr=3e-3, method="sama", unroll_steps=2)
    jlearner = japi.MetaLearner(jspec, base_opt=joptim.adam(1e-3, eps=1e-3),
                                scale=jscale.ScaleConfig(microbatch=2), **kw)
    jlearner.init(jparams, _j(_lam(False)))
    tlearner = api.MetaLearner(tspec, base_opt=optim.adam(1e-3, eps=1e-3),
                               scale=scale.ScaleConfig(microbatch=2), **kw)
    _run_pair(jlearner, tlearner, _aux_batches(tm.cfg.vocab_size, seed=40), steps=1)


def test_ce_launches_per_step_on_the_cuda_route(monkeypatch):
    """At V 8192 (above CE_VOCAB_THRESHOLD) the LM losses take weighted_ce.
    With its CUDA route stubbed by the plain versions, one SAMA step at
    K = 2 launches 2K + 5 = 9 CE forwards (K base steps of two losses, the
    meta pass, two central-difference passes of two) and 2K + 1 = 5
    backwards (the central-difference passes differentiate in lam only)."""
    from repro_torch.kernels import dispatch, weighted_ce as wce

    calls = {"fwd": 0, "bwd": 0}
    real_route = dispatch.route

    def route(name, x, backend=None):
        return dispatch.CUDA if name == "weighted_ce" else real_route(name, x, backend)

    def fwd(x, t):
        calls["fwd"] += 1
        return wce.cross_entropy_fwd_plain(x.reshape(-1, x.shape[-1]), t)

    def bwd(x, t, lse, g):
        calls["bwd"] += 1
        return wce.cross_entropy_bwd_plain(x.reshape(-1, x.shape[-1]), t, lse,
                                           g).reshape(x.shape)

    monkeypatch.setattr(dispatch, "route", route)
    monkeypatch.setattr(wce, "_fwd_cuda", fwd)
    monkeypatch.setattr(wce, "_bwd_cuda", bwd)
    tm = Model(configs.get_smoke_config("gemma3-1b").replace(vocab_size=8192), device="cpu")
    learner = api.MetaLearner(problems.make_auxiliary_spec(tm.lm_loss, tm.per_example),
                              base_opt=optim.adam(1e-3, eps=1e-3), unroll_steps=2)
    learner.init(tm.init(0), problems.init_data_optimization_lam(1, device="cpu"))
    base, meta = _aux_batches(8192, b=2)(0)
    metrics = learner.step(_t(base), _t(meta))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert calls == {"fwd": 9, "bwd": 5}


def test_pt_corpus_scored_through_dataopt_matches_jax(gemma_pair):
    """``dataopt.score_dataset`` takes the auxiliary corpus (a flat
    ``{"tokens"}`` dataset) through the pt per-example function, as
    continued pretraining's data selection reads it: losses and the
    uncertainty feature within 1e-5 of the JAX package's pass."""
    from repro.dataopt import score_dataset as jscore_dataset
    from repro_torch.dataopt import score_dataset

    jm, jparams, tm, tparams = gemma_pair
    rows = {"tokens": np.random.default_rng(50).integers(0, tm.cfg.vocab_size, (10, 16))
            .astype(np.int32)}
    got = score_dataset(tm.per_example, tparams, rows, fields=("tokens",), batch_size=4,
                        device="cpu")
    want = jscore_dataset(jm.per_example, jparams, rows, fields=("tokens",), batch_size=4)
    for key in ("loss", "uncertainty"):
        np.testing.assert_allclose(getattr(got, key), np.asarray(getattr(want, key)),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_single_sync_schedule_takes_the_nested_batch(gemma_pair):
    """The single-sync schedule on the one-rank host mesh slices the nested
    ``{"ft", "pt"}`` batches per leaf (``Mesh.local``): one meta step equal
    to the Engine step from the same state."""
    from repro_torch.launch import mesh as mesh_mod

    _, _, tm, tparams = gemma_pair
    spec = problems.make_auxiliary_spec(tm.lm_loss, tm.per_example)
    lam = convert.params_from_jax(_lam(False), device="cpu")
    base, meta = _aux_batches(tm.cfg.vocab_size, seed=60)(0)
    out = []
    for mesh in (None, mesh_mod.make_host_mesh("cpu")):
        learner = api.MetaLearner(spec, base_opt=optim.adam(1e-3, eps=1e-3), unroll_steps=2,
                                  mesh=mesh)
        learner.init(tparams, lam)
        metrics = learner.step(_t(base), _t(meta))
        out.append(({k: float(v) for k, v in metrics.items()}, learner.state))
    (m_engine, s_engine), (m_manual, s_manual) = out
    assert m_manual == pytest.approx(m_engine, rel=1e-6)
    for a, b in zip(tree.tree_leaves(s_manual.theta), tree.tree_leaves(s_engine.theta)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
