"""The port's baseline hypergradient estimators (``core/baselines.py``,
``core/methods/baselines.py``: t1t2, neumann, cg, iterdiff) against the JAX
package's:

* through ``MetaLearner``, step by step from one state carried across by
  ``repro_torch.convert``, on the quickstart problem (four meta steps) and
  one ``mini_bert`` meta step, with ``tests/test_torch_sama.py``'s loss
  and update tolerances;
* the hypergradient itself, per leaf within 1e-4 of the leaf's largest
  entry, on the same inputs;
* the closed-form cases of ``tests/test_hypergrad.py`` (f64);
* iterative differentiation's NaN where a base gradient is exactly 0 but
  depends on lam (Adam's sqrt(vhat) at 0: 0 * inf), in the same place in
  both packages;
* with the CUDA route stubbed by the plain versions: the base unroll and
  the meta gradient take the kernel route, the passes that differentiate
  twice take ``"second order"``, and outside ``dispatch.second_order`` a
  second derivative through the kernels raises.

Two properties of the reference shape the inputs. Iterative
differentiation restarts Adam from a fresh state, whose first-step
diagonal lr eps / (|g| + eps)^2 is ~lr / eps on rounding-level gradients:
at eps 1e-8 those coordinates decide the hypergradient in either package
(1.8% apart on mini_bert), so its mini_bert case takes base Adam eps 1e-3
(ROADMAP queue 3). CG at 5 iterations meets a negative curvature p.Ap on
mini_bert's nonconvex base loss, clamps it to 1e-30 and diverges to NaN in
both packages; its case with 2 iterations stays finite and is held.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import BilevelSpec as JBilevelSpec  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import api, configs, convert, optim, tree  # noqa: E402
from repro_torch.core import BilevelSpec, EngineConfig, available_methods  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.kernels import dispatch, flash_attn  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from test_torch_sama import (_bert_batches, _mini_bert, _np_tree,  # noqa: E402
                             _quickstart_data, _run_pair)

BASELINES = ("t1t2", "neumann", "cg", "iterdiff")
#: per leaf, the largest hypergradient difference over the leaf's largest
#: entry. CG's on mini_bert measured 6.5e-4: its second iteration has
#: beta ~230 (the residual grows 15x on a nonconvex loss), so the rounding
#: of two HVP chains is scaled up in the update; held at 1e-3 there.
HYPER_SHARE, CG_BERT_SHARE = 1e-4, 1e-3


def _linear(th, x):
    return x @ th["w"] + th["b"]


def _specs():
    return (jproblems.make_data_optimization_spec(jproblems.softmax_per_example(_linear),
                                                  reweight=True),
            problems.make_data_optimization_spec(problems.softmax_per_example(_linear),
                                                 reweight=True))


def _assert_hyper(got, want, share=HYPER_SHARE):
    """Per leaf: max |got - want| within ``share`` of max |want|."""
    g_leaves, g_paths = tree.tree_flatten(convert.params_to_numpy(got))
    w_leaves, w_paths = tree.tree_flatten(_np_tree(want))
    assert g_paths == w_paths
    for path, a, b in zip(g_paths, g_leaves, w_leaves):
        assert np.all(np.isfinite(b)), "/".join(path)
        bound = share * np.max(np.abs(b))
        assert np.max(np.abs(a - b)) <= bound, (
            f"{'/'.join(path)}: {np.max(np.abs(a - b)):.3e} > {bound:.3e}")


def _hyper_pair(method, jspec, tspec, theta0, jlam, base, meta, base_opts, **kw):
    """The hypergradient of ``method`` in both packages on the inputs of a
    meta step: theta after the K-step Adam unroll from theta0 and the last
    base batch (iterdiff unrolls from theta0 itself). The JAX side runs
    jitted."""
    jopt, topt = base_opts
    jb = jax.tree_util.tree_map(jnp.asarray, base)
    jm = jax.tree_util.tree_map(jnp.asarray, meta)
    tb = tree.tree_map(torch.from_numpy, base)
    tm = tree.tree_map(torch.from_numpy, meta)
    tlam = convert.params_from_jax(_np_tree(jlam), device="cpu")
    if method == "iterdiff":
        want = jax.jit(lambda th, lam: jbl.iterdiff_hypergrad(jspec, th, lam, jb, jm,
                                                              base_opt=jopt))(theta0, jlam)
        got = bl.iterdiff_hypergrad(tspec, convert.params_from_jax(_np_tree(theta0), device="cpu"),
                                    tlam, tb, tm, base_opt=topt)
        return got, want
    theta, st = theta0, jopt.init(theta0)
    for i in range(jax.tree_util.tree_leaves(jb)[0].shape[0]):
        batch = jax.tree_util.tree_map(lambda x: x[i], jb)
        upd, st = jopt.update(jax.grad(jspec.base_scalar)(theta, jlam, batch), st, theta)
        theta = joptim.apply_updates(theta, upd)
    jlast = jax.tree_util.tree_map(lambda x: x[-1], jb)
    want = jax.jit(lambda th, lam: jbl.HYPERGRAD_BASELINES[method](jspec, th, lam, jlast, jm,
                                                                   **kw))(theta, jlam)
    got = bl.HYPERGRAD_BASELINES[method](
        tspec, convert.params_from_jax(_np_tree(theta), device="cpu"), tlam,
        tree.tree_map(lambda x: x[-1], tb), tm, **kw)
    return got, want


def test_engine_config_takes_all_six_methods_and_their_knobs():
    assert available_methods() == ("cg", "iterdiff", "neumann", "sama", "sama_na", "t1t2")
    for m in available_methods():
        assert EngineConfig(method=m).resolve().name == m
    tspec = _specs()[1]
    learner = api.MetaLearner(tspec, method="neumann", neumann_terms=7, neumann_scale=0.2)
    assert (learner.method.cfg.num_terms, learner.method.cfg.scale) == (7, 0.2)
    learner = api.MetaLearner(tspec, method="cg", cg_iters=3, cg_damping=0.5)
    assert (learner.method.cfg.num_iters, learner.method.cfg.damping) == (3, 0.5)
    assert [api.MetaLearner(tspec, method=m).method.reduce_contract.linear
            for m in BASELINES] == [True, False, False, False]


# ---------------------------------------------------------------------------
# the quickstart problem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", BASELINES)
def test_quickstart_matches_jax_step_by_step(method):
    d, batches = _quickstart_data()
    jspec, tspec = _specs()
    kw = dict(base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2, method=method,
              unroll_steps=2)
    jlearner = japi.MetaLearner(jspec, **kw)
    jlearner.init({"w": jnp.zeros((d, 2)), "b": jnp.zeros((2,))},
                  jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True))
    _run_pair(jlearner, api.MetaLearner(tspec, **kw), batches, steps=4)


@pytest.mark.parametrize("method", BASELINES)
def test_quickstart_hypergradient_matches_jax_per_leaf(method):
    d, batches = _quickstart_data()
    jspec, tspec = _specs()
    rng = np.random.default_rng(1)
    theta0 = {"w": jnp.asarray(rng.standard_normal((d, 2)).astype(np.float32)),
              "b": jnp.zeros((2,))}
    jlam = jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True)
    base, meta = batches(0)
    got, want = _hyper_pair(method, jspec, tspec, theta0, jlam, base, meta,
                            (joptim.adam(1e-2), optim.adam(1e-2)))
    _assert_hyper(got, want)


# ---------------------------------------------------------------------------
# mini_bert, the bert-base smoke encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert_pair():
    jm = JaxModel(_mini_bert(jconfigs, False))
    return jm, jm.init(jax.random.PRNGKey(0))


def _bert_kw(method, knobs):
    eps = 1e-3 if method == "iterdiff" else 1e-8
    kw = dict(base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method=method, unroll_steps=2,
              **knobs)
    return eps, kw


BERT_CASES = [("t1t2", {}), ("neumann", {}), ("cg", {"cg_iters": 2}), ("iterdiff", {})]


@pytest.mark.parametrize("method,knobs", BERT_CASES)
def test_mini_bert_meta_step_matches_jax(bert_pair, method, knobs):
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    eps, kw = _bert_kw(method, knobs)
    jlearner = japi.MetaLearner(
        jproblems.make_data_optimization_spec(jm.classifier_per_example),
        base_opt=joptim.adam(1e-3, eps=eps), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.classifier_per_example),
                               base_opt=optim.adam(1e-3, eps=eps), **kw)
    _run_pair(jlearner, tlearner, _bert_batches(7), steps=1)


@pytest.mark.parametrize("method,knobs", BERT_CASES)
def test_mini_bert_hypergradient_matches_jax_per_leaf(bert_pair, method, knobs):
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    eps, _ = _bert_kw(method, knobs)
    kw = {"num_iters": knobs["cg_iters"]} if knobs else {}
    base, meta = _bert_batches(7)(0)
    got, want = _hyper_pair(
        method, jproblems.make_data_optimization_spec(jm.classifier_per_example),
        problems.make_data_optimization_spec(tm.classifier_per_example), jparams,
        jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)), base, meta,
        (joptim.adam(1e-3, eps=eps), optim.adam(1e-3, eps=eps)), **kw)
    _assert_hyper(got, want, CG_BERT_SHARE if method == "cg" else HYPER_SHARE)


def test_mini_bert_cg_diverges_to_nan_in_both_packages(bert_pair):
    """The reference's CG at its default 5 iterations: p.Ap < 0 on the
    third, clamped to 1e-30, so alpha ~1e35 and the solve overflows. The
    port computes the same NaN, and the metrics before it agree."""
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="cg",
              unroll_steps=2)
    jlearner = japi.MetaLearner(
        jproblems.make_data_optimization_spec(jm.classifier_per_example), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.classifier_per_example),
                               **kw)
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    base, meta = _bert_batches(7)(0)
    jmet = jlearner.step(jax.tree_util.tree_map(jnp.asarray, base),
                         jax.tree_util.tree_map(jnp.asarray, meta))
    tmet = tlearner.step(tree.tree_map(torch.from_numpy, base),
                         tree.tree_map(torch.from_numpy, meta))
    for key in ("base_loss", "meta_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5)
    assert np.isnan(float(jmet["hypergrad_norm"])) and np.isnan(float(tmet["hypergrad_norm"]))
    for got, want in zip(tree.tree_leaves(convert.params_to_numpy(tlearner.state.lam)),
                         tree.tree_leaves(_np_tree(jlearner.state.lam))):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ---------------------------------------------------------------------------
# closed forms (tests/test_hypergrad.py), in f64
# ---------------------------------------------------------------------------


class _BiasedRegression:
    """lam* = argmin ||X' w*(lam) - y'||^2 ;  w*(lam) = argmin ||Xw-y||^2 +
    beta ||w-lam||^2 (paper Appendix E), in numpy with a closed form."""

    def __init__(self, n=64, n_meta=48, d=10, beta=0.1, seed=0):
        rng = np.random.default_rng(seed)
        self.X = rng.standard_normal((n, d)) / np.sqrt(d)
        self.Xp = rng.standard_normal((n_meta, d)) / np.sqrt(d)
        w_true = rng.standard_normal(d)
        self.y = self.X @ w_true + 0.1 * rng.standard_normal(n)
        self.yp = self.Xp @ w_true
        self.beta, self.d = beta, d
        X, y, Xp, yp = (torch.from_numpy(a) for a in (self.X, self.y, self.Xp, self.yp))
        self.spec = BilevelSpec(
            base_loss=lambda th, lam, b: torch.sum((X @ th["w"] - y) ** 2)
            + beta * torch.sum((th["w"] - lam["w"]) ** 2),
            meta_loss=lambda th, lam, b: torch.sum((Xp @ th["w"] - yp) ** 2))

    def _a(self):
        return self.X.T @ self.X + self.beta * np.eye(self.d)

    def w_star(self, lam):
        return np.linalg.solve(self._a(), self.X.T @ self.y + self.beta * lam)

    def true_hypergrad(self, lam):
        r = self.Xp @ self.w_star(lam) - self.yp
        return 2.0 * self.beta * np.linalg.solve(self._a(), self.Xp.T @ r)


def _t(a):
    return {"w": torch.from_numpy(np.asarray(a, np.float64))}


@pytest.mark.parametrize("method", ["cg", "neumann"])
def test_closed_form_biased_regression(method):
    prob = _BiasedRegression()
    lam = np.full(prob.d, 1.0 if method == "cg" else 0.5)
    theta = _t(prob.w_star(lam))
    if method == "cg":
        g = bl.cg_hypergrad(prob.spec, theta, _t(lam), None, None, num_iters=50, damping=0.0)
        rtol = 1e-6
    else:  # scale must satisfy ||I - scale*H|| < 1 for convergence
        g = bl.neumann_hypergrad(prob.spec, theta, _t(lam), None, None, num_terms=3000,
                                 scale=0.05)
        rtol = 1e-3
    np.testing.assert_allclose(g["w"].numpy(), prob.true_hypergrad(lam), rtol=rtol)


def test_t1t2_equals_sama_na_on_a_quadratic():
    """On a quadratic the central difference is exact, so SAMA-NA's
    hypergradient equals T1-T2's exact mixed VJP."""
    from repro_torch.core import SAMAConfig, sama_hypergrad
    from repro_torch.core.sama import value_and_grad

    prob = _BiasedRegression()
    lam = _t(np.full(prob.d, 0.3))
    theta = _t(prob.w_star(lam["w"].numpy()))
    opt = optim.sgd(1.0)
    _, g_base = value_and_grad(prob.spec.base_scalar, 0)(theta, lam, None)
    res = sama_hypergrad(prob.spec, theta, lam, None, None, base_opt=opt,
                         base_opt_state=opt.init(theta), g_base=g_base,
                         cfg=SAMAConfig(alpha=1.0, adapt=False))
    g = bl.t1t2_hypergrad(prob.spec, theta, lam, None, None)
    np.testing.assert_allclose(res.hypergrad["w"].numpy(), g["w"].numpy(), rtol=1e-5)


def test_iterdiff_runs_and_descends():
    prob = _BiasedRegression()
    lam, theta = _t(np.zeros(prob.d)), _t(np.zeros(prob.d))
    g = bl.iterdiff_hypergrad(prob.spec, theta, lam, torch.zeros((8, 1)), None,
                              base_opt=optim.sgd(0.05))["w"].numpy()
    assert np.all(np.isfinite(g))

    def meta_at(lam_w):
        return float(np.sum((prob.Xp @ prob.w_star(lam_w) - prob.yp) ** 2))

    assert meta_at(-0.05 * g) <= meta_at(np.zeros(prob.d)) + 1e-9


# ---------------------------------------------------------------------------
# the reference's NaN in iterative differentiation
# ---------------------------------------------------------------------------


def test_iterdiff_nan_at_an_exact_zero_gradient_matches_jax():
    """A 4x2 embedding, base loss sum_i sigmoid(w_i) ||E[b_i]||^2 with
    E[0, 0] = 0, Adam at lr 1e-2 from a fresh state: the base gradient of
    E[0, 0] is exactly 0 and depends on w_0, so differentiating Adam's
    sqrt(vhat) at 0 gives 0 * inf = NaN in w_0's hypergradient, in both
    packages. Row 3, which no batch reads, gives none (the gather's
    transpose drops its cotangent). w_1's entry is rounding-level in both."""
    E = np.array([[0.0, 0.5], [0.3, -0.2], [1.0, 2.0], [-0.7, 0.1]], np.float32)
    w = np.array([0.2, -0.4], np.float32)
    base = np.array([[0, 1], [0, 1]], np.int32)
    meta = np.array([1, 2], np.int32)
    jspec = JBilevelSpec(
        base_loss=lambda th, lam, b: jnp.sum(jax.nn.sigmoid(lam["w"])
                                             * jnp.sum(th["E"][b] ** 2, -1)),
        meta_loss=lambda th, lam, b: jnp.sum(th["E"][b]))
    tspec = BilevelSpec(
        base_loss=lambda th, lam, b: torch.sum(torch.sigmoid(lam["w"])
                                               * torch.sum(th["E"][b.long()] ** 2, -1)),
        meta_loss=lambda th, lam, b: torch.sum(th["E"][b.long()]))
    want = np.asarray(jbl.iterdiff_hypergrad(
        jspec, {"E": jnp.asarray(E)}, {"w": jnp.asarray(w)}, jnp.asarray(base),
        jnp.asarray(meta), base_opt=joptim.adam(1e-2))["w"])
    got = bl.iterdiff_hypergrad(
        tspec, {"E": torch.from_numpy(E)}, {"w": torch.from_numpy(w)}, torch.from_numpy(base),
        torch.from_numpy(meta), base_opt=optim.adam(1e-2))["w"].numpy()
    assert np.isnan(want[0]) and np.isnan(got[0])
    assert np.isfinite(want[1]) and np.isfinite(got[1])
    np.testing.assert_allclose(got[1], want[1], atol=1e-8)


def test_mini_bert_iterdiff_nan_from_a_zero_mlp_gradient_matches_jax(bert_pair):
    """The mechanism at a model's shape: with row 5 of layer 0's MLP down
    projection zeroed, column 5 of its up projection has a base gradient of
    exactly 0 that still depends on lam (through the per-example weights),
    as one ``layers/mlp/up`` coordinate has at bert-base. Iterative
    differentiation then gives NaN in lam's hypergradient in both
    packages, in the same coordinates, and the rest agrees."""
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    down = np.array(jparams["layers"]["mlp"]["down"])
    down[0, 5, :] = 0.0
    jparams = {**jparams, "layers": {**jparams["layers"], "mlp": {
        **jparams["layers"]["mlp"], "down": jnp.asarray(down)}}}
    base, meta = _bert_batches(7)(0)
    got, want = _hyper_pair(
        "iterdiff", jproblems.make_data_optimization_spec(jm.classifier_per_example),
        problems.make_data_optimization_spec(tm.classifier_per_example), jparams,
        jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)), base, meta,
        (joptim.adam(1e-3, eps=1e-3), optim.adam(1e-3, eps=1e-3)))
    g_leaves = tree.tree_leaves(convert.params_to_numpy(got))
    w_leaves = tree.tree_leaves(_np_tree(want))
    assert any(np.isnan(w).any() for w in w_leaves)
    for a, b in zip(g_leaves, w_leaves):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = np.isfinite(b)
        if ok.any():
            bound = HYPER_SHARE * np.max(np.abs(b[ok]))
            assert np.max(np.abs(a[ok] - b[ok])) <= bound


# ---------------------------------------------------------------------------
# routes: the unroll on the kernels, the second-order passes plain
# ---------------------------------------------------------------------------


def _launches(method, layers, unroll):
    """Per meta step of a remat encoder: flash forwards, and dq = dk/dv
    launches. The unroll takes K forwards and K backwards (each recomputing
    its forward); t1t2, neumann and cg add the meta gradient (one more of
    each) and the meta loss's forward; iterdiff adds the meta loss's
    forward only, its re-unroll being second order."""
    k = unroll if method == "iterdiff" else unroll + 1
    return {"fwd": layers * (k + 1) + layers * k, "bwd": layers * k}


def _stub_cuda_route(monkeypatch, calls):
    """Every CPU tensor takes the CUDA route, its kernels replaced by their
    plain versions, counting the calls."""
    def fwd(*a, **kw):
        calls["fwd"] += 1
        return flash_attn.flash_attention_fwd_plain(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return flash_attn.flash_attention_bwd_plain(*a, **kw)

    monkeypatch.setattr(dispatch, "_device_route",
                        lambda name, x: (dispatch.CUDA, "cuda tensor"))
    monkeypatch.setattr(flash_attn, "_fwd_cuda", fwd)
    monkeypatch.setattr(flash_attn, "_bwd_cuda", bwd)


def _bert_learner(bert_pair, method):
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    learner = api.MetaLearner(problems.make_data_optimization_spec(tm.classifier_per_example),
                              base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3,
                              method=method, unroll_steps=2)
    learner.init(convert.params_from_jax(_np_tree(jparams), device="cpu"),
                 problems.init_data_optimization_lam(1, device="cpu"))
    base, meta = _bert_batches(7)(0)
    return learner, tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta)


@pytest.mark.parametrize("method", BASELINES)
def test_unroll_takes_the_kernels_and_second_order_passes_plain(bert_pair, method,
                                                                monkeypatch):
    learner, base, meta = _bert_learner(bert_pair, method)
    want_metrics = learner.step_fn(learner.state, base, meta)[1]
    calls = {"fwd": 0, "bwd": 0}
    _stub_cuda_route(monkeypatch, calls)
    dispatch.reset_launches()
    got_metrics = learner.step_fn(learner.state, base, meta)[1]
    routes = dispatch.route_counts()
    assert calls == _launches(method, 2, 2)
    assert routes[(dispatch.CUDA, "cuda tensor")] == calls["fwd"]
    assert routes[(dispatch.PLAIN, dispatch.SECOND_ORDER)] > 0
    assert set(routes) == {(dispatch.CUDA, "cuda tensor"), (dispatch.PLAIN, dispatch.SECOND_ORDER)}
    for key in ("base_loss", "meta_loss", "hypergrad_norm"):
        np.testing.assert_allclose(float(got_metrics[key]), float(want_metrics[key]),
                                   rtol=2e-3, err_msg=key)


def test_second_derivative_through_the_kernels_outside_the_context_raises(bert_pair,
                                                                          monkeypatch):
    learner, base, meta = _bert_learner(bert_pair, "t1t2")
    _stub_cuda_route(monkeypatch, {"fwd": 0, "bwd": 0})
    monkeypatch.setattr(dispatch, "second_order", contextlib.nullcontext)
    with pytest.raises(RuntimeError, match="flash_attention: a second derivative through the "
                       "CUDA kernels is not supported"):
        learner.step_fn(learner.state, base, meta)
