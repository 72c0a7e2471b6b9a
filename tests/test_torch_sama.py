"""The port's SAMA meta step (``repro_torch.api.MetaLearner`` over
``core/engine.py``, ``core/sama.py``, the optimizers and the bert encoder)
against the JAX package's ``repro.api.MetaLearner``, step by step from one
state carried across by ``repro_torch.convert``:

* (a) the ``examples/quickstart.py`` problem: logistic regression, 40% of
  the labels flipped, MetaWeightNet, Adam at both levels, unroll 2, five
  meta steps, for ``sama`` and (c) ``sama_na``;
* (b) one meta step of ``mini_bert`` (``benchmarks/common.py``: the
  bert-base smoke encoder, 2 layers, d_model 128, 4 labels, f32), with and
  without remat in the port;

plus the encoder's forward and per-example losses, the dense forward, the
parameter trees, the ``weighted_ce`` route and the CPU train smoke. The
quickstart problem also runs with Lion and Adafactor at the base level.

Tolerances. Losses: 1e-5 relative (f32, the same ops summed in another
order). The hypergradient is a central difference, -(g+ - g-) / (2 eps)
with eps = alpha/||v||: the two lam gradients agree to ~1e-7 of their
size and their difference is a small fraction of it, so dividing by 2 eps
scales their rounding up: hypergrad_norm and eps get 2e-3 relative.
Theta and lam are held, leaf by leaf, against the largest update the JAX
step made in that leaf: the largest difference within 1e-6 + 5% of it.
Adam and SAMA's adaptation diagonal divide each gradient by its own root
mean square, so a coordinate whose gradient is near its rounding noise
keeps that noise, relatively, in its step: the base nudge theta - eps v
moves theta by a vector of norm alpha = 1, and its largest coordinates
differ by ~3% of their size between the packages (and an Adam step and the
nudge can nearly cancel on a coordinate, so the bound is per leaf, not per
coordinate). A leaf the step did not move must stay within 1e-6.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import api, configs, convert, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import Model  # noqa: E402

LOSS = dict(rtol=1e-5, atol=1e-7)
HYPER = dict(rtol=2e-3, atol=1e-7)
UPDATE_SHARE, UPDATE_ATOL = 0.05, 1e-6


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_update(got, want, before):
    """Per leaf: max |got - want| within UPDATE_ATOL + UPDATE_SHARE of the
    largest step JAX took in that leaf (``want - before``)."""
    g_leaves, g_paths = tree.tree_flatten(convert.params_to_numpy(got))
    w_leaves, w_paths = tree.tree_flatten(_np_tree(want))
    b_leaves = tree.tree_leaves(_np_tree(before))
    assert g_paths == w_paths
    for path, a, b, b0 in zip(g_paths, g_leaves, w_leaves, b_leaves):
        bound = UPDATE_ATOL + UPDATE_SHARE * np.max(np.abs(b - b0))
        worst = np.max(np.abs(a - b)) / bound
        assert worst <= 1.0, f"{'/'.join(path)}: {worst:.2f} of the bound"


def _run_pair(jlearner, tlearner, batches, steps):
    """Step both learners from the JAX learner's state; compare after
    every step."""
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    for i in range(steps):
        base, meta = batches(i)
        before = _np_tree(jlearner.state)
        jm = jlearner.step(jax.tree_util.tree_map(jnp.asarray, base),
                           jax.tree_util.tree_map(jnp.asarray, meta))
        tm = tlearner.step(tree.tree_map(torch.from_numpy, base),
                           tree.tree_map(torch.from_numpy, meta))
        for key in ("base_loss", "meta_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **LOSS)
        for key in ("eps", "hypergrad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **HYPER)
        _assert_update(tlearner.state.theta, jlearner.state.theta, before.theta)
        _assert_update(tlearner.state.lam, jlearner.state.lam, before.lam)
        assert int(tlearner.state.step) == int(jlearner.state.step) == i + 1


# ---------------------------------------------------------------------------
# (a), (c): the quickstart problem
# ---------------------------------------------------------------------------


def _quickstart_data():
    rng = np.random.default_rng(0)
    d, n = 16, 512
    w_true = rng.standard_normal(d).astype(np.float32)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y_true = (X @ w_true > 0).astype(np.int32)
    y_noisy = np.where(np.arange(n) < int(0.4 * n), 1 - y_true, y_true).astype(np.int32)
    Xm = rng.standard_normal((256, d)).astype(np.float32)
    ym = (Xm @ w_true > 0).astype(np.int32)

    def batches(i):
        r = np.random.default_rng(100 + i)
        idx, midx = r.integers(0, n, (2, 64)), r.integers(0, 256, 64)
        return {"x": X[idx], "y": y_noisy[idx]}, {"x": Xm[midx], "y": ym[midx]}

    return d, batches


@pytest.mark.parametrize("method,knobs", [
    ("sama", {}),
    ("sama_na", {}),
    ("sama", {"adapt_clip": 10.0, "alpha": 0.5, "base_nudge": False}),
    ("sama", {"base_opt": "lion"}),
    ("sama", {"base_opt": "adafactor"}),
])
def test_quickstart_matches_jax_step_by_step(method, knobs):
    """``adapt_clip`` takes the unfused path: the adaptation diagonal,
    clipped, then the product and a separate norm. The Lion and Adafactor
    bases take their fused adaptation products (the 2-D weight is
    Adafactor's factored leaf, the bias its full-moment one)."""
    d, batches = _quickstart_data()
    kw = {**dict(base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2,
                 method=method, unroll_steps=2), **knobs}
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    tspec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    jlearner = japi.MetaLearner(jspec, **kw)
    jlearner.init({"w": jnp.zeros((d, 2)), "b": jnp.zeros((2,))},
                  jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True))
    _run_pair(jlearner, api.MetaLearner(tspec, **kw), batches, steps=5)


def test_engine_run_equals_meta_learner_fit():
    """The level-2 Engine and the MetaLearner facade drive the same step:
    the same metric history from the same state and batches."""
    from repro_torch.core import Engine, EngineConfig

    d, batches = _quickstart_data()
    spec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]))
    theta = {"w": torch.zeros((d, 2)), "b": torch.zeros(2)}
    lam = problems.init_data_optimization_lam(3, device="cpu")

    def it():
        for i in range(3):
            base, meta = batches(i)
            yield tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta)

    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-2, meta_opt="adam",
                              meta_lr=1e-2, unroll_steps=2)
    learner.init(theta, lam)
    hist = learner.fit(it(), steps=3, log_every=1)
    engine = Engine(spec, learner.base_opt, learner.meta_opt, EngineConfig(unroll_steps=2))
    _, hist_e = engine.run(engine.init(theta, lam), it(), 3, log_every=1)
    assert hist == hist_e and [h["step"] for h in hist] == [0, 1, 2]


def test_state_crosses_to_jax_and_back():
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]))
    jl = japi.MetaLearner(jspec, base_opt="adam", meta_opt="sgd", unroll_steps=2)
    jl.init({"w": jnp.ones((3, 2)), "b": jnp.zeros((2,))},
            jproblems.init_data_optimization_lam(jax.random.PRNGKey(0)))
    jstate = _np_tree(jl.state)
    back = convert.state_to_numpy(convert.state_from_jax(jstate, device="cpu"))
    assert back.meta_opt_state.mu is None and back.base_opt_state.count.dtype == np.int32
    got, want = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)
    # theta 2, adam count + mu 2 + nu 2, lam 4, sgd count, step
    assert len(got) == len(want) == 13
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_label_correction_spec_matches_jax():
    """make_data_optimization_spec with the label corrector as well as the
    weight net: base and meta losses and their lam gradients."""
    d, batches = _quickstart_data()
    jlam = _np_tree(jproblems.init_data_optimization_lam(
        jax.random.PRNGKey(5), reweight=True, correct=True, num_classes=2,
        use_uncertainty=True))
    theta = {"w": np.random.default_rng(1).standard_normal((d, 2)).astype(np.float32),
             "b": np.zeros(2, np.float32)}
    base, _ = batches(0)
    batch = {"x": base["x"][0], "y": base["y"][0]}
    kw = dict(reweight=True, correct=True, use_uncertainty=True)
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), **kw)
    tspec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), **kw)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jloss, jgrad = jax.value_and_grad(jspec.base_loss, argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, theta), jax.tree_util.tree_map(jnp.asarray, jlam),
        jb)
    from repro_torch.core.sama import value_and_grad

    tloss, tgrad = value_and_grad(tspec.base_loss, 1)(
        tree.tree_map(torch.from_numpy, theta), convert.params_from_jax(jlam, device="cpu"),
        tree.tree_map(torch.from_numpy, batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for (path, g), want in zip(zip(*reversed(tree.tree_flatten(tgrad))),
                               tree.tree_leaves(_np_tree(jgrad))):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# (b): mini_bert, the bert-base smoke encoder
# ---------------------------------------------------------------------------


def _mini_bert(pkg_configs, remat):
    return pkg_configs.get_smoke_config("bert-base").replace(
        d_model=128, num_layers=2, num_labels=4, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=256, remat=remat)


@pytest.fixture(scope="module")
def bert_pair():
    jm = JaxModel(_mini_bert(jconfigs, False))
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams


def _bert_batches(seed, k=2, b=8, s=32, vocab=512):
    """The K base batches are row permutations of one set of sequences and
    the meta batch is that set with other labels, so every parameter row
    the meta gradient touches has warm Adam moments where the adaptation
    is taken. On a row first seen in the last base batch the exact Adam
    diagonal is lr a eps / (sqrt(b) |g| + eps)^2, ~1/g^2, and on a row only
    the meta batch reads it is lr / eps_adam: v and eps then follow the
    smallest gradients' rounding in either package (ROADMAP queue 3)."""
    def batches(i):
        r = np.random.default_rng(seed + i)
        toks = r.integers(0, vocab, (b, s)).astype(np.int32)
        perms = np.stack([r.permutation(b) for _ in range(k)])
        base = {"tokens": toks[perms], "y": r.integers(0, 4, (k, b)).astype(np.int32)}
        meta = {"tokens": toks, "y": r.integers(0, 4, (b,)).astype(np.int32)}
        return base, meta
    return batches


@pytest.mark.parametrize("remat", [False, True])
def test_mini_bert_meta_step_matches_jax(bert_pair, remat):
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, remat), device="cpu")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="sama",
              unroll_steps=2)
    jlearner = japi.MetaLearner(
        jproblems.make_data_optimization_spec(jm.classifier_per_example), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.classifier_per_example),
                               **kw)
    _run_pair(jlearner, tlearner, _bert_batches(7), steps=1)


def test_encoder_forward_and_per_example_match_jax(bert_pair):
    jm, jparams = bert_pair
    tm = Model(_mini_bert(configs, True), device="cpu")
    tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
    base, _ = _bert_batches(3)(0)
    batch = {"tokens": base["tokens"][0], "y": base["y"][0]}
    jpe = jm.classifier_per_example(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    tpe = tm.classifier_per_example(tparams, tree.tree_map(torch.from_numpy, batch))
    for key in ("loss", "logits", "label_onehot", "uncertainty"):
        np.testing.assert_allclose(getattr(tpe, key).detach().numpy(),
                                   np.asarray(getattr(jpe, key)), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_dense_forward_and_lm_losses_match_jax():
    jcfg = jconfigs.get_smoke_config("gemma3-1b")
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(4))
    tm = Model(configs.get_smoke_config("gemma3-1b"), device="cpu")
    tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jlogits, _ = jm.forward(jparams, jb)
    tlogits, _ = tm.forward(tparams, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(tm.lm_loss(tparams, tb)), float(jm.lm_loss(jparams, jb)),
                               rtol=1e-5)
    jpe, tpe = jm.per_example(jparams, jb), tm.per_example(tparams, tb)
    for key in ("loss", "uncertainty"):
        np.testing.assert_allclose(getattr(tpe, key).detach().numpy(),
                                   np.asarray(getattr(jpe, key)), rtol=1e-5, err_msg=key)


def test_config_and_parameter_tree_match_jax():
    for get in ("get_config", "get_smoke_config"):
        a, b = getattr(configs, get)("bert-base"), getattr(jconfigs, get)("bert-base")
        assert a.__dict__ == b.__dict__
    cfg = configs.get_config("bert-base")
    shapes = jax.eval_shape(lambda: JaxModel(jconfigs.get_config("bert-base")).init(
        jax.random.PRNGKey(0)))
    from repro_torch.models import transformer as tf
    got = tf.init_params(cfg, device="meta")
    g_leaves, g_paths = tree.tree_flatten(got)
    w_leaves, w_paths = tree.tree_flatten(shapes)
    assert g_paths == w_paths
    assert [tuple(x.shape) for x in g_leaves] == [tuple(x.shape) for x in w_leaves]
    # adam_adapt's largest calls: the stacked MLP weights (12 x 768 x 3072)
    # and the embedding (30522 x 768)
    sizes = {"/".join(p): x.numel() for p, x in zip(g_paths, g_leaves)}
    assert max(sizes.values()) == sizes["layers/mlp/up"] == 28_311_552
    assert sizes["embed"] == 23_440_896 and len(sizes) == 16


@pytest.mark.parametrize("classes", [8, 4096])
def test_per_example_ce_route(classes, monkeypatch):
    """At CE_VOCAB_THRESHOLD classes and above the CE takes the
    weighted_ce route: the plain per-row CE on the CPU (equal to the
    log-softmax form), the forward kernel's wrapper on a CUDA tensor
    (stubbed here by the plain version, counting its calls)."""
    from repro_torch.kernels import weighted_ce

    rng = np.random.default_rng(classes)
    logits = torch.from_numpy(rng.standard_normal((5, classes)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, classes, 5).astype(np.int32))
    pe = problems.softmax_per_example(lambda th, x: x)(None, {"x": logits, "y": y})
    want = -torch.log_softmax(logits, -1)[torch.arange(5), y.long()]
    torch.testing.assert_close(pe.loss, want, rtol=1e-5, atol=1e-6)
    if classes >= dispatch.CE_VOCAB_THRESHOLD:
        calls = []

        def fake_fwd(x, t):
            calls.append(tuple(x.shape))
            return weighted_ce.cross_entropy_fwd_plain(x, t)

        monkeypatch.setattr(dispatch, "route", lambda name, x, backend=None: dispatch.CUDA)
        monkeypatch.setattr(weighted_ce, "_fwd_cuda", fake_fwd)
        pe = problems.softmax_per_example(lambda th, x: x)(None, {"x": logits, "y": y})
        assert calls == [(5, classes)]
        torch.testing.assert_close(pe.loss, want, rtol=1e-5, atol=1e-6)


def test_train_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import train

    train.main(["--arch", "bert-base", "--smoke", "--device", "cpu", "--steps", "2",
                "--log-every", "1", "--batch", "4", "--seq", "16"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("base_loss", "meta_loss", "hypergrad_norm", "eps"):
            assert np.isfinite(r[key]), (key, r)


def test_train_cli_default_arch_smoke_on_cpu(capsys):
    """The CLI's default arch is gemma3-1b, as in the JAX CLI: its smoke
    config trains the per-sequence LM loss on the CPU."""
    from repro_torch.launch import train

    train.main(["--smoke", "--device", "cpu", "--steps", "2", "--log-every", "1",
                "--batch", "2", "--seq", "16"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        for key in ("base_loss", "meta_loss", "hypergrad_norm", "eps"):
            assert np.isfinite(r[key]), (key, r)
