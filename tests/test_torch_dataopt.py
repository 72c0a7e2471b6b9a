"""The port's data optimization (``repro_torch.dataopt``: the scorer
registry and the six scorers, EMA tracking, prune masks, the retrain
harness, reweighted sampling, score export, ``map_batches`` and the
``DataOptimizer`` facade) against the JAX package's ``repro.dataopt``, on
a tiny MLP through ``problems.softmax_per_example`` (tests/test_dataopt.py's
problem) and on ``mini_bert``.

The JAX package draws fresh parameters and lam from ``jax.random``, the
port from ``torch.Generator``s: here the port's ``init_fn`` returns the
JAX draw, converted, and the meta scorer's lam draw is substituted through
``monkeypatch``. Index draws are numpy's in both.

Tolerances: el2n, margin and loss 1e-5 relative (f32, the same ops in
another order); grand 1e-4 (a norm of summed gradients); random, masks,
sampled indices and exports bitwise; the meta scorer's weights
tests/test_torch_sama.py's ``HYPER`` (2e-3 relative: they follow the meta
steps' hypergradients); retrained models' losses ``LOSS`` (1e-5).
The reference's sharded-scoring bitwise test is not copied: it fails on
the reference (ROADMAP queue 3), and the port scores on one device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import dataopt as jdo  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro_torch import convert, dataopt, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402

from test_torch_sama import HYPER, LOSS, _np_tree  # noqa: E402

D, H, C, N = 6, 16, 3, 90


def _japply(theta, x):
    return jnp.tanh(x @ theta["w1"]) @ theta["w2"]


def _tapply(theta, x):
    return torch.tanh(x @ theta["w1"]) @ theta["w2"]


JPER_EX = jproblems.softmax_per_example(_japply)
TPER_EX = problems.softmax_per_example(_tapply)


def _jinit(key):
    k1, k2 = jax.random.split(key)
    return {"w1": jax.random.normal(k1, (D, H)) * 0.3, "w2": jax.random.normal(k2, (H, C)) * 0.3}


def _tinit(seed):
    """The JAX package's draw for ``seed``, converted."""
    return convert.params_from_jax(_np_tree(_jinit(jax.random.PRNGKey(seed))), device="cpu")


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(N, D)).astype(np.float32),
            "y": rng.integers(0, C, N).astype(np.int32),
            "y_true": rng.integers(0, C, N).astype(np.int32)}


@pytest.fixture(scope="module")
def jtheta():
    return _jinit(jax.random.PRNGKey(42))


def _pair(dataset, scorer, jtheta=None, **knobs):
    """A JAX and a port DataOptimizer over one dataset and scorer."""
    common = dict(fields=("x", "y"), num_classes=C, scorer=scorer, batch_size=32)
    jopt = jdo.DataOptimizer(train=dataset, per_example_fn=JPER_EX, init_fn=_jinit,
                             theta=jtheta, **common, **knobs)
    topt = dataopt.DataOptimizer(
        train=dataset, per_example_fn=TPER_EX, init_fn=_tinit, device="cpu",
        theta=None if jtheta is None else convert.params_from_jax(_np_tree(jtheta),
                                                                  device="cpu"),
        **common, **knobs)
    return jopt, topt


# ---------------------------------------------------------------------------
# the registry and the scorers
# ---------------------------------------------------------------------------


def test_scorer_registry_matches_jax():
    assert dataopt.available_scorers() == jdo.available_scorers()

    @dataopt.register_scorer("test_constant")
    def _make(value=1.0):
        return lambda ctx: np.full(ctx.n, value, np.float32)

    try:
        with pytest.raises(ValueError):
            dataopt.register_scorer("test_constant", _make)
        assert dataopt.resolve_scorer("test_constant", value=3.0)(
            dataopt.ScoreContext(TPER_EX, _tinit, {"x": np.zeros((4, D))}, device="cpu")
        ).tolist() == [3.0] * 4
    finally:
        dataopt.unregister_scorer("test_constant")
    with pytest.raises(ValueError):
        dataopt.resolve_scorer("test_constant")
    with pytest.raises(TypeError):
        dataopt.resolve_scorer(lambda ctx: None, train_steps=3)


@pytest.mark.parametrize("scorer,rtol", [("el2n", 1e-5), ("margin", 1e-5), ("loss", 1e-5),
                                         ("grand", 1e-4)])
def test_heuristic_scorers_match_jax(dataset, jtheta, scorer, rtol):
    jopt, topt = _pair(dataset, scorer, jtheta)
    want, got = jopt.fit_scores(), topt.fit_scores()
    assert got.dtype == np.float32 and got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-2)


def test_heuristic_scorer_trains_its_early_model_as_jax(dataset):
    """Without a theta the scorer trains from init_fn(seed) (the JAX draw
    here) for train_steps Adam steps on numpy's batches, in both."""
    jopt, topt = _pair(dataset, "loss", train_steps=5)
    np.testing.assert_allclose(topt.fit_scores(), jopt.fit_scores(), **LOSS)


def test_random_scorer_is_bitwise_jax(dataset):
    jopt, topt = _pair(dataset, "random")
    np.testing.assert_array_equal(topt.fit_scores(), jopt.fit_scores())
    jopt, topt = _pair(dataset, "random", seed=7)
    np.testing.assert_array_equal(topt.fit_scores(), jopt.fit_scores())


@pytest.mark.parametrize("uncertainty", ["entropy", "ema", "none"])
def test_meta_scorer_with_the_jax_draws_matches_jax(dataset, jtheta, uncertainty, monkeypatch):
    """Four SAMA meta steps (unroll 2) from the same theta and, substituted,
    JAX's lam draw; ``ema`` rescores the train set every 2 steps."""
    knobs = dict(steps=4, unroll=2, uncertainty=uncertainty, batch=16, meta_batch=16)
    if uncertainty == "ema":
        knobs["score_every"] = 2
    jopt, topt = _pair(dataset, "meta", jtheta, **knobs)

    def jax_lam(seed, **kw):
        kw.pop("device")
        return convert.params_from_jax(_np_tree(jproblems.init_data_optimization_lam(
            jax.random.PRNGKey(seed), **kw)), device="cpu")

    monkeypatch.setattr(dataopt.scores.problems, "init_data_optimization_lam", jax_lam)
    want, got = jopt.fit_scores(), topt.fit_scores()
    assert np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, want, **HYPER)


def test_meta_scorer_takes_the_scale_knob(dataset, jtheta):
    """scale= reaches MetaLearner: microbatch 2 and the f16 policy score
    finitely."""
    from repro_torch import scale

    _, topt = _pair(dataset, "meta", jtheta, steps=2, unroll=2, batch=16, meta_batch=16,
                    scale=scale.ScaleConfig(policy="f16", microbatch=2))
    s = topt.fit_scores()
    assert s.shape == (N,) and np.all(np.isfinite(s))


# ---------------------------------------------------------------------------
# masks, pruning, retraining
# ---------------------------------------------------------------------------


def test_masks_are_bitwise_jax():
    rng = np.random.default_rng(1)
    scores = rng.random(N).astype(np.float32)
    scores[:10] = 0.5  # ties, broken by index
    labels = rng.integers(0, C, N)
    for ratio in (0.0, 0.3, 0.5, 0.9):
        assert dataopt.keep_count(N, ratio) == jdo.prune.keep_count(N, ratio)
        np.testing.assert_array_equal(dataopt.keep_mask(scores, ratio),
                                      jdo.keep_mask(scores, ratio))
        np.testing.assert_array_equal(dataopt.class_balanced_mask(scores, labels, ratio),
                                      jdo.class_balanced_mask(scores, labels, ratio))
    with pytest.raises(ValueError):
        dataopt.keep_mask(scores, 1.0)


@pytest.mark.parametrize("class_balanced,rounds", [(False, 1), (True, 1), (False, 2)])
def test_prune_masks_match_jax(dataset, class_balanced, rounds):
    jopt, topt = _pair(dataset, "random")
    jpruned, jmask = jopt.prune(0.4, class_balanced=class_balanced, rounds=rounds)
    tpruned, tmask = topt.prune(0.4, class_balanced=class_balanced, rounds=rounds)
    np.testing.assert_array_equal(tmask, jmask)
    for key in dataset:
        np.testing.assert_array_equal(tpruned[key], jpruned[key])


def test_retrain_matches_jax(dataset):
    """A fresh model (init_fn(seed): the JAX draw) trained 20 Adam steps on
    the kept subset: the same mean loss within LOSS, and the accuracy."""
    jopt, topt = _pair(dataset, "random")
    _, mask = jopt.prune(0.3)
    jth = jopt.retrain(steps=20, mask=mask, seed=3)
    tth = topt.retrain(steps=20, mask=mask, seed=3)
    jloss = float(jnp.mean(JPER_EX(jth, {"x": jnp.asarray(dataset["x"]),
                                         "y": jnp.asarray(dataset["y"])}).loss))
    tloss = float(torch.mean(TPER_EX(tth, {"x": torch.from_numpy(dataset["x"]),
                                           "y": torch.from_numpy(dataset["y"])}).loss))
    np.testing.assert_allclose(tloss, jloss, **LOSS)
    jacc = jdo.accuracy(_japply_batch, jth, dataset, fields=("x",), batch_size=32)
    tacc = dataopt.accuracy(_tapply_batch, tth, dataset, fields=("x",), batch_size=32)
    assert tacc == jacc


def _japply_batch(theta, b):
    return _japply(theta, b["x"])


def _tapply_batch(theta, b):
    return _tapply(theta, b["x"])


@pytest.fixture(scope="module")
def bert_models():
    from repro import configs as jconfigs
    from repro.models import Model as JaxModel
    from repro_torch import configs
    from repro_torch.models import Model

    from test_torch_sama import _mini_bert

    return JaxModel(_mini_bert(jconfigs, False)), Model(_mini_bert(configs, False), device="cpu")


def test_train_plain_and_model_accuracy_on_mini_bert_match_jax(bert_models, monkeypatch):
    jm, tm = bert_models
    rng = np.random.default_rng(5)
    data = {"tokens": rng.integers(0, 512, (24, 16)).astype(np.int32),
            "y": rng.integers(0, 4, 24).astype(np.int32)}
    data["y_true"] = data["y"]
    jparams = _np_tree(jm.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tm, "init", lambda seed: convert.params_from_jax(jparams,
                                                                         device="cpu"))
    jth = jdo.train_plain(jm, data, steps=3, batch=8)
    tth = dataopt.train_plain(tm, data, steps=3, batch=8)
    batch = {k: data[k] for k in ("tokens", "y")}
    jloss = float(jnp.mean(jm.classifier_per_example(
        jth, jax.tree_util.tree_map(jnp.asarray, batch)).loss))
    tloss = float(torch.mean(tm.classifier_per_example(
        tth, tree.tree_map(torch.from_numpy, batch)).loss))
    np.testing.assert_allclose(tloss, jloss, **LOSS)
    assert dataopt.model_accuracy(tm, tth, data, batch_size=16) == jdo.model_accuracy(
        jm, jth, data, batch_size=16)


# ---------------------------------------------------------------------------
# EMA, sampling, the reweighted iterator
# ---------------------------------------------------------------------------


def test_ema_tracker_and_disagreement_match_jax():
    rng = np.random.default_rng(2)
    t, j = dataopt.EMATracker(0.8), jdo.EMATracker(0.8)
    for _ in range(4):
        x = rng.random(10).astype(np.float32)
        np.testing.assert_array_equal(t.update(x), j.update(x))
    assert t.updates == j.updates == 4
    with pytest.raises(ValueError):
        t.update(np.zeros(3))
    with pytest.raises(ValueError):
        dataopt.EMATracker(1.0)
    p = rng.dirichlet(np.ones(C), 10).astype(np.float32)
    q = rng.dirichlet(np.ones(C), 10).astype(np.float32)
    np.testing.assert_array_equal(dataopt.ema_disagreement(p, q), jdo.ema_disagreement(p, q))


def test_sampling_probs_match_jax():
    rng = np.random.default_rng(3)
    s = rng.standard_normal(50)
    for temp in (1e-3, 0.5, 1.0, 100.0):
        np.testing.assert_array_equal(dataopt.sampling_probs(s, temp),
                                      jdo.sampling_probs(s, temp))
    np.testing.assert_array_equal(dataopt.sampling_probs(np.ones(5), 1.0),
                                  jdo.sampling_probs(np.ones(5), 1.0))
    with pytest.raises(ValueError):
        dataopt.sampling_probs(np.array([1.0, np.nan]), 1.0)


@pytest.mark.parametrize("temperature", [1.0, (2.0, 0.1, 2)])
def test_reweighted_iterator_indices_are_bitwise_jax(temperature):
    n = 40
    data = {"tokens": np.arange(n, dtype=np.int32)[:, None].repeat(3, 1),
            "y": (np.arange(n) % C).astype(np.int32)}
    scores = np.random.default_rng(4).random(n).astype(np.float32)
    kw = dict(batch_size=6, meta_batch_size=4, unroll=2, seed=11, temperature=temperature)
    jit = jdo.ReweightedIterator(data, data, scores, **kw)
    tit = dataopt.ReweightedIterator(data, data, scores, device="cpu", **kw)
    for _ in range(3):
        (jb, jm), (tb, tm) = next(jit), next(tit)
        for key in data:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
            np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    with pytest.raises(ValueError):
        tit.update_scores(np.zeros(3))


# ---------------------------------------------------------------------------
# export, map_batches, what waits for later items
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exports_cross_between_the_packages_bitwise(tmp_path, direction):
    rng = np.random.default_rng(6)
    scores = rng.standard_normal(N).astype(np.float32)
    mask = rng.random(N) < 0.5
    path = str(tmp_path / "scores")
    write, read = ((jdo.export_scores, dataopt.import_scores) if direction == "jax_to_port"
                   else (dataopt.export_scores, jdo.import_scores))
    write(path, scores, scorer="el2n", mask=mask, meta={"note": "x"})
    got, got_mask, meta = read(path, expect_n=N, expect_scorer="el2n")
    assert got.dtype == np.float32 and got_mask.dtype == bool
    np.testing.assert_array_equal(got, scores)
    np.testing.assert_array_equal(got_mask, mask)
    assert meta["kind"] == "dataopt.scores" and meta["note"] == "x"
    with pytest.raises(ValueError, match="dataset of"):
        read(path, expect_n=N + 1)
    with pytest.raises(ValueError, match="scored by"):
        read(path, expect_scorer="meta")


def test_optimizer_export_and_load_round_trip(tmp_path, dataset):
    _, topt = _pair(dataset, "random")
    scores = topt.fit_scores()
    path = topt.export(str(tmp_path / "s"))
    _, fresh = _pair(dataset, "random")
    np.testing.assert_array_equal(fresh.load(path, expect_scorer="random"), scores)
    with pytest.raises(ValueError, match="non-finite"):
        dataopt.export_scores(str(tmp_path / "bad"), np.array([np.nan]), scorer="x")


def test_map_batches_pads_by_wrapping_and_trims_as_jax():
    n, bs = 10, 4
    data = {"x": np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32),
            "skip": np.zeros(n)}
    seen = []

    def tfn(b):
        seen.append(b["x"][:, 0].tolist())
        assert "skip" not in b and not torch.is_grad_enabled()
        return {"twice": b["x"] * 2, "row": b["x"][:, 0]}

    got = dataopt.map_batches(tfn, data, fields=("x",), batch_size=bs, device="cpu")
    want = jdo.map_batches(lambda b: {"twice": b["x"] * 2, "row": b["x"][:, 0]}, data,
                           fields=("x",), batch_size=bs)
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]]
    for key in ("twice", "row"):
        assert got[key].shape[0] == n
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_mesh_and_obs_raise_naming_their_queue_items(dataset):
    """A mesh is taken now (tests/test_torch_dataopt_distributed.py); what
    is not a ``launch.mesh.Mesh`` is refused. ``obs`` still waits for
    ROADMAP queue 1 item 6."""
    kw = dict(train=dataset, per_example_fn=TPER_EX, init_fn=_tinit, fields=("x", "y"),
              scorer="random", device="cpu")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        dataopt.DataOptimizer(mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        dataopt.DataOptimizer(obs=object(), **kw)
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        dataopt.map_batches(lambda b: b, dataset, fields=("x",), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        dataopt.batch_sharding(object())
    assert dataopt.batch_sharding(None) is None
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        dataopt.ReweightedIterator(dataset, dataset, np.ones(N), batch_size=2,
                                   meta_batch_size=2, unroll=1, mesh=object(), device="cpu")
