"""Each paper-bench twin (``repro_torch.perf.bench_*``) run beside its JAX
bench's own loop on the same inputs, at a cut size on the CPU, holding the
rows the twin emits to what the JAX loop gives.

The twins draw their initial weights from ``torch.Generator`` seeds and
the JAX benches from ``jax.random`` keys. Here the port's ``Model.init(s)``
returns the JAX package's ``Model.init(PRNGKey(s))`` draw for the same
config, converted, and its ``problems.init_data_optimization_lam(s)`` the
JAX draw for ``PRNGKey(s)``. The data are numpy draws in both packages.
So each twin starts where its JAX bench starts, and a row that departs
shows a twin wired differently from its bench: an arm's loss, its
unroll-axis strip, the SAMA weight split, the prune/retrain loop, the
convergence loop.

Each JAX loop below is its bench's ``main`` with the sizes and step counts
made arguments (``benchmarks/bench_<name>.py``; those files cannot take
them). Tolerances, on the rows as printed:

* test losses (4 decimals): ``LOSS_ATOL`` 2e-4, one unit of the last
  printed digit plus what a few f32 Adam steps part by;
* accuracies and kept counts: equal (one flipped prediction moves an
  accuracy over 64 examples by 1/64);
* mean learned weights (3 decimals): ``WEIGHT_ATOL`` 3e-3, one unit of
  the last digit plus ``tests/test_torch_sama.py``'s ``HYPER`` (2e-3
  relative) on weights below 1; Table 3's weights themselves within
  ``HYPER``;
* Figure 5's cosines and distances (4 decimals): ``FIG5_ATOL`` 2e-4;
* parameter counts, paged and dense cache bytes and served tokens: equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import BilevelSpec as JSpec  # noqa: E402
from repro.core import Engine as JEngine  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import SAMAConfig as JSAMAConfig  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.core import sama_hypergrad as jsama_hypergrad  # noqa: E402
from repro.dataopt import DataOptimizer as JDataOptimizer  # noqa: E402
from repro.dataopt import meta_train as jmeta_train  # noqa: E402
from repro.dataopt import model_accuracy as jmodel_accuracy  # noqa: E402
from repro.dataopt import train_plain as jtrain_plain  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from test_torch_paper_benches import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_sama import HYPER, _np_tree  # noqa: E402

LOSS_ATOL = 2e-4
WEIGHT_ATOL = 3e-3
FIG5_ATOL = 2e-4


def _jax_cfg(cfg):
    return jconfigs.ArchConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's model and lam initialisers give the JAX package's draws."""
    cache = {}

    def init(self, seed=0):
        key = (repr(self.cfg), seed)
        if key not in cache:
            cache[key] = _np_tree(JModel(_jax_cfg(self.cfg)).init(jax.random.PRNGKey(seed)))
        return convert.params_from_jax(cache[key], device=self.device)

    def init_lam(seed=0, *, device="cuda", **kw):
        return convert.params_from_jax(_np_tree(jproblems.init_data_optimization_lam(
            jax.random.PRNGKey(seed), **kw)), device=device)

    monkeypatch.setattr(Model, "init", init)
    monkeypatch.setattr(problems, "init_data_optimization_lam", init_lam)


def _rows(bench):
    return {r["name"]: r["derived"] for r in bench.rows}


def _close(got, want, atol, keys=None):
    assert set(got) == set(want)
    for name in want:
        for k in (keys or want[name]):
            assert abs(got[name][k] - want[name][k]) <= atol, (name, k, got[name], want[name])


# ---------------------------------------------------------------------------
# Table 3: continued pretraining
# ---------------------------------------------------------------------------


def _jax_cont_pretrain(steps, n_train, n_meta, n_test):
    """``benchmarks/bench_cont_pretrain.py``'s ``main``, its sizes as
    arguments; returns its rows and the weight split's weights."""
    from benchmarks.bench_cont_pretrain import _streams
    from repro.core.meta_modules import apply_weight_net, weight_features

    cfg = jconfigs.get_smoke_config("gemma3-1b").replace(remat=False)
    model = JModel(cfg)
    seq, batch = 32, 16
    ft_train, _ = _streams(cfg, n_train, seq, seed=0)
    ft_meta, _ = _streams(cfg, n_meta, seq, seed=1)
    ft_test, _ = _streams(cfg, n_test, seq, seed=2)
    aux_in, aux_bad = _streams(cfg, n_train, seq, seed=3)
    aux_all = np.concatenate([aux_in, aux_bad])

    def ft_loss(theta, b):
        return model.lm_loss(theta, b)

    spec = jproblems.make_auxiliary_spec(ft_loss, model.per_example)
    rng = np.random.default_rng(0)

    def batches(k):
        while True:
            fi = rng.integers(0, len(ft_train), (k, batch))
            ai = rng.integers(0, len(aux_all), (k, batch))
            mi = rng.integers(0, len(ft_meta), batch)
            yield ({"ft": {"tokens": jnp.asarray(ft_train[fi])},
                    "pt": {"tokens": jnp.asarray(aux_all[ai])}},
                   {"ft": {"tokens": jnp.asarray(ft_meta[mi])}})

    def test_loss(theta):
        return float(np.mean([float(ft_loss(theta, {"tokens": jnp.asarray(ft_test[i:i + 64])}))
                              for i in range(0, len(ft_test), 64)]))

    rows = {}
    opt = joptim.adam(1e-3)
    theta = model.init(jax.random.PRNGKey(0))
    st = opt.init(theta)
    it = batches(1)
    for _ in range(steps * 2):
        b, _ = next(it)
        g = jax.grad(ft_loss)(theta, jax.tree_util.tree_map(lambda x: x[0], b["ft"]))
        upd, st = opt.update(g, st, theta)
        theta = joptim.apply_updates(theta, upd)
    rows["table3_baseline_ft_only"] = {"test_loss": test_loss(theta)}

    def mt_loss(th, b):
        return ft_loss(th, b["ft"]) + jnp.mean(model.per_example(th, b["pt"]).loss)

    theta = model.init(jax.random.PRNGKey(0))
    st = opt.init(theta)
    it = batches(1)
    for _ in range(steps * 2):
        b, _ = next(it)
        g = jax.grad(mt_loss)(theta, jax.tree_util.tree_map(lambda x: x[0], b))
        upd, st = opt.update(g, st, theta)
        theta = joptim.apply_updates(theta, upd)
    rows["table3_tartan_mt"] = {"test_loss": test_loss(theta)}

    lam = jproblems.init_data_optimization_lam(jax.random.PRNGKey(5), reweight=True)
    eng = JEngine(spec, base_opt=joptim.adam(1e-3), meta_opt=joptim.adam(3e-3),
                  cfg=JEngineConfig(method="sama", unroll_steps=2))
    state = eng.init(model.init(jax.random.PRNGKey(0)), lam)
    state, _ = eng.run(state, batches(2), num_meta_steps=steps, log_every=steps)
    rows["table3_sama"] = {"test_loss": test_loss(state.theta)}

    pe = model.per_example(state.theta, {"tokens": jnp.asarray(aux_all[::4])})
    w = apply_weight_net(state.lam["reweight"], weight_features(pe.loss))
    half = len(aux_all[::4]) // 2
    rows["table3_sama_weight_split"] = {"w_indomain": float(jnp.mean(w[:half])),
                                        "w_harmful": float(jnp.mean(w[half:]))}
    return rows, np.asarray(w)


def test_cont_pretrain_arms_match_the_jax_loop(jax_draws, monkeypatch):
    """ft-only and TARTAN-MT (two Adam steps each on the first of the
    unroll axis' rows) and SAMA (one meta step, unroll 2) from the JAX
    draws: held-out ft losses and the weight split. After one meta step
    the weights are far below the split's printed 3 decimals, so the
    split's own weights (the last MetaWeightNet call of the run) are also
    held, each within ``HYPER``."""
    from repro_torch.core import meta_modules
    from repro_torch.perf import bench_cont_pretrain

    weights = []
    apply = meta_modules.apply_weight_net

    def recording(lam, feats):
        w = apply(lam, feats)
        weights.append(w.detach())
        return w

    monkeypatch.setattr(meta_modules, "apply_weight_net", recording)
    sizes = dict(steps=1, n_train=32, n_meta=16, n_test=64)
    got = _rows(bench_cont_pretrain.run(device="cpu", **sizes))
    want, want_w = _jax_cont_pretrain(**sizes)
    split = "table3_sama_weight_split"
    _close({k: v for k, v in got.items() if k != split},
           {k: v for k, v in want.items() if k != split}, LOSS_ATOL)
    _close({split: got[split]}, {split: want[split]}, WEIGHT_ATOL)
    assert weights[-1].shape == want_w.shape == (sizes["n_train"] // 2,)
    np.testing.assert_allclose(weights[-1].numpy(), want_w, **HYPER)


# ---------------------------------------------------------------------------
# Tables 1 and 8-9: finetuning and the meta methods on mini-BERT
# ---------------------------------------------------------------------------


WRENCH_ROWS = [("table1_sama_na_R", dict(method="sama_na", correct=False)),
               ("table1_sama_R", dict(method="sama", correct=False)),
               ("table1_sama_RC", dict(method="sama", correct=True))]


def _jax_wrench(steps, n_train, n_meta, n_test):
    """``benchmarks/bench_wrench.py``'s ``main`` at the given sizes."""
    ccfg, train, meta, test = jcommon.wrench_task(seed=0, n_train=n_train, n_meta=n_meta,
                                                  n_test=n_test)
    model = jcommon.mini_bert(num_labels=ccfg.num_classes)
    theta = jtrain_plain(model, train, steps=steps * 2)
    rows = {"table1_finetune_weak": {"acc": jmodel_accuracy(model, theta, test)}}
    for name, kw in WRENCH_ROWS:
        learner = jmeta_train(model, train, meta, steps=steps, log_every=max(steps // 4, 1),
                              **kw)
        rows[name] = {"acc": jmodel_accuracy(model, learner.state.theta, test)}
    return rows


def test_wrench_rows_match_the_jax_loop(jax_draws):
    from repro_torch.perf import bench_wrench

    sizes = dict(steps=2, n_train=64, n_meta=32, n_test=64)
    got = _rows(bench_wrench.run(device="cpu", **sizes))
    _close(got, _jax_wrench(**sizes), 1e-4)  # a printed accuracy over 64: equal


def _jax_ablation(steps, n_train, n_meta, n_test, methods):
    """``benchmarks/bench_ablation.py``'s ``main`` at the given sizes, its
    accuracies (its compiled-memory probe measures another quantity)."""
    ccfg, train, meta, test = jcommon.wrench_task(seed=3, n_train=n_train, n_meta=n_meta,
                                                  n_test=n_test)
    model = jcommon.mini_bert(num_labels=ccfg.num_classes)
    theta = jtrain_plain(model, train, steps=steps * 2)
    rows = {"table8_finetune": {"acc": jmodel_accuracy(model, theta, test)}}
    for method in methods:
        learner = jmeta_train(model, train, meta, method=method, steps=steps,
                              log_every=max(steps // 4, 1))
        rows[f"table8_{method}"] = {"acc": jmodel_accuracy(model, learner.state.theta, test)}
    return rows


def test_ablation_accuracies_match_the_jax_loop(jax_draws):
    """Finetuning and the first-order meta methods (T1-T2, SAMA-NA, SAMA);
    the second-order ones' estimators are held step by step in
    tests/test_torch_baselines.py."""
    from repro_torch.perf import bench_ablation

    sizes = dict(steps=2, n_train=64, n_meta=32, n_test=64)
    got = _rows(bench_ablation.run(device="cpu", **sizes))
    methods = ["t1t2", "sama_na", "sama"]
    want = _jax_ablation(**sizes, methods=methods)
    _close({k: got[k] for k in want}, want, 1e-4, keys=["acc"])
    assert {r["peak_mb"] for r in got.values() if "peak_mb" in r} == {"not_measured"}


def test_memory_vs_modelsize_params_match_jax(jax_draws):
    """The parameter count at each width (the peaks are the card's, not
    measured on the CPU, and the JAX rows hold compiled bytes)."""
    from repro_torch.perf import bench_memory_vs_modelsize

    widths = [128, 256, 384]
    got = _rows(bench_memory_vs_modelsize.run(device="cpu", widths=widths, n_train=16,
                                              n_meta=16, layers=1))
    for width in widths:
        jm = jcommon.mini_bert(num_labels=4, d_model=width, layers=1)
        want = jm.num_params(jm.init(jax.random.PRNGKey(0)))
        for method in bench_memory_vs_modelsize.METHODS:
            assert got[f"fig1_mem_{method}_d{width}"]["params"] == want


# ---------------------------------------------------------------------------
# Figure 3: data pruning
# ---------------------------------------------------------------------------


def _jax_data_pruning(steps, retrain_steps, n, n_test):
    """``benchmarks/bench_data_pruning.py``'s ``main`` at the given sizes
    (its fast ratios), over its own ``SCORERS``."""
    from benchmarks.bench_data_pruning import SCORERS

    ccfg = jdata.ClassificationConfig(num_classes=4, vocab_size=512, seq_len=32, seed=7)
    train = jdata.make_classification_dataset(ccfg, n, noise=0.25, seed=7)
    test = jdata.make_classification_dataset(ccfg, n_test, noise=0.0, seed=8)
    model = jcommon.mini_bert(num_labels=ccfg.num_classes)
    rows = {}
    for tag, knobs in SCORERS.items():
        opt = JDataOptimizer(model, train, meta=train, seed=7, **knobs(steps))
        opt.fit_scores()
        for r in [0.1, 0.3]:
            _, mask = opt.prune(r)
            theta = opt.retrain(steps=retrain_steps, mask=mask)
            rows[f"fig3_{tag}_r{int(r * 100)}"] = {"acc": opt.evaluate(theta, test),
                                                   "kept": int(mask.sum())}
        if tag == "sama":
            bad = train["corrupted"]
            w = opt.scores
            rows["fig3_sama_weight_auc"] = {"w_clean": float(w[~bad].mean()),
                                            "w_noisy": float(w[bad].mean())}
    return rows


def test_data_pruning_rows_match_the_jax_loop(jax_draws):
    """The three scorers' prune/retrain loop at ratios 0.1 and 0.3 (the
    retrained accuracy and the kept count) and SAMA's weights on clean and
    corrupted examples."""
    from repro_torch.perf import bench_data_pruning

    sizes = dict(steps=2, retrain_steps=2, n=64, n_test=64)
    got = _rows(bench_data_pruning.run(device="cpu", **sizes))
    want = _jax_data_pruning(**sizes)
    auc = "fig3_sama_weight_auc"
    _close({k: v for k, v in got.items() if k != auc},
           {k: v for k, v in want.items() if k != auc}, 1e-4)
    _close({auc: got[auc]}, {auc: want[auc]}, WEIGHT_ATOL)


# ---------------------------------------------------------------------------
# Figure 5: biased regression
# ---------------------------------------------------------------------------


def _jax_fig5(arrays, steps, beta=0.1):
    """``benchmarks/bench_biased_regression.py``'s ``_problem`` and ``main``
    on given (X, Xp, y, yp): both panels' values."""
    X, Xp, y, yp = (jnp.asarray(a) for a in arrays)
    d = X.shape[1]
    A = X.T @ X + beta * jnp.eye(d)
    spec = JSpec(
        base_loss=lambda th, lam, b: jnp.sum((X @ th["w"] - y) ** 2)
        + beta * jnp.sum((th["w"] - lam["w"]) ** 2),
        meta_loss=lambda th, lam, b: jnp.sum((Xp @ th["w"] - yp) ** 2),
    )

    def w_star(lam):
        return jnp.linalg.solve(A, X.T @ y + beta * lam)

    Ainv = jnp.linalg.inv(A)
    lam_star = jnp.linalg.lstsq(beta * Xp @ Ainv, yp - Xp @ Ainv @ (X.T @ y))[0]
    lam = {"w": jnp.ones((d,)) * 0.5}
    theta = {"w": w_star(lam["w"])}
    gt = 2.0 * beta * jnp.linalg.solve(A, Xp.T @ (Xp @ theta["w"] - yp))
    opt = joptim.sgd(0.01)
    st = opt.init(theta)
    g_base = jax.grad(spec.base_scalar)(theta, lam, None)
    gs = {
        "sama": jsama_hypergrad(spec, theta, lam, None, None, base_opt=opt, base_opt_state=st,
                                g_base=g_base, cfg=JSAMAConfig()).hypergrad["w"],
        "cg": jbaselines.cg_hypergrad(spec, theta, lam, None, None, num_iters=20)["w"],
        "neumann": jbaselines.neumann_hypergrad(spec, theta, lam, None, None, num_terms=200,
                                                scale=0.05)["w"],
        "t1t2": jbaselines.t1t2_hypergrad(spec, theta, lam, None, None)["w"],
    }
    rows = {f"fig5_cosine_{k}": {"cos": float(jnp.vdot(g, gt) / (
        jnp.linalg.norm(g) * jnp.linalg.norm(gt) + 1e-30))} for k, g in gs.items()}
    for name in ("sama", "cg"):
        lam_t = {"w": jnp.zeros((d,))}
        meta_opt = joptim.adam(0.05)
        mst = meta_opt.init(lam_t)
        for _ in range(steps):
            th = {"w": w_star(lam_t["w"])}
            stt = opt.init(th)
            gb = jax.grad(spec.base_scalar)(th, lam_t, None)
            if name == "sama":
                g = jsama_hypergrad(spec, th, lam_t, None, None, base_opt=opt,
                                    base_opt_state=stt, g_base=gb,
                                    cfg=JSAMAConfig()).hypergrad
            else:
                g = jbaselines.cg_hypergrad(spec, th, lam_t, None, None, num_iters=20)
            upd, mst = meta_opt.update(g, mst, lam_t)
            lam_t = joptim.apply_updates(lam_t, upd)
        rows[f"fig5_lamdist_{name}"] = {
            f"dist_after_{steps}": float(jnp.linalg.norm(lam_t["w"] - lam_star))}
    return rows


def test_biased_regression_rows_match_the_jax_loop():
    """Both panels on the twin's numpy arrays: the four cosines and the
    distance to lam* after 5 meta updates of SAMA and CG."""
    from repro_torch.perf import bench_biased_regression

    got = _rows(bench_biased_regression.run(device="cpu", steps=5, repeats=1))
    _close(got, _jax_fig5(bench_biased_regression.problem_arrays(0), steps=5), FIG5_ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_twin_serves_the_jax_tokens_and_bytes(jax_draws, monkeypatch):
    """The serial arm's tokens request by request (which the continuous
    arm must equal) are JAX's ``greedy_generate``'s from the same weights
    on the JAX bench's workload, and the paged and dense cache bytes are
    the JAX executor's."""
    from benchmarks.bench_serve import ARCH, SLOTS, _workload
    from repro_torch.perf import bench_serve

    served = []
    greedy = serve.greedy_generate

    def recording(model, params, prompt, gen, max_len):
        toks = greedy(model, params, prompt, gen, max_len)
        served.append([int(t) for t in toks[0]])
        return toks

    monkeypatch.setattr(serve, "greedy_generate", recording)
    got = _rows(bench_serve.run(device="cpu"))
    n_req, gen, max_len = 8, 8, 32  # the JAX bench's fast sizes

    cfg = jconfigs.get_smoke_config(ARCH)
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    prompts, gens = _workload(cfg, n_req, gen)
    want = [[int(t) for t in jserve.greedy_generate(jm, jparams, jnp.asarray(p[None]), g,
                                                    max_len)[0]]
            for p, g in zip(prompts, gens)]
    assert served[:n_req] == want
    ex = jserve.ServeExecutor(jm, jparams, jserve.ServeConfig(
        slots=SLOTS, page_size=4, max_len=max_len, max_new_tokens=gen))
    for p, g in zip(prompts, gens):
        ex.submit(p, max_new_tokens=g)
    peak = ex.run().memory["peak_bytes"]
    dense = jserve.dense_cache_bytes(jm, SLOTS, max_len, ex.batcher.dtype)
    row = got["serve_paged_memory"]
    assert (row["paged_peak_bytes"], row["dense_bytes"]) == (peak, dense)
