"""The port's sharded data optimization (``dataopt.map_batches(mesh=)``,
``score_dataset``, ``ReweightedIterator(mesh=)``, ``DataOptimizer(mesh=)``)
and the planner under a mesh (``scale.plan_microbatch(mesh=, schedule=)``,
``candidate_microbatches(shard_divisor=)``) on two ``gloo`` ranks, against
the JAX package's ``repro.dataopt`` and ``repro.scale`` on a forced
2-device host mesh in a subprocess, on the MLP of tests/test_dataopt.py
(one module fixture runs both sides at once, as
tests/test_torch_distributed.py does).

Tolerances, tests/test_torch_dataopt.py's: the per-example losses,
logits, entropies and the el2n, margin and loss scores 1e-5 relative (f32,
the same ops on batches of another size); grand 1e-4; sampled batches,
accuracies and planner candidates exactly. The reference's own
sharded-scoring bitwise test is not copied (it fails on the reference,
ROADMAP queue 3): the port is held to the JAX package's sharded results.
The meta scorer has no JAX counterpart here (the packages draw lam
differently): on the ranks it must give finite scores, the same on both.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import dataopt, optim, scale, tree  # noqa: E402
from repro_torch.core import EngineConfig, init_state, problems  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
D_IN, H, C, N = 6, 16, 3, 90
BATCH = 16  # scoring batch: 8 rows per rank; 90 rows pad to 96
HEURISTICS = {"el2n": 1e-5, "margin": 1e-5, "loss": 1e-5, "grand": 1e-4}
PE_FIELDS = ("loss", "logits", "uncertainty")


def _tapply(theta, x):
    return torch.tanh(x @ theta["w1"]) @ theta["w2"]


def _japply(theta, x):
    return jnp.tanh(x @ theta["w1"]) @ theta["w2"]


def data():
    rng = np.random.default_rng(0)
    train = {"x": rng.normal(size=(N, D_IN)).astype(np.float32),
             "y": rng.integers(0, C, N).astype(np.int32),
             "y_true": rng.integers(0, C, N).astype(np.int32)}
    theta = {"w1": (0.3 * rng.standard_normal((D_IN, H))).astype(np.float32),
             "w2": (0.3 * rng.standard_normal((H, C))).astype(np.float32)}
    scores = rng.random(N).astype(np.float32)
    base = {"x": rng.normal(size=(2, 16, D_IN)).astype(np.float32),
            "y": rng.integers(0, C, (2, 16)).astype(np.int32)}
    meta = {"x": rng.normal(size=(8, D_IN)).astype(np.float32),
            "y": rng.integers(0, C, 8).astype(np.int32)}
    return train, theta, scores, base, meta


JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import numpy as np
import jax, jax.numpy as jnp
from repro import dataopt as jdo, optim, scale as jscale
from repro.core import EngineConfig, init_state, problems as jp
from repro.launch.mesh import AxisType, make_mesh
import test_torch_dataopt_distributed as T

mesh = make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
train, theta, scores, base, meta = T.data()
jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
per_ex = jp.softmax_per_example(T._japply)
out = {}
pe = jdo.score_dataset(per_ex, jtheta, train, fields=("x", "y"), batch_size=T.BATCH, mesh=mesh)
for f in T.PE_FIELDS:
    out[f"pe/{f}"] = np.asarray(getattr(pe, f))
for s in T.HEURISTICS:
    opt = jdo.DataOptimizer(train=train, per_example_fn=per_ex, init_fn=lambda k: jtheta,
                            theta=jtheta,
                            fields=("x", "y"), num_classes=T.C, scorer=s,
                            batch_size=T.BATCH, mesh=mesh)
    out[f"scores/{s}"] = opt.fit_scores()
out["accuracy"] = np.asarray(jdo.accuracy(lambda p, b: T._japply(p, b["x"]), jtheta, train,
                                          fields=("x",), batch_size=T.BATCH, mesh=mesh))
it = jdo.ReweightedIterator(train, train, scores, batch_size=8, meta_batch_size=4, unroll=2,
                            seed=3, fields=("x", "y"), temperature=0.5, mesh=mesh)
for i in range(2):
    b, m = next(it)
    for k in ("x", "y"):
        out[f"it{i}/base/{k}"] = np.asarray(b[k])
        out[f"it{i}/meta/{k}"] = np.asarray(m[k])
jb = jax.tree_util.tree_map(jnp.asarray, base)
jm = jax.tree_util.tree_map(jnp.asarray, meta)
out["candidates"] = np.asarray(jscale.candidate_microbatches(jb, jm, shard_divisor=2))
spec = jp.make_data_optimization_spec(per_ex, reweight=True)
lam = jp.init_data_optimization_lam(jax.random.PRNGKey(0))
bo, mo = optim.adam(1e-2), optim.adam(1e-2)
cfg = EngineConfig(method="sama", unroll_steps=2)
plan = jscale.plan_microbatch(spec, bo, mo, cfg, init_state(jtheta, lam, bo, mo), jb, jm,
                              hbm_budget=10 ** 12, mesh=mesh, schedule="single_sync")
out["plan"] = np.asarray([plan.microbatch, plan.fits, max(m for m, _ in plan.candidates)])
np.savez(sys.argv[1], **out)
"""


def _ranks(rank, out_dir):
    torch.set_num_threads(2)
    mesh = M.make_data_mesh(device="cpu")
    train, theta, scores, base, meta = data()
    ttheta = tree.tree_map(torch.from_numpy, theta)
    per_ex = problems.softmax_per_example(_tapply)
    res = {}
    pe = dataopt.score_dataset(per_ex, ttheta, train, fields=("x", "y"), batch_size=BATCH,
                               mesh=mesh)
    one = dataopt.score_dataset(per_ex, ttheta, train, fields=("x", "y"), batch_size=BATCH,
                                device="cpu")
    for f in PE_FIELDS:
        res[f"pe/{f}"] = getattr(pe, f)
        res[f"one_device/{f}"] = getattr(one, f)
    for s in HEURISTICS:
        opt = dataopt.DataOptimizer(train=train, per_example_fn=per_ex,
                                    init_fn=lambda seed: ttheta, theta=ttheta,
                                    fields=("x", "y"), num_classes=C, scorer=s,
                                    batch_size=BATCH, mesh=mesh)
        res[f"scores/{s}"] = opt.fit_scores()
    res["accuracy"] = dataopt.accuracy(lambda p, b: _tapply(p, b["x"]), ttheta, train,
                                       fields=("x",), batch_size=BATCH, mesh=mesh)
    it = dataopt.ReweightedIterator(train, train, scores, batch_size=8, meta_batch_size=4,
                                    unroll=2, seed=3, fields=("x", "y"), temperature=0.5,
                                    mesh=mesh)
    for i in range(2):
        b, m = next(it)
        res[f"it{i}/local"] = isinstance(b, M.LocalBatch) and isinstance(m, M.LocalBatch)
        for k in ("x", "y"):
            res[f"it{i}/base/{k}"] = b[k].numpy()
            res[f"it{i}/meta/{k}"] = m[k].numpy()

    # the iterator's rows feed the single-sync step as the global batch does
    spec = problems.make_data_optimization_spec(per_ex, reweight=True)
    lam = problems.init_data_optimization_lam(0, device="cpu")
    bo, mo = optim.adam(1e-2), optim.adam(1e-2)
    cfg = EngineConfig(method="sama", unroll_steps=2)
    st = init_state(ttheta, lam, bo, mo)
    step = D.make_manual_step(spec, bo, mo, cfg, mesh)
    glob = dataopt.ReweightedIterator(train, train, scores, batch_size=8, meta_batch_size=4,
                                      unroll=2, seed=3, fields=("x", "y"), temperature=0.5,
                                      device="cpu")
    local = dataopt.ReweightedIterator(train, train, scores, batch_size=8, meta_batch_size=4,
                                       unroll=2, seed=3, fields=("x", "y"), temperature=0.5,
                                       mesh=mesh)
    s_g, _ = step(st, *next(glob))
    s_l, _ = step(st, *next(local))
    res["local_step_bitwise"] = all(torch.equal(x, y) for x, y in zip(
        tree.flatten_with_keys(s_g)[1], tree.flatten_with_keys(s_l)[1]))

    tb, tm = tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta)
    res["candidates"] = scale.candidate_microbatches(tb, tm, shard_divisor=mesh.size)
    plan = scale.plan_microbatch(spec, bo, mo, cfg, st, tb, tm, hbm_budget=10 ** 12, mesh=mesh,
                                 schedule="single_sync")
    res["plan"] = [plan.microbatch, plan.fits, max(m for m, _ in plan.candidates)]
    tight = scale.plan_microbatch(spec, bo, mo, cfg, st, tb, tm, hbm_budget=1, mesh=mesh,
                                  schedule="single_sync")
    res["plan_tight"] = [tight.microbatch, tight.fits, [m for m, _ in tight.candidates]]

    # the meta scorer: MetaLearner under the mesh ("auto": single_sync)
    opt = dataopt.DataOptimizer(train=train, per_example_fn=per_ex, init_fn=lambda s: ttheta,
                                fields=("x", "y"), num_classes=C, scorer="meta", steps=2,
                                batch=8, meta_batch=8, unroll=2, batch_size=BATCH, mesh=mesh)
    res["scores/meta"] = opt.fit_scores()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dataopt_ranks"))
    jax_out = os.path.join(out_dir, "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, jax_out, HERE], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        D.spawn(_ranks, 2, (out_dir,), store_dir=out_dir, timeout_s=300)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return ranks, dict(np.load(jax_out))


@pytest.mark.parametrize("field", PE_FIELDS)
def test_sharded_score_dataset_matches_jax(runs, field):
    ranks, jx = runs
    for res in ranks:
        assert res[f"pe/{field}"].shape[0] == N
        np.testing.assert_allclose(res[f"pe/{field}"], jx[f"pe/{field}"], rtol=1e-5, atol=1e-6)
        # and the port's own one-device pass, within the same tolerance
        np.testing.assert_allclose(res[f"pe/{field}"], res[f"one_device/{field}"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(ranks[0][f"pe/{field}"], ranks[1][f"pe/{field}"])


@pytest.mark.parametrize("scorer", sorted(HEURISTICS))
def test_sharded_data_optimizer_scores_match_jax(runs, scorer):
    ranks, jx = runs
    rtol = HEURISTICS[scorer]
    for res in ranks:
        got = res[f"scores/{scorer}"]
        assert got.dtype == np.float32 and got.shape == (N,)
        np.testing.assert_allclose(got, jx[f"scores/{scorer}"], rtol=rtol, atol=rtol * 1e-2)
    np.testing.assert_array_equal(ranks[0][f"scores/{scorer}"], ranks[1][f"scores/{scorer}"])


def test_sharded_accuracy_matches_jax(runs):
    ranks, jx = runs
    for res in ranks:
        assert res["accuracy"] == float(jx["accuracy"])


@pytest.mark.parametrize("i", [0, 1])
def test_reweighted_iterator_keeps_each_ranks_rows_of_the_jax_batch(runs, i):
    ranks, jx = runs
    for r, res in enumerate(ranks):
        assert res[f"it{i}/local"]
        for k in ("x", "y"):
            base, meta = jx[f"it{i}/base/{k}"], jx[f"it{i}/meta/{k}"]
            np.testing.assert_array_equal(res[f"it{i}/base/{k}"], base[:, 4 * r:4 * r + 4])
            np.testing.assert_array_equal(res[f"it{i}/meta/{k}"], meta[2 * r:2 * r + 2])


def test_local_batches_feed_the_step_as_the_global_batch(runs):
    for res in runs[0]:
        assert res["local_step_bitwise"]


def test_planner_takes_per_shard_candidates_as_jax(runs):
    ranks, jx = runs
    for res in ranks:
        assert list(res["candidates"]) == list(jx["candidates"]) == [1, 2, 4]
        # an unlimited budget lands on M = 1 and never tries a global-batch M
        assert res["plan"][0] == int(jx["plan"][0]) == 1 and res["plan"][1]
        assert res["plan"][2] <= 4 and int(jx["plan"][2]) <= 4
        # nothing fits 1 byte: the largest per-shard candidate, tried
        assert res["plan_tight"][0] == 4 and not res["plan_tight"][1]
        assert max(res["plan_tight"][2]) == 4


def test_meta_scorer_under_the_mesh(runs):
    r0, r1 = runs[0]
    assert r0["scores/meta"].shape == (N,) and np.all(np.isfinite(r0["scores/meta"]))
    np.testing.assert_array_equal(r0["scores/meta"], r1["scores/meta"])


def test_candidates_refuse_an_uneven_shard():
    base = {"x": torch.zeros(2, 8, 1)}
    with pytest.raises(ValueError, match="do not shard evenly"):
        scale.candidate_microbatches(base, {"x": torch.zeros(5, 1)}, shard_divisor=2)
    # 4 and 2 rows per shard
    assert scale.candidate_microbatches(base, {"x": torch.zeros(4, 1)},
                                        shard_divisor=2) == (1, 2)


def test_map_batches_under_a_host_mesh_equals_no_mesh():
    train, theta, *_ = data()
    per_ex = problems.softmax_per_example(_tapply)
    ttheta = tree.tree_map(torch.from_numpy, theta)
    mesh = M.make_host_mesh(device="cpu")
    with D.CollectiveCounter() as c:
        got = dataopt.score_dataset(per_ex, ttheta, train, fields=("x", "y"),
                                    batch_size=BATCH, mesh=mesh)
    want = dataopt.score_dataset(per_ex, ttheta, train, fields=("x", "y"), batch_size=BATCH,
                                 device="cpu")
    for f in PE_FIELDS + ("label_onehot",):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # one all-reduce per output leaf (loss, logits, label_onehot, uncertainty)
    assert c.counts["all-reduce"] == 4
    two = M.Mesh(("data", "model"), {"data": 2, "model": 1}, object(), 0, 2,
                 torch.device("cpu"))  # the batch-size check comes before any collective
    with pytest.raises(ValueError, match="must divide"):
        dataopt.map_batches(lambda b: b["x"], train, fields=("x",), batch_size=15, mesh=two)


@pytest.mark.cuda
def test_sharded_scoring_on_the_card_matches_the_cpu_ranks(runs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D.spawn(_card_ranks, 2, (str(tmp_path),), store_dir=str(tmp_path), timeout_s=300)
    got = torch.load(tmp_path / "card0.pt", weights_only=False)
    for f in PE_FIELDS:
        np.testing.assert_allclose(got[f], runs[0][0][f"pe/{f}"], rtol=1e-5, atol=1e-6)


def _card_ranks(rank, out_dir):
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_data_mesh(device="cuda")
    train, theta, *_ = data()
    ttheta = tree.tree_map(lambda x: torch.from_numpy(x).to(mesh.device), theta)
    pe = dataopt.score_dataset(problems.softmax_per_example(_tapply), ttheta, train,
                               fields=("x", "y"), batch_size=BATCH, mesh=mesh)
    torch.save({f: getattr(pe, f) for f in PE_FIELDS}, os.path.join(out_dir, f"card{rank}.pt"))
