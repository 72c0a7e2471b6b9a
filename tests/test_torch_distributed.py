"""The port's distributed layer (``repro_torch.launch.distributed`` and
``launch.mesh``, ``perf.collectives``, ``MetaLearner(mesh=, schedule=)``)
against the JAX package's ``repro.launch.distributed``.

One module fixture runs everything that needs ranks once: two ``gloo``
ranks of the port (``distributed.spawn``, a ``FileStore`` in the test's
tmp directory) and, at the same time, the JAX package in a subprocess on a
forced 2-device host mesh (``XLA_FLAGS``, as tests/test_distributed.py
runs it). Both sides start from the same numpy weights and batches (the
MLP of tests/test_distributed.py and ``mini_bert``), the port's drawn by
its own init and carried to JAX as numpy.

Pinned:

* ``make_manual_step`` and ``make_pjit_step`` on distinct shards against
  the JAX package's on the (2, 1) mesh, with tests/test_torch_sama.py's
  tolerances (losses ``LOSS`` 1e-5, eps and hypergrad_norm ``HYPER`` 2e-3
  relative, theta and lam per leaf within 1e-6 + 5% of JAX's update);
* identical shards: both schedules bitwise equal to the one-process
  Engine step on one shard (x + x and the halving are exact);
* the census: exactly ``unroll_steps + 1`` all-reduces per manual step for
  K in {1, 2, 3} and M in {1, 2}, under the bf16 policy and with raw bf16
  parameters; the global-batch step makes K + 4 for SAMA (K base, the
  meta gradient, two central differences, the metrics);
* the global-batch step on distinct shards against the one-process Engine
  step on the concatenated batch (SAMA, T1-T2, Neumann, iterative
  differentiation: 2e-5 relative on the losses and 1e-4 on the rest, the
  rounding of another summation order) and the manual step against its
  in-process emulation, ``allow_nonlinear=True`` Neumann included (the
  same tolerances);
* after every step the two ranks hold bitwise identical states;
* ``MetaLearner`` under a mesh: fit, save on rank 0, load on every rank,
  ``verify_census``, ``profile``;
* single-process: the nonlinear-contract refusal, ``cast_for_reduce``'s
  identity rules, the flat bucket's alignment, meshes with a model axis,
  ``token_cross_entropy(sharded=True)`` against JAX (1e-5), and a rank
  that raises making ``spawn`` raise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import api, configs, convert, optim, tree  # noqa: E402
from repro_torch.core import EngineConfig, init_state, make_meta_step, problems  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.scale import ScaleConfig  # noqa: E402

from test_torch_sama import HYPER, LOSS, UPDATE_ATOL, UPDATE_SHARE, _mini_bert  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 2
K, B, MB = 2, 16, 8  # global base and meta batch rows: 8 and 4 per rank
CLOSE = dict(rtol=1e-4, atol=1e-6)  # one process vs two: another summation order
CLOSE_LOSS = dict(rtol=2e-5, atol=1e-7)
PJIT_SAMA_ALL_REDUCES = K + 4


# ---------------------------------------------------------------------------
# the problems, as numpy (both packages read them)
# ---------------------------------------------------------------------------


def _tapply(theta, x):
    # torch does not promote in a matmul: raw bf16 parameters take bf16 inputs
    return torch.tanh(x.to(theta["w1"].dtype) @ theta["w1"]) @ theta["w2"]


def _japply(theta, x):
    return jnp.tanh(x @ theta["w1"]) @ theta["w2"]


def _np(t):
    return convert.params_to_numpy(t)


def problem(name, k=K, b=B, mb=MB, seed=0):
    """theta, lam, base (k, b, ...), meta (mb, ...) as numpy, and the rate."""
    rng = np.random.default_rng(seed)
    if name == "mlp":
        theta = {"w1": (0.3 * rng.standard_normal((6, 16))).astype(np.float32),
                 "w2": (0.3 * rng.standard_normal((16, 3))).astype(np.float32)}
        base = {"x": rng.standard_normal((k, b, 6)).astype(np.float32),
                "y": rng.integers(0, 3, (k, b)).astype(np.int32)}
        meta = {"x": rng.standard_normal((mb, 6)).astype(np.float32),
                "y": rng.integers(0, 3, mb).astype(np.int32)}
        lr = 1e-2
    else:  # mini_bert on warm rows: the base batches permute the meta batch's rows
        theta = _np(Model(_mini_bert(configs, False), device="cpu").init(0))
        toks = rng.integers(0, 512, (b, 32)).astype(np.int32)
        perms = np.stack([rng.permutation(b) for _ in range(k)])
        base = {"tokens": toks[perms], "y": rng.integers(0, 4, (k, b)).astype(np.int32)}
        meta = {"tokens": toks, "y": rng.integers(0, 4, b).astype(np.int32)}
        lr = 1e-3
    lam = _np(problems.init_data_optimization_lam(seed + 1, device="cpu"))
    return theta, lam, base, meta, lr


def tspec(name):
    per_ex = (problems.softmax_per_example(_tapply) if name == "mlp"
              else Model(_mini_bert(configs, False), device="cpu").classifier_per_example)
    return problems.make_data_optimization_spec(per_ex, reweight=True)


def _t(tr):
    return tree.tree_map(torch.from_numpy, tr)


def _flat(prefix, tr, out):
    leaves, paths = tree.tree_flatten(tr)
    for p, x in zip(paths, leaves):
        out["/".join((prefix,) + p)] = np.asarray(x)


# ---------------------------------------------------------------------------
# the JAX side: a subprocess on a forced 2-device host mesh
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as jconfigs, optim
from repro.core import EngineConfig, init_state, problems as jp
from repro.launch import distributed as jd
from repro.launch.mesh import AxisType, make_mesh
from repro.models import Model as JaxModel
import test_torch_distributed as T
from test_torch_sama import _mini_bert

mesh = make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for name in ("mlp", "bert"):
    theta, lam, base, meta, lr = T.problem(name)
    per_ex = (jp.softmax_per_example(T._japply) if name == "mlp"
              else JaxModel(_mini_bert(jconfigs, False)).classifier_per_example)
    spec = jp.make_data_optimization_spec(per_ex, reweight=True)
    bo, mo = optim.adam(lr), optim.adam(lr)
    cfg = EngineConfig(method="sama", unroll_steps=T.K)
    cast = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    st = init_state(cast(theta), cast(lam), bo, mo)
    steps = {"manual": jax.jit(jd.make_manual_step(spec, bo, mo, cfg, mesh)),
             "pjit": jax.jit(jd.make_pjit_step(spec, bo, mo, cfg))}
    for sched, fn in steps.items():
        with mesh:
            s, m = fn(st, cast(base), cast(meta))
        tp = jax.tree_util.tree_map(np.asarray, {"theta": s.theta, "lam": s.lam})
        T._flat(f"{name}/{sched}", tp, out)
        for k in T.D.METRIC_KEYS:
            out[f"{name}/{sched}/metrics/{k}"] = np.asarray(m[k])
np.savez(sys.argv[1], **out)
"""


# ---------------------------------------------------------------------------
# the port's side: two gloo ranks
# ---------------------------------------------------------------------------


def _state_np(s):
    return {"theta": _np(s.theta), "lam": _np(s.lam)}


def _step_out(s, m):
    return {"state": _state_np(s), "full": [x.clone() for x in tree.flatten_with_keys(s)[1]],
            "metrics": {k: float(v) for k, v in m.items()}}


def _bitwise(a, b):
    la, lb = tree.flatten_with_keys(a)[1], tree.flatten_with_keys(b)[1]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _census(step, *args):
    with D.CollectiveCounter() as c:
        out = step(*args)
    return out, {"count": c.counts["all-reduce"], "bytes": c.bytes["all-reduce"]}


def _ranks(rank, out_dir):
    """Every scenario on this rank; the results go to rank{rank}.pt."""
    torch.set_num_threads(2)
    mesh = M.make_data_mesh(device="cpu")
    res = {}
    for name in ("mlp", "bert"):
        theta, lam, base, meta, lr = problem(name)
        spec = tspec(name)
        bo, mo = optim.adam(lr), optim.adam(lr)
        cfg = EngineConfig(method="sama", unroll_steps=K)
        st = init_state(_t(theta), _t(lam), bo, mo)
        for sched, mk in (("manual", D.make_manual_step), ("pjit", D.make_pjit_step)):
            res[f"{name}/{sched}"] = _step_out(*mk(spec, bo, mo, cfg, mesh)(st, _t(base),
                                                                          _t(meta)))

    # identical shards: each rank's rows are the same 8 and 4
    theta, lam, base, meta, lr = problem("mlp")
    spec, bo, mo = tspec("mlp"), optim.adam(lr), optim.adam(lr)
    cfg = EngineConfig(method="sama", unroll_steps=K)
    st = init_state(_t(theta), _t(lam), bo, mo)
    shard_b = {k: v[:, :B // 2] for k, v in base.items()}
    shard_m = {k: v[:MB // 2] for k, v in meta.items()}
    tiled_b = {k: np.concatenate([v, v], axis=1) for k, v in shard_b.items()}
    tiled_m = {k: np.concatenate([v, v], axis=0) for k, v in shard_m.items()}
    one_s, one_m = make_meta_step(spec, bo, mo, cfg)(st, _t(shard_b), _t(shard_m))
    for sched, mk in (("manual", D.make_manual_step), ("pjit", D.make_pjit_step)):
        s, m = mk(spec, bo, mo, cfg, mesh)(st, _t(tiled_b), _t(tiled_m))
        res[f"identical/{sched}"] = {
            "state_bitwise": _bitwise(s, one_s),
            "metrics_bitwise": all(torch.equal(m[k], one_m[k]) for k in D.METRIC_KEYS)}

    # the census: manual for K in {1, 2, 3}, M in {1, 2}; bf16; the pjit step
    for k in (1, 2, 3):
        theta, lam, base, meta, lr = problem("mlp", k=k)
        for m_count in (1, 2):
            cfg = EngineConfig(method="sama", unroll_steps=k,
                               scale=ScaleConfig(microbatch=m_count))
            st = init_state(_t(theta), _t(lam), bo, mo, scale=cfg.scale)
            _, res[f"census/manual/K{k}/M{m_count}"] = _census(
                D.make_manual_step(spec, bo, mo, cfg, mesh), st, _t(base), _t(meta))
    theta, lam, base, meta, lr = problem("mlp")
    cfg = EngineConfig(method="sama", unroll_steps=K, scale=ScaleConfig(policy="bf16",
                                                                          microbatch=2))
    st = init_state(_t(theta), _t(lam), bo, mo, scale=cfg.scale)
    (_, m), res["census/manual/bf16_policy"] = _census(
        D.make_manual_step(spec, bo, mo, cfg, mesh), st, _t(base), _t(meta))
    res["census/manual/bf16_policy"]["finite"] = all(
        bool(torch.isfinite(v)) for v in m.values())
    theta16 = tree.tree_map(lambda x: x.to(torch.bfloat16), _t(theta))
    cfg = EngineConfig(method="sama", unroll_steps=K, scale=ScaleConfig(microbatch=2))
    st16 = init_state(theta16, _t(lam), bo, mo, scale=cfg.scale)
    (s16, m), res["census/manual/bf16_params"] = _census(
        D.make_manual_step(spec, bo, mo, cfg, mesh), st16, _t(base), _t(meta))
    res["census/manual/bf16_params"]["dtypes_kept"] = all(
        x.dtype == torch.bfloat16 for x in tree.tree_leaves(s16.theta))
    res["census/manual/bf16_params"]["base_loss_finite"] = bool(torch.isfinite(m["base_loss"]))
    cfg = EngineConfig(method="sama", unroll_steps=K)
    st = init_state(_t(theta), _t(lam), bo, mo)
    _, res["census/pjit"] = _census(D.make_pjit_step(spec, bo, mo, cfg, mesh), st, _t(base),
                                    _t(meta))
    _, res["census/manual"] = _census(D.make_manual_step(spec, bo, mo, cfg, mesh), st,
                                      _t(base), _t(meta))

    # oracles in one process: the global batch for pjit, the emulation for manual
    for method in ("sama", "t1t2", "neumann", "iterdiff"):
        cfg = EngineConfig(method=method, unroll_steps=K)
        res[f"pjit/{method}"] = _step_out(*D.make_pjit_step(spec, bo, mo, cfg, mesh)(
            st, _t(base), _t(meta)))
        res[f"one_process/{method}"] = _step_out(*make_meta_step(spec, bo, mo, cfg)(
            st, _t(base), _t(meta)))
    for method in ("sama", "neumann"):
        cfg = EngineConfig(method=method, unroll_steps=K)
        res[f"manual/{method}"] = _step_out(*D.make_manual_step(
            spec, bo, mo, cfg, mesh, allow_nonlinear=True)(st, _t(base), _t(meta)))
        res[f"emulated/{method}"] = _step_out(*D.emulate_manual_step(
            spec, bo, mo, cfg, WORLD, st, _t(base), _t(meta)))

    # the learner under a mesh: fit, save (rank 0), load (every rank), census
    ck = os.path.join(out_dir, "ck")
    learner = api.MetaLearner(spec, base_opt="adam", base_lr=lr, meta_opt="adam", meta_lr=lr,
                              unroll_steps=K, mesh=mesh, checkpoint_dir=ck)
    learner.init(_t(theta), _t(lam))

    def batches():
        for i in range(3):
            _, _, b_i, m_i, _ = problem("mlp", seed=10 + i)
            yield _t(b_i), _t(m_i)

    hist = learner.fit(batches(), steps=3, log_every=1, save_every=3)
    census = learner.verify_census(_t(base), _t(meta))
    rec = learner.profile(_t(base), _t(meta), warmup=1, repeats=1)
    other = api.MetaLearner(spec, base_opt="adam", base_lr=lr, meta_opt="adam", meta_lr=lr,
                            unroll_steps=K, mesh=mesh, checkpoint_dir=ck)
    other.init(_t(theta), _t(lam))
    other.load()
    res["learner"] = {"schedule": learner.schedule, "history": hist, "census": census,
                      "profile_extra": rec.extra, "loaded_bitwise": _bitwise(other.state,
                                                                             learner.state),
                      "full": [x.clone() for x in tree.flatten_with_keys(learner.state)[1]]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    jax_out = os.path.join(out_dir, "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, jax_out, HERE], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        D.spawn(_ranks, WORLD, (out_dir,), store_dir=out_dir, timeout_s=300)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, dict(np.load(jax_out))


def _jax_tree(jx, prefix):
    out = {}
    for key, v in jx.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def _assert_update(got, want, before):
    g_leaves, g_paths = tree.tree_flatten(got)
    w_leaves, w_paths = tree.tree_flatten(want)
    assert g_paths == w_paths
    for path, a, b, b0 in zip(g_paths, g_leaves, w_leaves, tree.tree_leaves(before)):
        bound = UPDATE_ATOL + UPDATE_SHARE * np.max(np.abs(b - b0))
        worst = np.max(np.abs(a - b)) / bound
        assert worst <= 1.0, f"{'/'.join(path)}: {worst:.2f} of the bound"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mlp", "bert"])
@pytest.mark.parametrize("sched", ["manual", "pjit"])
def test_schedule_matches_jax_on_distinct_shards(runs, name, sched):
    ranks, jx = runs
    got = ranks[0][f"{name}/{sched}"]
    want = _jax_tree(jx, f"{name}/{sched}")
    for key in ("base_loss", "meta_loss"):
        np.testing.assert_allclose(got["metrics"][key], float(want["metrics"][key]),
                                   err_msg=key, **LOSS)
    for key in ("eps", "hypergrad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(want["metrics"][key]),
                                   err_msg=key, **HYPER)
    theta, lam, _, _, _ = problem(name)
    _assert_update(got["state"]["theta"], want["theta"], theta)
    _assert_update(got["state"]["lam"], want["lam"], lam)


#: how many tolerances apart the two schedules' eps and hypergrad_norm must
#: lie, so that a schedule degenerated into the other fails its own check
SEPARATION = 10


def _gap(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", ["mlp", "bert"])
def test_manual_and_pjit_differ_on_distinct_shards_as_in_jax(runs, name):
    """The two estimators are not the same function of distinct shards:
    in both packages the lam updates differ between the schedules, and eps
    and hypergrad_norm lie SEPARATION times HYPER apart, so the port's
    manual step would fail the JAX pjit step's tolerance and the reverse.
    (Under SAMA theta and the losses match across the schedules, and lam
    passes through one Adam step, which hardly sees the hypergradient's
    size: these two metrics carry the difference.)"""
    ranks, jx = runs
    got = [ranks[0][f"{name}/{s}"]["state"]["lam"] for s in ("manual", "pjit")]
    want = [_jax_tree(jx, f"{name}/{s}")["lam"] for s in ("manual", "pjit")]
    for g, w in ((got, "port"), (want, "jax")):
        diff = max(np.max(np.abs(a - b)) for a, b in zip(tree.tree_leaves(g[0]),
                                                         tree.tree_leaves(g[1])))
        assert diff > 0, w
    port = [ranks[0][f"{name}/{s}"]["metrics"] for s in ("manual", "pjit")]
    jaxm = [_jax_tree(jx, f"{name}/{s}")["metrics"] for s in ("manual", "pjit")]
    for key in ("eps", "hypergrad_norm"):
        for man, pj, w in ((port[0], port[1], "port"), (jaxm[0], jaxm[1], "jax"),
                           (port[0], jaxm[1], "port manual vs jax pjit"),
                           (port[1], jaxm[0], "port pjit vs jax manual")):
            gap = _gap(float(man[key]), float(pj[key]))
            assert gap >= SEPARATION * HYPER["rtol"], f"{w} {key}: {gap:.2e}"


# ---------------------------------------------------------------------------
# identical shards, the census, replica consistency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["manual", "pjit"])
def test_identical_shards_bitwise_equal_one_process_step(runs, sched):
    for res in runs[0]:
        assert res[f"identical/{sched}"] == {"state_bitwise": True, "metrics_bitwise": True}


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_census_exactly_unroll_plus_one(runs, k, m):
    for res in runs[0]:
        assert res[f"census/manual/K{k}/M{m}"]["count"] == k + 1


def test_census_bytes_unchanged_by_accumulation(runs):
    res = runs[0][0]
    for k in (1, 2, 3):
        assert res[f"census/manual/K{k}/M1"]["bytes"] == res[f"census/manual/K{k}/M2"]["bytes"]


def test_census_under_bf16(runs):
    res = runs[0][0]
    assert res["census/manual/bf16_policy"]["count"] == K + 1
    assert res["census/manual/bf16_policy"]["finite"]
    raw = res["census/manual/bf16_params"]
    assert raw["count"] == K + 1 and raw["dtypes_kept"] and raw["base_loss_finite"]
    # the bucket is f32 whatever the leaves' dtype: the same bytes as f32 params
    assert raw["bytes"] == res[f"census/manual/K{K}/M2"]["bytes"]


def test_pjit_makes_more_collectives_than_manual(runs):
    res = runs[0][0]
    assert res["census/manual"]["count"] == K + 1
    assert res["census/pjit"]["count"] == PJIT_SAMA_ALL_REDUCES > res["census/manual"]["count"]
    assert res["census/pjit"]["bytes"] > res["census/manual"]["bytes"]


def test_ranks_hold_bitwise_identical_states(runs):
    r0, r1 = runs[0]
    keys = [k for k, v in r0.items() if isinstance(v, dict) and "full" in v]
    assert len(keys) >= 12
    for key in keys:
        assert len(r0[key]["full"]) == len(r1[key]["full"])
        for a, b in zip(r0[key]["full"], r1[key]["full"]):
            assert torch.equal(a, b) or (torch.isnan(a).any() and torch.equal(
                a.nan_to_num(), b.nan_to_num())), key


# ---------------------------------------------------------------------------
# the in-process oracles
# ---------------------------------------------------------------------------


def _assert_close(got, want):
    for key in ("base_loss", "meta_loss"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], err_msg=key,
                                   **CLOSE_LOSS)
    for key in ("eps", "hypergrad_norm"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], err_msg=key,
                                   **CLOSE)
    for field in ("theta", "lam"):
        for a, b in zip(tree.tree_leaves(got["state"][field]),
                        tree.tree_leaves(want["state"][field])):
            np.testing.assert_allclose(a, b, err_msg=field, **CLOSE)


@pytest.mark.parametrize("method", ["sama", "t1t2", "neumann", "iterdiff"])
def test_pjit_equals_one_process_step_on_the_global_batch(runs, method):
    res = runs[0][0]
    _assert_close(res[f"pjit/{method}"], res[f"one_process/{method}"])


@pytest.mark.parametrize("method", ["sama", "neumann"])
def test_manual_equals_its_in_process_emulation(runs, method):
    """Neumann runs with allow_nonlinear=True: the average of local solves."""
    res = runs[0][0]
    _assert_close(res[f"manual/{method}"], res[f"emulated/{method}"])


def test_oracle_tolerances_separate_the_schedules(runs):
    """CLOSE holds the manual step to its emulation and the pjit step to
    the global batch; the manual step lies SEPARATION times CLOSE (and
    HYPER) away from the global-batch oracle in eps and hypergrad_norm, so
    a pjit step that lost its meta-level reduces (or a manual step that
    gained them) fails its oracle."""
    res = runs[0][0]
    man, glob = res["manual/sama"]["metrics"], res["one_process/sama"]["metrics"]
    emu, pj = res["emulated/sama"]["metrics"], res["pjit/sama"]["metrics"]
    rtol = SEPARATION * max(CLOSE["rtol"], HYPER["rtol"])
    for key in ("eps", "hypergrad_norm"):
        assert _gap(man[key], glob[key]) >= rtol, key
        assert _gap(pj[key], emu[key]) >= rtol, key


def test_learner_under_a_mesh(runs):
    for res in runs[0]:
        lr = res["learner"]
        assert lr["schedule"] == "single_sync"
        assert [h["step"] for h in lr["history"]] == [0, 1, 2]
        assert lr["census"]["all-reduce_count"] == K + 1 and lr["census"]["single_sync_ok"]
        assert lr["census"]["expected_all_reduces"] == K + 1
        assert lr["profile_extra"]["schedule"] == "single_sync"
        assert lr["profile_extra"]["mesh"] == {"data": WORLD, "model": 1}
        assert lr["loaded_bitwise"]
    r0, r1 = runs[0]
    assert r0["learner"]["history"] == r1["learner"]["history"]


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------


def _mlp_setup(method="sama"):
    theta, lam, base, meta, lr = problem("mlp")
    bo, mo = optim.adam(lr), optim.adam(lr)
    return tspec("mlp"), bo, mo, EngineConfig(method=method, unroll_steps=K), theta, lam


@pytest.mark.parametrize("method", ["neumann", "cg", "iterdiff"])
def test_nonlinear_contract_refused_unless_allowed(method):
    spec, bo, mo, cfg, _, _ = _mlp_setup(method)
    mesh = M.make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="nonlinear reduce contract"):
        D.make_manual_step(spec, bo, mo, cfg, mesh)
    with pytest.raises(ValueError, match="nonlinear reduce contract"):
        api.MetaLearner(spec, method=method, mesh=mesh)
    D.make_manual_step(spec, bo, mo, cfg, mesh, allow_nonlinear=True)


def test_single_sync_without_a_mesh_raises_and_auto_picks_the_schedule():
    spec = tspec("mlp")
    with pytest.raises(ValueError, match="needs a mesh"):
        api.MetaLearner(spec, schedule="single_sync")
    with pytest.raises(ValueError, match="not in"):
        api.MetaLearner(spec, schedule="ddp")
    assert api.MetaLearner(spec).schedule == "pjit"
    assert api.MetaLearner(spec, mesh=M.make_host_mesh(device="cpu")).schedule == "single_sync"
    assert api.SCHEDULES == ("auto", "pjit", "single_sync")


@pytest.mark.parametrize("sched", ["single_sync", "pjit"])
def test_host_mesh_step_bitwise_equals_engine_step(sched):
    """One rank, no process group: the schedules' collectives are
    identities, counted all the same."""
    spec, bo, mo, cfg, theta, lam = _mlp_setup()
    _, _, base, meta, _ = problem("mlp")
    st = init_state(_t(theta), _t(lam), bo, mo)
    ref_s, ref_m = make_meta_step(spec, bo, mo, cfg)(st, _t(base), _t(meta))
    learner = api.MetaLearner(spec, base_opt=bo, meta_opt=mo, unroll_steps=K,
                              mesh=M.make_host_mesh(device="cpu"), schedule=sched)
    learner.init(_t(theta), _t(lam))
    census = learner.verify_census(_t(base), _t(meta))
    m = learner.step(_t(base), _t(meta))
    assert _bitwise(learner.state, ref_s)
    assert all(torch.equal(m[k], ref_m[k]) for k in D.METRIC_KEYS)
    assert census["single_sync_ok"] == (sched == "single_sync")
    assert census["all-reduce_count"] == (K + 1 if sched == "single_sync"
                                          else PJIT_SAMA_ALL_REDUCES)


def test_cast_for_reduce_promotes_only_sub_f32_floats():
    f32, f64 = torch.ones(3), torch.ones(2, dtype=torch.float64)
    i32, b16, h16 = torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.bfloat16), \
        torch.ones(2, dtype=torch.float16)
    out = D.cast_for_reduce({"a": f32, "b": f64, "c": i32, "d": b16, "e": h16})
    assert out["a"] is f32 and out["b"] is f64 and out["c"] is i32
    assert out["d"].dtype == torch.float32 and out["e"].dtype == torch.float32
    assert torch.equal(out["d"], b16.float())


def test_flat_pmean_one_bucket_aligned_views():
    mesh = M.make_host_mesh(device="cpu")
    tr = {"a": torch.arange(5.0), "b": {"c": torch.ones(3, 7), "d": torch.tensor(2.0)}}
    with D.CollectiveCounter() as c:
        out = D.flat_pmean(tr, mesh)
    assert dict(c.counts) == {"all-reduce": 1}
    # slots of 16 elements: 5 -> 16, 21 -> 32, 1 -> 16
    assert c.bytes["all-reduce"] == 4 * (16 + 32 + 16)
    base = out["a"].untyped_storage().data_ptr()
    for x, y in zip(tree.tree_leaves(out), tree.tree_leaves(tr)):
        assert torch.equal(x, y) and x.untyped_storage().data_ptr() == base
        assert (x.data_ptr() - base) % (4 * D.BUCKET_ALIGN) == 0
    with pytest.raises(ValueError, match="one dtype"):
        D.flat_pmean({"a": torch.ones(2), "b": torch.ones(2, dtype=torch.float64)}, mesh)
    # the per-leaf form: one all-reduce per leaf, the same values
    with D.CollectiveCounter() as c:
        per_leaf = D.tree_pmean(tr, mesh)
    assert c.counts["all-reduce"] == 3 and c.bytes["all-reduce"] == 4 * (5 + 21 + 1)
    assert all(torch.equal(x, y) for x, y in zip(tree.tree_leaves(per_leaf),
                                                 tree.tree_leaves(tr)))


def test_model_axis_meshes_hold_their_groups_and_data_axes():
    """A (1, 2) mesh and a (1, 1, 4) pod mesh: their groups (a stand-in
    object each: building a mesh makes no collective), ranks, coordinates
    and data axes; the 1-rank host mesh and a pod mesh of extent 1 keep
    the pure data-parallel layout."""
    cpu = torch.device("cpu")
    model_group, world = object(), object()
    two = M.Mesh(("data", "model"), {"data": 1, "model": 2}, None, 0, 1, cpu,
                 model_group=model_group, model_rank=1, world_group=world)
    assert M.data_axes(two) == ("data",) and two.model_size == 2
    assert (two.world_rank, two.world_size) == (1, 2)
    assert two.coords() == {"data": 0, "model": 1}
    assert two.process_group("model") is model_group and two.process_group("world") is world
    assert two.process_group("data") is None and two.extent("model") == 2
    assert torch.equal(two.local({"x": torch.arange(8)}, 0)["x"], torch.arange(4, 8))
    pod = M.Mesh(("pod", "data", "model"), {"pod": 1, "data": 1, "model": 4}, None, 0, 1, cpu,
                 model_group=model_group, model_rank=3, world_group=world)
    assert M.data_axes(pod) == ("pod", "data")
    assert pod.coords() == {"pod": 0, "data": 0, "model": 3} and pod.world_rank == 3
    assert torch.equal(pod.local({"x": torch.arange(8).reshape(1, 8)}, 1)["x"],
                       torch.tensor([[6, 7]]))
    with pytest.raises(ValueError, match="needs a model group"):
        M.Mesh(("data", "model"), {"data": 1, "model": 2}, None, 0, 1, cpu)
    mesh = M.make_host_mesh(device="cpu")
    assert M.data_axes(mesh) == ("data",) and mesh.shape == {"data": 1, "model": 1}
    assert mesh.world_group is None and mesh.world_rank == 0
    assert M.data_axes(M.Mesh(("pod", "data", "model"), {"pod": 1, "data": 1, "model": 1},
                              None, 0, 1, torch.device("cpu"))) == ("pod", "data")


def test_mesh_local_rows_and_local_batch():
    mesh = M.Mesh(("data", "model"), {"data": 1, "model": 1}, None, 0, 1, torch.device("cpu"))
    x = torch.arange(24).reshape(2, 12)
    assert torch.equal(mesh.local({"x": x}, 1)["x"], x)
    lb = M.LocalBatch(x=x[:, :3])
    assert mesh.local(lb, 1) is lb
    import types

    assert M.Mesh.rows(types.SimpleNamespace(rank=1, size=2), 12) == slice(6, 12)
    with pytest.raises(ValueError, match="does not shard evenly"):
        M.Mesh.rows(types.SimpleNamespace(rank=0, size=5), 12)


def test_production_mesh_needs_the_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        M.make_production_mesh()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        M.make_production_mesh()


@pytest.mark.parametrize("v", [37, 5000])
def test_sharded_token_cross_entropy_matches_jax(v):
    from repro.models.model import token_cross_entropy as jce
    from repro_torch.models.model import token_cross_entropy as tce

    rng = np.random.default_rng(v)
    logits = (3 * rng.standard_normal((2, 5, v))).astype(np.float32)
    targets = rng.integers(0, v, (2, 5)).astype(np.int32)
    want = np.asarray(jce(jnp.asarray(logits), jnp.asarray(targets), sharded=True))
    got = tce(torch.from_numpy(logits), torch.from_numpy(targets), sharded=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tce(torch.from_numpy(logits),
                                                torch.from_numpy(targets)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_sharded_ce_config_routes_the_lm_losses_as_jax(monkeypatch):
    """``cfg.sharded_ce`` selects the one-hot-reduction form in ``lm_loss``
    and ``per_example``, in both packages (the gemma3-1b smoke config)."""
    from repro import configs as jconfigs
    from repro.models import Model as JaxModel

    from test_torch_sama import _np_tree

    jm = JaxModel(jconfigs.get_smoke_config("gemma3-1b").replace(sharded_ce=True))
    jparams = jm.init(jax.random.PRNGKey(4))
    tm = Model(configs.get_smoke_config("gemma3-1b").replace(sharded_ce=True), device="cpu")
    tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(float(tm.lm_loss(tparams, tb)), float(jm.lm_loss(jparams, jb)),
                               rtol=1e-5)
    np.testing.assert_allclose(tm.per_example(tparams, tb).loss.detach().numpy(),
                               np.asarray(jm.per_example(jparams, jb).loss), rtol=1e-5)
    from repro_torch.models import model as model_mod

    seen, plain = [], model_mod.token_cross_entropy
    monkeypatch.setattr(model_mod, "token_cross_entropy",
                        lambda *a: seen.append(a[3]) or plain(*a))
    tm.lm_loss(tparams, tb)
    tm.per_example(tparams, tb)
    assert seen == [True, True]


def _raise_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("rank one fails")


def test_a_failing_rank_makes_spawn_raise(tmp_path):
    with pytest.raises(Exception, match="rank one fails"):
        D.spawn(_raise_on_rank_one, 2, store_dir=str(tmp_path), timeout_s=60)


# ---------------------------------------------------------------------------
# on the card: two gloo ranks sharing it
# ---------------------------------------------------------------------------


def _card_ranks(rank, out_dir):
    mesh = M.make_data_mesh(device="cuda")
    theta, lam, base, meta, lr = problem("bert")
    spec = problems.make_data_optimization_spec(
        Model(_mini_bert(configs, False), device="cuda").classifier_per_example, reweight=True)
    bo, mo = optim.adam(lr), optim.adam(lr)
    cfg = EngineConfig(method="sama", unroll_steps=K)
    dev = torch.device("cuda", 0)
    put = lambda t: tree.tree_map(lambda x: torch.from_numpy(x).to(dev), t)  # noqa: E731
    st = init_state(put(theta), put(lam), bo, mo)
    out = {}
    for sched, mk in (("manual", D.make_manual_step), ("pjit", D.make_pjit_step)):
        (s, m), c = _census(mk(spec, bo, mo, cfg, mesh), st, put(base), put(meta))
        out[sched] = {"state": _state_np(s), "metrics": {k: float(m[k]) for k in m}, **c}
    torch.save(out, os.path.join(out_dir, f"card{rank}.pt"))


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_the_cpu_ranks(runs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    D.spawn(_card_ranks, 2, (str(tmp_path),), store_dir=str(tmp_path), timeout_s=300)
    card = [torch.load(tmp_path / f"card{r}.pt", weights_only=False) for r in range(2)]
    for sched in ("manual", "pjit"):
        assert card[0][sched]["state"].keys() == card[1][sched]["state"].keys()
        assert card[0][sched]["count"] == (K + 1 if sched == "manual" else PJIT_SAMA_ALL_REDUCES)
        got, want = card[0][sched], runs[0][0][f"bert/{sched}"]
        for key in ("base_loss", "meta_loss"):
            np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], **LOSS)
        for key in ("eps", "hypergrad_norm"):
            np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], **HYPER)


# ---------------------------------------------------------------------------
# the CLI and the bench
# ---------------------------------------------------------------------------


def test_train_cli_manual_collectives_on_the_host_mesh(capsys):
    """Standard output keeps one JSON line per logged step; the startup
    line on standard error names the mesh and the schedule."""
    from repro_torch.launch import train

    train.main(["--arch", "bert-base", "--smoke", "--device", "cpu", "--steps", "2",
                "--log-every", "1", "--batch", "4", "--seq", "16", "--manual-collectives"])
    out = capsys.readouterr()
    rows = [json.loads(line) for line in out.out.splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r[k]) for r in rows for k in D.METRIC_KEYS)
    run = json.loads(out.err.strip().splitlines()[-1])["run"]
    assert run["schedule"] == "single_sync" and run["mesh"] == {"data": 1, "model": 1}


def test_bench_distributed_smoke_on_two_cpu_ranks(tmp_path):
    from repro_torch import perf
    from repro_torch.perf import bench_distributed

    path = bench_distributed.run(world=2, device="cpu", smoke=True, out_dir=str(tmp_path))
    payload = perf.load_bench(path)
    recs = {r["name"]: r for r in payload["records"]}
    man, pj = recs["fig2_manual_step"], recs["fig2_pjit_step"]
    assert man["collectives"]["all-reduce_count"] == bench_distributed.UNROLL + 1
    assert man["collectives"]["single_sync_ok"]
    assert man["us_per_step"]["repeats"] == bench_distributed.SMOKE_SIZES["repeats"]
    assert pj["collectives"]["all-reduce_count"] == bench_distributed.UNROLL + 4
    for r in (man, pj):
        assert r["extra"]["world"] == 2 and r["extra"]["backend"] == "gloo"
        assert r["us_per_step"]["median_us"] > 0


@pytest.mark.cuda
def test_train_cli_under_torchrun_on_the_card(tmp_path):
    """One NCCL rank through torchrun (--production-mesh), as the verify
    recipe runs it; --standalone lets torchrun pick a free port, so two
    checkouts on one machine do not meet on the static default."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "repro_torch.launch.train", "--arch", "bert-base", "--smoke", "--steps", "2",
         "--log-every", "1", "--batch", "4", "--seq", "16", "--production-mesh",
         "--manual-collectives"], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1]
    assert '"backend": "nccl"' in out.stderr
