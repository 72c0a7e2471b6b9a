"""The model mesh axis (``repro_torch.launch.fsdp``, ``launch.mesh``,
``launch.distributed``) against the JAX package's automatic "model" axis.

One module fixture runs everything that needs ranks once: four ``gloo``
ranks of the port (``distributed.spawn``) and, at the same time, the JAX
package in a subprocess on a forced 4-device host mesh, its theta placed
by ``shardings_like(mesh, tree_param_specs(theta, mesh, cfg))`` (the
partial-manual ``shard_map`` of ``make_manual_step`` lowers under jax
0.9.0). Both start from the port's init carried as numpy and
the same numpy batches; base Adam takes eps 1e-3 on warm rows (the base
batches permute the meta batch's sequences), where two implementations of
SAMA agree beyond rounding (ROADMAP queue 3).

The cases, each with its metrics, lam and each rank's blocks of theta,
the base optimizer's moments and SAMA's ``v`` (a probe method that hands
``v`` out as the next theta, or as a metric on the Engine step) held
against JAX's at this file's tolerances (``CLOSE``, ``CLOSE_LOSS`` of
tests/test_torch_distributed.py), and against the port's one-process
oracle at the same:

* bert mini, (data 2, model 2): SAMA manual over the data axes (JAX's
  ``make_manual_step`` on the (2, 2) mesh; the port's oracle
  ``emulate_manual_step`` of 2 data shards) and over every axis (pure DDP
  over 4: JAX's manual step over both axes, the emulation of 4); SAMA,
  T1-T2 and Neumann on the global-batch step (the Engine step on the
  global batch in both packages; the Hessian-vector products go through
  the twice-differentiable gather);
* gemma3-1b SMOKE, (2, 2): manual and pjit (GQA, the vocabulary-sharded
  embedding, the LM loss's CE);
* qwen2-moe SMOKE, (1, 2), each pair of ranks a mesh of its own: manual,
  the expert stack sharded on E. A model group splits its data shard's
  rows, so each rank's MoE layer routes its own tokens as one dispatch
  group, capacity and load-balance loss included: the oracle is the
  Engine step with the data shard cut into 2 microbatches, in both
  packages (the same function JAX's step computes with M = 2);
* bert mini with a Lion base, (1, 4) (the attention projections
  replicated: 2 heads do not split 4 ways).

Also: eps against the oracle so that a replicated leaf counted m times
in ``v``'s norm fails (the counted-twice eps lies far outside the
tolerance); the census per kind and group against a formula (the data
group's all-reduces exactly K + 1 under manual, at model extents 2 and 4);
the model-group replicas of replicated leaves bitwise equal; a checkpoint
saved on (2, 2) bitwise the one-rank save, restored by JAX and by one port
rank and onto the mesh; Adafactor refused under a live model axis; a row
count that does not split over the model group refused.
"""

import dataclasses
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
from repro_torch.core.methods import SAMAMethod  # noqa: E402
from repro_torch.launch import distributed as D  # noqa: E402
from repro_torch.launch import fsdp as F  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.scale import ScaleConfig  # noqa: E402

from test_torch_distributed import CLOSE, CLOSE_LOSS  # noqa: E402
from test_torch_sama import _mini_bert  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
K = 2
LR = 1e-3
ADAM_EPS = 1e-3
#: (arch, base rows, meta rows, sequence length) of each problem
SIZES = {"bert": (16, 8, 32), "gemma": (8, 8, 16), "qwen": (4, 4, 16)}
ARCH = {"gemma": "gemma3-1b", "qwen": "qwen2-moe-a2.7b"}
#: how many tolerances away the eps of a replicated leaf counted m times lies
SEPARATION = 10
#: the JAX cases run in this many subprocesses at once (each compiles its
#: steps, ~5-10 s apiece on the CPU)
JAX_PARTS = 3


def cfg_of(name, pkg):
    if name == "bert":
        return _mini_bert(pkg, False)
    return pkg.get_smoke_config(ARCH[name])


def problem(name, seed=0):
    """theta (the port's init), lam, base (K, B, ...), meta (MB, ...) as
    numpy: warm rows, the base batches permuting the meta sequences."""
    rng = np.random.default_rng(seed)
    cfg = cfg_of(name, configs)
    theta = convert.params_to_numpy(Model(cfg, device="cpu").init(seed))
    b, mb, s = SIZES[name]
    toks = rng.integers(0, cfg.vocab_size, (mb, s)).astype(np.int32)
    rows = np.stack([rng.permutation(np.resize(np.arange(mb), b)) for _ in range(K)])
    base = {"tokens": toks[rows]}
    meta = {"tokens": toks}
    if name == "bert":
        base["y"] = rng.integers(0, 4, (K, b)).astype(np.int32)
        meta["y"] = rng.integers(0, 4, mb).astype(np.int32)
    lam = convert.params_to_numpy(problems.init_data_optimization_lam(seed + 1, device="cpu"))
    return theta, lam, base, meta


def _t(tr):
    return tree.tree_map(torch.from_numpy, tr)


def _np(tr):
    return tree.tree_map(lambda x: x.detach().cpu().numpy().copy(), tr)


# ---------------------------------------------------------------------------
# the JAX side: a subprocess on a forced 4-device host mesh
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[2])
import numpy as np
import jax, jax.numpy as jnp
from repro import configs as jconfigs, optim
from repro.core import EngineConfig, init_state, make_meta_step, problems as jp
from repro.core.methods import SAMAMethod
from repro.launch import distributed as jd
from repro.launch.mesh import AxisType, make_mesh
from repro.launch.sharding import shardings_like, tree_param_specs
from repro.models import Model as JaxModel
from repro.scale import ScaleConfig
import test_torch_model_axis as T


@dataclasses.dataclass(frozen=True)
class VAsTheta(SAMAMethod):
    name: str = "sama_v_as_theta"

    def finalize(self, terms, ctx):
        return terms["hypergrad"], terms["v"]


@dataclasses.dataclass(frozen=True)
class VMetric(SAMAMethod):
    name: str = "sama_v_metric"

    def metrics(self, terms):
        return {"eps": terms["eps"], "v": terms["v"]}


mesh22 = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
cast = lambda t: jax.tree_util.tree_map(jnp.asarray, t)


def put(prefix, state, metrics):
    tr = {"theta": state.theta, "mu": state.base_opt_state.mu, "nu": state.base_opt_state.nu,
          "lam": state.lam}
    for k, v in metrics.items():
        tr[f"metrics/{k}"] = v
    for path, x in jax.tree_util.tree_flatten_with_path(tr)[0]:
        out[prefix + "|" + jax.tree_util.keystr(path)] = np.asarray(x)


def run(name, tag, kind, method, opt, micro):
    theta, lam, base, meta = T.problem(name)
    cfg = T.cfg_of(name, jconfigs)
    model = JaxModel(cfg)
    per_ex = model.classifier_per_example if name == "bert" else model.per_example
    spec = jp.make_data_optimization_spec(per_ex, reweight=True)
    bo = optim.lion(T.LR) if opt == "lion" else optim.adam(T.LR, eps=T.ADAM_EPS)
    mo = optim.adam(T.LR)
    ecfg = EngineConfig(method=method, unroll_steps=T.K, scale=ScaleConfig(microbatch=micro))
    if kind.startswith("manual"):
        th = jax.device_put(cast(theta), shardings_like(mesh22, tree_param_specs(
            cast(theta), mesh22, cfg)))
        st = init_state(th, cast(lam), bo, mo)
        axes = ("data", "model") if kind == "manual_all" else None
        fn = jax.jit(jd.make_manual_step(spec, bo, mo, ecfg, mesh22, axes))
        with mesh22:
            s, m = fn(st, cast(base), cast(meta))
    else:
        st = init_state(cast(theta), cast(lam), bo, mo)
        s, m = jax.jit(make_meta_step(spec, bo, mo, ecfg))(st, cast(base), cast(meta))
    put(f"{name}/{tag}", s, m)


# (name, tag, kind, method, base optimizer, microbatches); one of
# T.JAX_PARTS subprocesses runs every T.JAX_PARTS-th case
CASES = [("bert", "manual", "manual", "sama", "adam", 1),
         ("bert", "manual_v", "manual", VAsTheta(), "adam", 1),
         ("bert", "manual_all", "manual_all", "sama", "adam", 1),
         ("bert", "pjit", "engine", VMetric(), "adam", 1),
         ("bert", "t1t2", "engine", "t1t2", "adam", 1),
         ("bert", "neumann", "engine", "neumann", "adam", 1),
         ("bert", "lion", "engine", VMetric(), "lion", 1),
         ("gemma", "manual", "manual", "sama", "adam", 1),
         ("gemma", "manual_v", "manual", VAsTheta(), "adam", 1),
         ("gemma", "pjit", "engine", VMetric(), "adam", 1),
         ("qwen", "manual", "engine", VMetric(), "adam", 2)]
part = int(sys.argv[3])
for case in CASES[part::T.JAX_PARTS]:
    run(*case)
np.savez(sys.argv[1], **out)
"""


@dataclasses.dataclass(frozen=True)
class VAsTheta(SAMAMethod):
    """SAMA whose finalize hands the (reduced) ``v`` out as the next theta."""
    name: str = "sama_v_as_theta"

    def finalize(self, terms, ctx):
        return terms["hypergrad"], terms["v"]


@dataclasses.dataclass(frozen=True)
class VMetric(SAMAMethod):
    """SAMA that reports ``v`` among its metrics (the Engine step keeps a
    method's metrics)."""
    name: str = "sama_v_metric"

    def metrics(self, terms):
        return {"eps": terms["eps"], "v": terms["v"]}


# ---------------------------------------------------------------------------
# the port's side: four gloo ranks
# ---------------------------------------------------------------------------


def _spec(name):
    model = Model(cfg_of(name, configs), device="cpu")
    per_ex = model.classifier_per_example if name == "bert" else model.per_example
    return problems.make_data_optimization_spec(per_ex, reweight=True)


def _opts(opt="adam"):
    bo = optim.lion(LR) if opt == "lion" else optim.adam(LR, eps=ADAM_EPS)
    return bo, optim.adam(LR)


def _record(state, metrics, census=None):
    """A step's outcome as numpy: the state's trees (blocks on a sharded
    mesh), the metrics (``v`` among them where the method reports it)."""
    out = {"theta": _np(state.theta), "mu": _np(state.base_opt_state.mu),
           "nu": _np(state.base_opt_state.nu), "lam": _np(state.lam),
           "metrics": {k: (_np(v) if isinstance(v, dict) else float(v))
                       for k, v in metrics.items()}}
    if census is not None:
        out["census"] = {g: dict(v) for g, v in census.by_group.items()}
        out["census_bytes"] = {g: dict(v) for g, v in census.bytes_by_group.items()}
    return out


def _counted(step, *args):
    with D.CollectiveCounter() as c:
        s, m = step(*args)
    return _record(s, m, c)


def _ranks(rank, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    res = {"rank": rank}
    mesh22 = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = M.make_mesh((1, 2), ("data", "model"), group=pairs[rank // 2], device="cpu")
    mesh14 = M.make_mesh((1, 4), ("data", "model"), device="cpu")
    res["coords"] = {"22": mesh22.coords(), "12": pair.coords(), "14": mesh14.coords()}

    def scenario(name, mesh, cases, data_extent):
        theta, lam, base, meta = problem(name)
        cfg = cfg_of(name, configs)
        spec = _spec(name)
        for tag, kind, method, opt, micro in cases:
            bo, mo = _opts(opt)
            ecfg = EngineConfig(method=method, unroll_steps=K,
                                scale=ScaleConfig(microbatch=micro))
            if kind == "manual_all":
                st = init_state(_t(theta), _t(lam), bo, mo)
                step = D.make_manual_step(spec, bo, mo, ecfg, mesh, ("data", "model"))
            else:
                fs = F.FSDP(_t(theta), mesh, cfg)
                res[f"{name}/{tag}/sharded"] = fs.sharded
                st = init_state(_t(theta), _t(lam), bo, mo, sharding=fs)
                mk = D.make_manual_step if kind == "manual" else D.make_pjit_step
                step = mk(spec, bo, mo, ecfg, mesh, sharding=fs)
            res[f"{name}/{tag}"] = _counted(step, st, _t(base), _t(meta))
            if rank:
                continue
            # the one-process oracles (rank 0 only; no collective)
            st1 = init_state(_t(theta), _t(lam), bo, mo)
            if kind in ("manual", "manual_all") and micro == 1:
                n = data_extent * (mesh.model_size if kind == "manual_all" else 1)
                s, m = D.emulate_manual_step(spec, bo, mo, ecfg, n, st1, _t(base), _t(meta))
            else:
                s, m = make_meta_step(spec, bo, mo, ecfg)(st1, _t(base), _t(meta))
            res[f"{name}/{tag}/oracle"] = _record(s, m)

    sama = EngineConfig().method
    scenario("bert", mesh22, [("manual", "manual", sama, "adam", 1),
                              ("manual_v", "manual", VAsTheta(), "adam", 1),
                              ("manual_all", "manual_all", sama, "adam", 1),
                              ("pjit", "pjit", VMetric(), "adam", 1),
                              ("t1t2", "pjit", "t1t2", "adam", 1),
                              ("neumann", "pjit", "neumann", "adam", 1)], 2)
    scenario("bert", mesh14, [("lion", "manual", VAsTheta(), "lion", 1),
                              ("lion_state", "manual", sama, "lion", 1)], 1)
    scenario("gemma", mesh22, [("manual", "manual", sama, "adam", 1),
                               ("manual_v", "manual", VAsTheta(), "adam", 1),
                               ("pjit", "pjit", VMetric(), "adam", 1)], 2)
    # qwen's oracle is the Engine step at M 2 (each model rank's rows one
    # dispatch group); the (1, 2) step itself takes M 1
    theta, lam, base, meta = problem("qwen")
    cfg, spec = cfg_of("qwen", configs), _spec("qwen")
    bo, mo = _opts()
    fs = F.FSDP(_t(theta), pair, cfg)
    for tag, method in (("manual", sama), ("manual_v", VAsTheta())):
        res[f"qwen/{tag}/sharded"] = fs.sharded
        step = D.make_manual_step(spec, bo, mo, EngineConfig(method=method, unroll_steps=K),
                                  pair, sharding=fs)
        res[f"qwen/{tag}"] = _counted(step, init_state(_t(theta), _t(lam), bo, mo, sharding=fs),
                                      _t(base), _t(meta))
    if rank == 0:
        s, m = make_meta_step(spec, bo, mo, EngineConfig(method=VMetric(), unroll_steps=K,
                                                         scale=ScaleConfig(microbatch=2)))(
            init_state(_t(theta), _t(lam), bo, mo), _t(base), _t(meta))
        res["qwen/manual/oracle"] = _record(s, m)

    # checkpoints: a (2, 2) learner saves at step 0 and 1; rank 0 saves the
    # one-rank learner's step 0; the saved step 1 loads back onto the mesh
    theta, lam, base, meta = problem("bert")
    cfg, spec = cfg_of("bert", configs), _spec("bert")
    ck = os.path.join(out_dir, "ck")
    kw = dict(base_opt=optim.adam(LR, eps=ADAM_EPS), meta_opt="adam", meta_lr=LR,
              unroll_steps=K)
    learner = api.MetaLearner(spec, mesh=mesh22, model_cfg=cfg, checkpoint_dir=ck, **kw)
    learner.init(_t(theta), _t(lam))
    learner.save()
    if rank == 0:
        one = api.MetaLearner(spec, checkpoint_dir=os.path.join(out_dir, "ck1"), **kw)
        one.init(_t(theta), _t(lam))
        one.save()
    learner.step(_t(base), _t(meta))
    res["ckpt_path"] = learner.save()
    other = api.MetaLearner(spec, mesh=mesh22, model_cfg=cfg, checkpoint_dir=ck, **kw)
    other.init(_t(theta), _t(lam))
    other.load(res["ckpt_path"])
    la, lb = (tree.flatten_with_keys(x.state)[1] for x in (learner, other))
    res["ckpt_loaded_bitwise"] = len(la) == len(lb) and all(torch.equal(a, b)
                                                            for a, b in zip(la, lb))
    res["learner_census"] = learner.verify_census(_t(base), _t(meta))

    # the refusals
    fs = F.FSDP(_t(theta), mesh22, cfg)
    refusals = {}
    for what, call in (
            ("init_state", lambda: init_state(_t(theta), _t(lam), optim.adafactor(LR),
                                              optim.adam(LR), sharding=fs)),
            ("make_manual_step", lambda: D.make_manual_step(spec, optim.adafactor(LR),
                                                            optim.adam(LR), EngineConfig(),
                                                            mesh22, sharding=fs)),
            ("learner", lambda: api.MetaLearner(spec, base_opt="adafactor", mesh=mesh22,
                                                model_cfg=cfg).init(_t(theta), _t(lam))),
            ("no_sharding", lambda: D.make_pjit_step(spec, *_opts(), EngineConfig(), mesh22)),
            ("rows", lambda: D.make_manual_step(spec, *_opts(), EngineConfig(unroll_steps=K),
                                                mesh22, sharding=fs)(
                init_state(_t(theta), _t(lam), *_opts(), sharding=fs),
                {k: v[:, :6] for k, v in _t(base).items()}, _t(meta)))):
        try:
            call()
            refusals[what] = None
        except (NotImplementedError, ValueError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    res["refusals"] = refusals
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("model_axis"))
    jax_out = os.path.join(out_dir, "jax")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, f"{jax_out}{i}.npz", HERE,
                               str(i)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(JAX_PARTS)]
    try:
        D.spawn(_ranks, WORLD, (out_dir,), store_dir=out_dir, timeout_s=600)
    finally:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    jx = {}
    for i in range(JAX_PARTS):
        jx.update(np.load(f"{jax_out}{i}.npz"))
    return ranks, jx, out_dir


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _jax(jx, prefix, field):
    """{name: array} of one of JAX's trees ("theta", "mu", "nu", "lam")
    or of a tree metric ("metrics/v"), keyed by the port's leaf names."""
    head = f"{prefix}|['{field}']"
    return {k[len(head):]: v for k, v in jx.items() if k.startswith(head)}


def _named(tr):
    names, leaves = tree.flatten_with_keys(tr)
    return dict(zip(names, leaves))


def _block(full, name, sharded, coords):
    """This rank's block of a whole leaf (the port's layout, ``sharded``
    from ``FSDP.sharded``)."""
    if name not in sharded:
        return full
    dim, block = sharded[name]
    i = coords["model"]
    return np.take(full, range(i * block[dim], (i + 1) * block[dim]), axis=dim)


def _hold_tree(got, want, sharded, coords, what, tol=CLOSE, sign_lr=None):
    """Every leaf of ``got`` (this rank's blocks) against the block of
    ``want`` (whole leaves, by name). ``sign_lr``: Lion's sign flips, each
    a multiple of 2 lr, are admitted on at most 0.1% of a leaf's entries."""
    got = _named(got)
    assert sorted(got) == sorted(want), what
    for name, g in got.items():
        w = _block(np.asarray(want[name]), name, sharded, coords)
        assert g.shape == w.shape, (what, name)
        bad = ~np.isclose(g, w, **tol)
        if sign_lr is not None and bad.any():
            steps = np.abs(g - w)[bad] / (2 * sign_lr)
            assert np.allclose(steps, np.round(steps), atol=1e-2), (what, name)
            assert bad.mean() <= 1e-3, (what, name, bad.mean())
            continue
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **tol)


def _jax_metrics(jx, prefix):
    """JAX's scalar metrics of a case."""
    head = f"{prefix}|['metrics/"
    return {k[len(head):-2]: v for k, v in jx.items()
            if k.startswith(head) and k.endswith("']") and k.count("['") == 1}


def _hold_metrics(got, want, what):
    for k in ("base_loss", "meta_loss"):
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=f"{what} {k}", **CLOSE_LOSS)
    for k in ("eps", "hypergrad_norm"):
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=f"{what} {k}", **CLOSE)


def _mesh_of(name, tag):
    if name == "qwen":
        return "12"
    return "14" if tag.startswith("lion") else "22"


# ---------------------------------------------------------------------------
# against JAX, and against the port's one-process oracle
# ---------------------------------------------------------------------------

CASES = [("bert", "manual"), ("bert", "manual_all"), ("bert", "pjit"), ("bert", "t1t2"),
         ("bert", "neumann"), ("gemma", "manual"), ("gemma", "pjit"), ("qwen", "manual")]


@pytest.mark.parametrize("name,tag", CASES)
def test_step_matches_jax_and_the_one_process_oracle(runs, name, tag):
    """Metrics, lam, and each rank's blocks of theta and the base moments;
    under pure DDP (manual over every axis) each rank holds the whole
    state."""
    ranks, jx, _ = runs
    prefix = f"{name}/{tag}"
    oracle = ranks[0][prefix + "/oracle"]
    for res in ranks:
        got = res[prefix]
        sharded = {} if tag == "manual_all" else res[f"{prefix}/sharded"]
        coords = res["coords"][_mesh_of(name, tag)]
        _hold_metrics(got["metrics"], _jax_metrics(jx, prefix), f"{prefix} vs jax")
        _hold_metrics(got["metrics"], oracle["metrics"], f"{prefix} vs oracle")
        for field in ("theta", "mu", "nu", "lam"):
            _hold_tree(got[field], _jax(jx, prefix, field), sharded, coords,
                       f"{prefix} {field} vs jax")
            _hold_tree(got[field], _named(oracle[field]), sharded, coords,
                       f"{prefix} {field} vs oracle")


@pytest.mark.parametrize("name,tag", [("bert", "manual"), ("bert", "pjit"),
                                      ("gemma", "manual"), ("gemma", "pjit"),
                                      ("qwen", "manual"), ("bert", "lion")])
def test_v_blocks_match_jax(runs, name, tag):
    """SAMA's ``v``: each rank's blocks against JAX's, from the probe that
    hands it out as theta (manual) or as a metric (the Engine step)."""
    ranks, jx, _ = runs
    for res in ranks:
        case = {"pjit": "pjit", "lion": "lion"}.get(tag, f"{tag}_v")
        sharded, coords = res[f"{name}/{case}/sharded"], res["coords"][_mesh_of(name, tag)]
        if tag == "pjit":
            got = res[f"{name}/{case}"]["metrics"]["v"]
        else:
            got = res[f"{name}/{case}"]["theta"]
        jtag = {"manual": "manual_v"}.get(tag, tag) if name != "qwen" else "manual"
        field = "theta" if jtag == "manual_v" else "metrics/v"
        want = _jax(jx, f"{name}/{jtag}", field)
        _hold_tree(got, want, sharded, coords, f"{name}/{tag} v")


def test_lion_base_at_model_extent_four(runs):
    """Lion's product on each of four ranks' blocks: metrics, lam, theta
    and the momentum against JAX's Engine step on the global batch (a
    data extent of 1), Lion's sign flips admitted as such."""
    ranks, jx, _ = runs
    for res in ranks:
        got = res["bert/lion_state"]
        sharded, coords = res["bert/lion_state/sharded"], res["coords"]["14"]
        assert not any("attn" in n for n in sharded)  # 2 heads do not split 4 ways
        _hold_metrics(got["metrics"], _jax_metrics(jx, "bert/lion"), "lion vs jax")
        for field in ("theta", "mu", "lam"):
            _hold_tree(got[field], _jax(jx, "bert/lion", field), sharded, coords,
                       f"lion {field}", sign_lr=LR if field == "theta" else None)


def test_eps_would_fail_with_a_replicated_leaf_counted_m_times(runs):
    """On the global-batch step eps = alpha / ||v||: the port's eps equals
    that of the whole ``v`` (gathered from the ranks' blocks), and the eps
    that counts each replicated leaf's share m = 2 times lies SEPARATION
    tolerances away from the oracle's, so the held eps catches it."""
    ranks, _, _ = runs
    res = ranks[0]
    sharded = res["bert/pjit/sharded"]
    v_full = _named(ranks[0]["bert/pjit/oracle"]["metrics"]["v"])
    sh2 = sum(float(np.sum(v.astype(np.float64) ** 2)) for n, v in v_full.items()
              if n in sharded)
    rep2 = sum(float(np.sum(v.astype(np.float64) ** 2)) for n, v in v_full.items()
               if n not in sharded)
    assert rep2 > 0 and sh2 > 0
    eps = res["bert/pjit"]["metrics"]["eps"]
    want = res["bert/pjit/oracle"]["metrics"]["eps"]
    np.testing.assert_allclose(eps, 1.0 / np.sqrt(sh2 + rep2), rtol=CLOSE["rtol"])
    wrong = 1.0 / np.sqrt(sh2 + 2 * rep2)
    assert abs(wrong - want) / want > SEPARATION * CLOSE["rtol"]
    np.testing.assert_allclose(eps, want, **CLOSE)


# ---------------------------------------------------------------------------
# the census, replica consistency
# ---------------------------------------------------------------------------


def _formula(sharded, full_shapes, n_leaves, method, schedule, lam_leaves):
    """The collectives of one meta step at M 1 with a fused Adam product:
    per loss call (K base, the meta pass, two central differences for
    SAMA) one all-gather per sharded leaf and one group-loss all-reduce;
    per theta backward (K base, the meta pass) one reduce-scatter per
    sharded leaf and one bucket of the replicated leaves; the two central
    differences' lam buckets; one all-reduce of v's sum of squares. T1-T2
    and Neumann are not counted here."""
    n_sh = len(sharded)
    n_rep = n_leaves - n_sh
    calls, theta_bwd = K + 3, K + 1
    model = {"all-gather": calls * n_sh, "reduce-scatter": theta_bwd * n_sh,
             "all-reduce": calls + theta_bwd * (n_rep > 0) + 2 * (lam_leaves > 0) + 1}
    data = {"all-reduce": K + 1 if schedule == "manual" else K + 4}
    gathered = sum(int(np.prod(full_shapes[n])) for n in sharded) * 4
    return model, data, calls * gathered


@pytest.mark.parametrize("name,tag", [("bert", "manual"), ("bert", "pjit"), ("gemma", "manual"),
                                      ("gemma", "pjit"), ("qwen", "manual"),
                                      ("bert", "lion_state")])
def test_census_per_kind_and_group(runs, name, tag):
    ranks, _, _ = runs
    theta, lam, _, _ = problem(name)
    full = {n: x.shape for n, x in _named(theta).items()}
    n_lam = len(tree.tree_leaves(lam))
    for res in ranks:
        got = res[f"{name}/{tag}"]
        model, data, gathered = _formula(res[f"{name}/{tag}/sharded"], full, len(full), "sama",
                                         "pjit" if tag == "pjit" else "manual", n_lam)
        assert got["census"]["model"] == model, (name, tag)
        assert got["census"]["data"] == data, (name, tag)
        assert got["census_bytes"]["model"]["all-gather"] == gathered
        assert "world" not in got["census"]


def test_pure_ddp_over_every_axis_syncs_the_world_only(runs):
    for res in runs[0]:
        c = res["bert/manual_all"]["census"]
        assert c == {"world": {"all-reduce": K + 1}}


def test_learner_census_checks_the_data_group(runs):
    for res in runs[0]:
        c = res["learner_census"]
        assert c["synced_group"] == "data" and c["single_sync_ok"]
        assert c["groups"]["data"]["all-reduce_count"] == K + 1
        assert c["groups"]["model"]["all-gather_count"] > 0
        assert c["all-reduce_count"] > K + 1  # the model group's beside the data group's


def test_model_group_replicas_are_bitwise_equal(runs):
    """Within a model group the replicated leaves of theta and the moments,
    lam and every metric are bitwise equal; blocks differ."""
    ranks, _, _ = runs
    for name, tag, groups in (("bert", "manual", ((0, 1), (2, 3))),
                              ("bert", "pjit", ((0, 1), (2, 3))),
                              ("gemma", "manual", ((0, 1), (2, 3))),
                              ("qwen", "manual", ((0, 1), (2, 3))),
                              ("bert", "lion_state", ((0, 1, 2, 3),))):
        for grp in groups:
            a = ranks[grp[0]][f"{name}/{tag}"]
            sharded = ranks[grp[0]][f"{name}/{tag}/sharded"]
            for r in grp[1:]:
                b = ranks[r][f"{name}/{tag}"]
                for field in ("theta", "mu", "nu", "lam"):
                    for n, x in _named(a[field]).items():
                        y = _named(b[field])[n]
                        if field == "lam" or n not in sharded:
                            np.testing.assert_array_equal(x, y, err_msg=f"{name} {n}")
                for k in ("base_loss", "meta_loss", "eps", "hypergrad_norm"):
                    assert a["metrics"][k] == b["metrics"][k], (name, tag, k)


def test_data_groups_agree_on_the_manual_steps_shared_values(runs):
    """Manual over the data axes: after the one bucket the data group's
    ranks hold the same blocks (ranks 0 and 2, 1 and 3 of (2, 2))."""
    ranks, _, _ = runs
    for a, b in ((0, 2), (1, 3)):
        for field in ("theta", "mu", "nu", "lam"):
            for x, y in zip(tree.tree_leaves(ranks[a]["bert/manual"][field]),
                            tree.tree_leaves(ranks[b]["bert/manual"][field])):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# checkpoints, refusals
# ---------------------------------------------------------------------------


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_of_a_sharded_state_is_the_one_rank_save(runs, tmp_path):
    """Step 0 saved on (2, 2) is bitwise the one-rank learner's save; step
    1 restores in JAX and on one port rank, bitwise, and a one-rank save
    of the restored state writes the same arrays; every rank loaded its
    blocks back bitwise."""
    from repro import checkpoint as jck
    from repro import optim as joptim
    from repro.core import init_state as jinit

    ranks, _, out_dir = runs
    assert all(r["ckpt_loaded_bitwise"] for r in ranks)
    sharded0 = _arrays(os.path.join(out_dir, "ck", "step_000000"))
    one0 = _arrays(os.path.join(out_dir, "ck1", "step_000000"))
    assert sorted(sharded0) == sorted(one0)
    for k in one0:
        assert sharded0[k].dtype == one0[k].dtype
        np.testing.assert_array_equal(sharded0[k], one0[k])
    path = ranks[0]["ckpt_path"]
    saved = _arrays(path)
    theta, lam, _, _ = problem("bert")
    like = jinit(jax.tree_util.tree_map(jnp.asarray, theta),
                 jax.tree_util.tree_map(jnp.asarray, lam), joptim.adam(LR), joptim.adam(LR))
    jstate, manifest = jck.restore(path, like)
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(jleaves) == len(saved) and manifest["step"] == 1
    for i, x in enumerate(jleaves):
        np.testing.assert_array_equal(np.asarray(x), saved[f"a{i}"])
    spec = _spec("bert")
    one = api.MetaLearner(spec, base_opt=optim.adam(LR, eps=ADAM_EPS), meta_opt="adam",
                          meta_lr=LR, unroll_steps=K, checkpoint_dir=str(tmp_path))
    one.init(_t(theta), _t(lam))
    one.load(path)
    again = _arrays(one.save())
    for k in saved:
        np.testing.assert_array_equal(again[k], saved[k])


def test_adafactor_is_refused_under_a_live_model_axis(runs):
    for res in runs[0]:
        for what in ("init_state", "make_manual_step", "learner"):
            msg = res["refusals"][what]
            assert msg and msg.startswith("NotImplementedError")
            assert "ROADMAP queue 1 item 12" in msg and "adafactor" in msg


def test_a_model_axis_needs_the_sharding_and_rows_that_split(runs):
    for res in runs[0]:
        assert "pass sharding=" in res["refusals"]["no_sharding"]
        rows = res["refusals"]["rows"]
        assert rows.startswith("ValueError")
        # 6 rows over 2 data ranks: shards of 3 rows over 2 model ranks
        assert "6 rows over 2 data ranks" in rows and "3 rows" in rows
        assert "2 model ranks" in rows


def test_sharding_layout_of_the_tested_trees(runs):
    """What the cases shard: bert mini's 7 projection and embedding
    leaves at extent 2, qwen's expert stack on E, gemma's vocabulary."""
    r0 = runs[0][0]
    bert = r0["bert/manual/sharded"]
    assert len(bert) == 7 and bert["['embed']"][0] == 0
    assert bert["['layers']['attn']['wq']"][0] == 2
    qwen = r0["qwen/manual/sharded"]
    ups = [(n, d) for n, d in qwen.items() if "experts" in n]
    assert ups and all(d == 1 for _, (d, _) in ups)  # (L, E, ...): E is dim 1
    assert r0["gemma/manual/sharded"]["['embed']"][0] == 0


def test_fsdp_refuses_a_mesh_without_a_model_axis():
    with pytest.raises(ValueError, match="model extent above 1"):
        F.FSDP({"w": torch.ones(2)}, M.make_host_mesh(device="cpu"))
    assert sh.param_spec("['embed']", (8, 4), M.make_host_mesh(device="cpu")) == ("model", None)
