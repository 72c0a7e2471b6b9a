"""The port's moe family and dense family with MLA, and the configs that
join with them (qwen2-moe-a2.7b, kimi-k2-1t-a32b, minicpm3-4b, gemma2-9b,
gemma3-27b), against the JAX package on each config's ``SMOKE``, on the
JAX weights carried over by ``repro_torch.convert`` and tokens from one
numpy seed:

* the config copies field for field, and the full-size parameter and
  cache trees path for path and shape for shape (``jax.eval_shape``
  against the port's ``meta`` device);
* ``forward`` logits and aux, ``lm_loss`` (which adds the MoE aux),
  ``per_example`` (which drops it) and the gradient of ``lm_loss`` in
  every parameter, within ``test_torch_model_decode.py``'s 1e-4;
* block prefill, then one-token decode at per-lane positions: logits and
  every cache leaf within 1e-4;
* continuous batching token for token equal to the port's serial path
  and to the JAX executor (qwen2-moe, minicpm3);
* one SAMA meta step through ``MetaLearner`` from one state, at
  ``test_torch_sama.py``'s tolerances, with warm rows and base Adam eps
  1e-3 (qwen2-moe, minicpm3);
* an MoE learner's checkpoint across the packages, bitwise;
* the families not ported yet raise, naming their ROADMAP item;
* the train and serve CLIs on the CPU for the new archs, and their
  refusal without a card.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import api, configs, convert, optim, serve, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

from test_torch_sama import _np_tree, _run_pair  # noqa: E402

NEW = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "minicpm3-4b", "gemma2-9b", "gemma3-27b"]
SERVED = ["qwen2-moe-a2.7b", "minicpm3-4b"]
TOL = dict(atol=1e-4, rtol=1e-4)

_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        jm = JaxModel(jconfigs.get_smoke_config(arch))
        jparams = jm.init(jax.random.PRNGKey(0))
        tm = Model(configs.get_smoke_config(arch), device="cpu")
        tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
        _PAIRS[arch] = (jm, jparams, tm, tparams)
    return _PAIRS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_tree_close(torch_tree, jax_tree, **tol):
    got = convert.params_to_numpy(torch_tree)
    g_leaves, g_paths = tree.tree_flatten(got)
    r_leaves, r_paths = tree.tree_flatten(_np_tree(jax_tree))
    assert g_paths == r_paths
    for path, a, b in zip(g_paths, g_leaves, r_leaves):
        np.testing.assert_allclose(a, b, err_msg="/".join(path), **(tol or TOL))


def _shapes(t):
    leaves, paths = tree.tree_flatten(t)
    return {p: tuple(x.shape) for p, x in zip(paths, leaves)}


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------


def test_registry_holds_the_ported_families_archs():
    assert configs.list_archs() == sorted(NEW + ["gemma3-1b", "bert-base"])
    for name in configs.list_archs():
        assert configs.get_config(name).family in ("dense", "moe", "encoder")


@pytest.mark.parametrize("arch", NEW)
def test_config_copy_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        a, b = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert a.__dict__ == b.__dict__
        assert a.layer_kinds == b.layer_kinds


# parameters from the JAX package's init under jax.eval_shape
FULL_PARAMS = {"qwen2-moe-a2.7b": 14.00e9, "kimi-k2-1t-a32b": 1027e9, "minicpm3-4b": 4.07e9,
               "gemma2-9b": 9.24e9, "gemma3-27b": 27.0e9}


@pytest.mark.parametrize("arch", NEW)
def test_full_size_param_and_cache_shapes_match(arch):
    jm = JaxModel(jconfigs.get_config(arch))
    tm = Model(configs.get_config(arch), device="meta")
    jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tparams = tm.init(0)
    assert _shapes(tparams) == _shapes(jax.tree_util.tree_map(lambda x: x, jshape))
    jdt = [str(x.dtype) for x in tree.tree_leaves(jax.tree_util.tree_map(lambda x: x, jshape))]
    assert [str(x.dtype).split(".")[-1] for x in tree.tree_leaves(tparams)] == jdt
    n = tm.num_params(tparams)
    assert abs(n - FULL_PARAMS[arch]) < 0.01 * FULL_PARAMS[arch]
    jcache = jax.eval_shape(lambda: jm.init_cache(4, 1024))
    assert _shapes(tm.init_cache(4, 1024, device="meta")) == _shapes(jcache)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_unported_families_raise_naming_their_roadmap_item(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.ArchConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(configs.ArchConfig)})
    item = "4b" if cfg.family in ("ssm", "hybrid") else "4c"
    for call in (lambda: tf.init_params(cfg, 0, device="cpu"),
                 lambda: tf.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: tf.forward(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)}),
                 lambda: tf.decode_step(cfg, {}, {}, torch.zeros(1, 1, dtype=torch.long), 0)):
        with pytest.raises(ValueError, match=f"not ported.*ROADMAP queue 1 item {item}"):
            call()
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config(arch)


# ---------------------------------------------------------------------------
# forward, losses, gradients; prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_forward_losses_and_gradient_match_jax(arch):
    jm, jparams, tm, tparams = _pair(arch)
    toks = _tokens(tm.cfg, (2, 12), 4)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jlogits, jaux = jm.forward(jparams, jb)
    tlogits, taux = tm.forward(tparams, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if tm.cfg.family == "moe":
        assert float(taux) > 0.0  # the load-balance loss is alive
    jpe, tpe = jm.per_example(jparams, jb), tm.per_example(tparams, tb)
    for key in ("loss", "uncertainty"):
        np.testing.assert_allclose(getattr(tpe, key).detach().numpy(),
                                   np.asarray(getattr(jpe, key)), err_msg=key, **TOL)
    # lm_loss adds the aux, per_example drops it
    np.testing.assert_allclose(float(torch.mean(tpe.loss) + taux), float(tm.lm_loss(tparams, tb)),
                               rtol=1e-6)
    jloss, jgrad = jax.value_and_grad(jm.lm_loss)(jparams, jb)
    theta = tree.tree_map(lambda t: t.detach().clone().requires_grad_(), tparams)
    tloss = tm.lm_loss(theta, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    leaves, _ = tree.tree_flatten(theta)
    grads = torch.autograd.grad(tloss, leaves)
    _assert_tree_close(tree.tree_unflatten(tree.tree_flatten(theta)[1], grads), jgrad)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_then_lane_decode_match_jax(arch):
    """Block prefill of B=3 prompts from position 0, then three one-token
    steps at per-lane positions, each feeding the cache forward."""
    jm, jparams, tm, tparams = _pair(arch)
    B, P, CL = 3, 10, 24
    toks = _tokens(tm.cfg, (B, P), 1)
    jl, jc = jm.decode_step(jparams, jm.init_cache(B, CL, jnp.float32), jnp.asarray(toks),
                            jnp.asarray(0, jnp.int32))
    tc = tm.init_cache(B, CL, torch.float32)
    tl, same = tm.decode_step(tparams, tc, torch.from_numpy(toks).long(), 0)
    assert same is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc)
    pos = np.array([10, 6, 8], np.int32)
    nxt = _tokens(tm.cfg, (B, 1), 2)
    for _ in range(3):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt).long(), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree_close(tc, jc)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_continuous_batched_matches_serial_and_jax(arch):
    """Mixed-length staggered arrivals with early finishers at slots=2:
    the port's continuous batching gives the port's serial greedy tokens
    and the JAX executor's."""
    jm, jparams, tm, tparams = _pair(arch)
    lens = [5, 9, 3, 12, 7, 1]
    gens = [6, 4, 8, 5, 7, 1]
    prompts = [_tokens(tm.cfg, (L,), i) for i, L in enumerate(lens)]
    serial = [serve.greedy_generate(tm, tparams, torch.from_numpy(p[None]), g, 32)[0].tolist()
              for p, g in zip(prompts, gens)]
    scfg = dict(slots=2, page_size=4, max_len=32, max_new_tokens=8)
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(**scfg))
    ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    stats = ex.run()
    jex = jserve.ServeExecutor(jm, jparams, jserve.ServeConfig(**scfg))
    jids = [jex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    jex.run()
    for rid, jid, ref in zip(ids, jids, serial):
        assert ex.results[rid].status == serve.STATUS_OK
        assert ex.results[rid].tokens == ref == jex.results[jid].tokens
    assert stats.completed == len(lens) and stats.errors == 0


def test_paged_cache_pages_the_mla_and_moe_leaves():
    """build_spec finds one batch and one time axis in MLA's 3-D ckv and
    krope leaves and in both stacks of kimi-k2's cache."""
    for arch, names in (("minicpm3-4b", ["kv/ckv", "kv/krope"]),
                        ("kimi-k2-1t-a32b", ["dense_kv/k", "dense_kv/v", "kv/k", "kv/v"])):
        tm = Model(configs.get_smoke_config(arch), device="cpu")
        spec = serve.build_spec(tm, page_size=4, dtype=torch.float32)
        assert ["/".join(p) for p in spec.treedef] == names
        assert all((ls.batch_axis, ls.time_axis) == (1, 2) for ls in spec.leaves)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


def _lm_warm_batches(cfg, k=2, b=4, s=16):
    """The K base batches are row permutations of the meta batch's
    sequences (warm Adam rows, as tests/test_torch_sama.py explains)."""
    def batches(i):
        r = np.random.default_rng(11 + i)
        toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        perms = np.stack([r.permutation(b) for _ in range(k)])
        return {"tokens": toks[perms]}, {"tokens": toks}
    return batches


@pytest.mark.parametrize("arch", SERVED)
def test_sama_meta_step_matches_jax(arch):
    jm, jparams, tm, _ = _pair(arch)
    kw = dict(meta_opt="adam", meta_lr=1e-3, method="sama", unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example),
                                base_opt=joptim.adam(1e-3, eps=1e-3), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example),
                               base_opt=optim.adam(1e-3, eps=1e-3), **kw)
    _run_pair(jlearner, tlearner, _lm_warm_batches(tm.cfg), steps=1)


def _assert_states_equal(tstate, jstate):
    jflat = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    names, leaves = tree.flatten_with_keys(convert.state_to_numpy(tstate))
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    for name, got, (_, want) in zip(names, leaves, jflat):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_moe_checkpoint_crosses_packages_bitwise(tmp_path):
    """A port learner on qwen2-moe smoke after one meta step (its Adam
    moments over the (L, E, D, F) expert stacks nonzero) restores into the
    JAX learner, and the JAX learner's save of it back into the port,
    every leaf exactly equal."""
    jm, jparams, tm, _ = _pair("qwen2-moe-a2.7b")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="sama",
              unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example), **kw)
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    base, meta = _lm_warm_batches(tm.cfg)(0)
    tlearner.step(tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta))
    nu = tlearner.state.base_opt_state.nu["layers"]["moe"]["experts"]["down"]
    assert nu.shape[:2] == (2, 4) and bool(torch.any(nu != 0))
    jstate = jlearner.load(tlearner.save(str(tmp_path / "torch_ck")))
    _assert_states_equal(tlearner.state, jstate)
    back = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example), **kw)
    back.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    _assert_states_equal(back.load(jlearner.save(str(tmp_path / "jax_ck"))), jstate)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_train_cli_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import train

    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--log-every",
                "1", "--batch", "2", "--seq", "16"])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in rows for v in r.values())


@pytest.mark.parametrize("arch", NEW)
def test_serve_cli_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve as cli

    cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
              "--prompt-len", "9", "--gen", "4", "--slots", "2", "--page-size", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["statuses"] == {"ok": 3} and out["arch"] == arch and out["device"] == "cpu"


@pytest.mark.parametrize("arch", SERVED)
def test_clis_raise_without_a_card(arch, monkeypatch):
    from repro_torch.launch import serve as cli
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--arch", arch, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--arch", arch, "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.get_smoke_config(arch))
    assert cm.resolve_device("cpu").type == "cpu"
