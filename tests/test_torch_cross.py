"""Cross-attention and the two families that use it, against the JAX
package: whisper-small (``audio``: a bidirectional encoder over the
batch's ``frames``, a causal decoder whose layers cross-attend to it) and
llama-3.2-vision-90b (``vlm``: groups of self layers, each followed by a
gated cross layer over the projected ``patches``), each on its ``SMOKE``,
on the JAX weights carried over by ``repro_torch.convert`` and inputs from
numpy seeds:

* the config copies field for field, and the full-size parameter and
  cache trees path for path and shape for shape (``jax.eval_shape``
  against the port's ``meta`` device);
* ``sinusoidal_pos``, ``cross_attention`` (over ``memory``, also of
  ``kv_dim`` columns and in another dtype than x, and over ``memory_kv``)
  and ``cross_kv`` within f32 1e-5;
* ``forward``, ``lm_loss``, ``per_example`` and the gradient in every
  parameter within ``test_torch_model_decode.py``'s 1e-4, on random frames
  and patches, with the vision model's gates drawn nonzero on the JAX
  side before the carry-over (at init they are 0 and the cross layers the
  identity);
* block prefill, then one-token decode at per-lane positions, with
  ``cross_kv`` filled from random memory on both sides: logits and every
  cache leaf within 1e-4;
* the executor's tokens equal to the port's serial path and to the JAX
  executor's, its memory accounting equal to JAX's; served, the
  cross-attention output is exactly 0 in both packages, since serving
  never fills ``cross_kv`` (ROADMAP queue 3, the reference's fact);
* one SAMA meta step through ``MetaLearner`` from one state, at
  ``test_torch_sama.py``'s tolerances (warm rows, base Adam eps 1e-3);
* the vision learner's checkpoint across the packages, bitwise;
* the train and serve CLIs on the CPU, and their refusal without a card.

The kernels at whisper's and the vision model's shapes are held against
their plain versions on the card in ``tests/test_torch_kernels_cuda.py``
(a file without JAX) and in ``chip_smoke.py``'s phases 3-4.
"""

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
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch import api, configs, convert, optim, serve, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

from test_torch_sama import _np_tree, _run_pair  # noqa: E402

ARCHS = ["whisper-small", "llama-3.2-vision-90b"]
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=1e-5, rtol=1e-5)
#: parameters of the JAX package's full-size init under jax.eval_shape
FULL_PARAMS = {"whisper-small": 263_274_240, "llama-3.2-vision-90b": 86.63e9}

_PAIRS = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small models are dominated by many tiny
    ops, whose thread pools spin against the other test workers' on a
    shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    """JAX's model and SMOKE weights (its init jitted, a few seconds
    sooner than op by op) and the port's on the same weights. The vision
    model's gates are drawn nonzero (+-0.3 to 0.9) before the carry-over."""
    if arch not in _PAIRS:
        jm = JaxModel(jconfigs.get_smoke_config(arch))
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
        if jm.cfg.family == "vlm":
            r = np.random.default_rng(5)
            for name in ("gate_attn", "gate_mlp"):
                shape = jparams["cross_layers"][name].shape
                g = r.uniform(0.3, 0.9, shape) * r.choice([-1.0, 1.0], shape)
                jparams["cross_layers"][name] = jnp.asarray(g, jnp.float32)
        tm = Model(configs.get_smoke_config(arch), device="cpu")
        tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
        _PAIRS[arch] = (jm, jparams, tm, tparams)
    return _PAIRS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _modality(cfg, lead, seed):
    """The batch's other input: random frames (audio) or patches (vlm)."""
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        return "frames", r.standard_normal(lead + (cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return "patches", r.standard_normal(lead + (cfg.vision_tokens, cfg.vision_dim)).astype(
        np.float32)


def _batch(cfg, b, s, seed):
    key, x = _modality(cfg, (b,), seed + 1)
    return {"tokens": _tokens(cfg, (b, s), seed), key: x}


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


def _cross_params(jparams, family):
    """The stacked cross-attention weights: whisper's decoder layers',
    the vision model's cross layers'."""
    return jparams["layers"]["xattn"] if family == "audio" else jparams["cross_layers"]["xattn"]


# ---------------------------------------------------------------------------
# configs, trees, the attention functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        a, b = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert a.__dict__ == b.__dict__
        assert a.layer_kinds == b.layer_kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_and_cache_shapes_match(arch):
    jm = JaxModel(jconfigs.get_config(arch))
    tm = Model(configs.get_config(arch), device="meta")
    jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tparams = tm.init(0)
    assert _shapes(tparams) == _shapes(jshape)
    jdt = [str(x.dtype) for x in tree.tree_leaves(jshape)]
    assert [str(x.dtype).split(".")[-1] for x in tree.tree_leaves(tparams)] == jdt
    n = tm.num_params(tparams)
    assert abs(n - FULL_PARAMS[arch]) < 1e-3 * FULL_PARAMS[arch]
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jcache = jax.eval_shape(lambda: jm.init_cache(4, 1024, jdtype))
        tcache = tm.init_cache(4, 1024, dtype, device="meta")
        assert _shapes(tcache) == _shapes(jcache)
        assert all(x.dtype == dtype for x in tree.tree_leaves(tcache))


@pytest.mark.parametrize("seq,d,atol", [(32, 128, 1e-5), (1500, 768, 1500 * 4 * 2.0 ** -23)])
def test_sinusoidal_pos_matches_jax(seq, d, atol):
    """f32 within 1e-5 at the smoke encoder's 32 frames; at whisper's 1,500
    the angle pos / 10000^(2i/d) rounds differently in the two pow
    implementations, by a few ulps of the largest angle, 1,500. bf16 is
    the f32 table rounded."""
    got = cm.sinusoidal_pos(seq, d)
    want = np.asarray(jcm.sinusoidal_pos(seq, d))
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    assert torch.equal(cm.sinusoidal_pos(seq, d, torch.bfloat16), got.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_and_cross_kv_match_jax(arch):
    """One cross layer's weights (layer 0): ``cross_attention`` over memory
    and over ``memory_kv``, ``cross_kv``, within f32 1e-5; memory in bf16
    under f32 queries (K and V projected in bf16, then cast) within the
    reference's bf16 2e-2; and ``init_cross_attn(kv_dim=)`` shapes, with
    attention over memory of that width."""
    jm, jparams, tm, _ = _pair(arch)
    cfg = tm.cfg
    jp = jax.tree_util.tree_map(lambda a: a[0], _cross_params(jparams, cfg.family))
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = r.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    tx, tmem = torch.from_numpy(x), torch.from_numpy(mem)
    want = np.asarray(jattn.cross_attention(cfg, jp, jnp.asarray(x), memory=jnp.asarray(mem)))
    got = attn.cross_attention(cfg, tp, tx, memory=tmem)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    jkv = jattn.cross_kv(cfg, jp, jnp.asarray(mem))
    tkv = attn.cross_kv(cfg, tp, tmem)
    assert tuple(tkv["k"].shape) == (2, 7, cfg.num_kv_heads, cfg.head_dim)
    _assert_tree_close(tkv, jkv, **F32)
    got_kv = attn.cross_attention(cfg, tp, tx, memory_kv=tkv)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(jattn.cross_attention(
        cfg, jp, jnp.asarray(x), memory_kv=jkv)), **F32)
    np.testing.assert_allclose(got_kv.numpy(), got.numpy(), **F32)

    mixed = attn.cross_attention(cfg, tp, tx, memory=tmem.to(torch.bfloat16))
    assert mixed.dtype == torch.float32
    jmixed = jattn.cross_attention(cfg, jp, jnp.asarray(x), memory=jnp.asarray(mem, jnp.bfloat16))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed), atol=2e-2, rtol=2e-2)

    kv_dim = 24
    jw = jattn.init_cross_attn(cfg, jax.random.PRNGKey(4), kv_dim=kv_dim)
    shapes = _shapes(attn.init_cross_attn(cfg, None, device="meta", lead=(3,), kv_dim=kv_dim))
    assert shapes == {k: (3,) + v for k, v in _shapes(jw).items()}
    tw = convert.params_from_jax(_np_tree(jw), device="cpu")
    narrow = r.standard_normal((2, 7, kv_dim)).astype(np.float32)
    np.testing.assert_allclose(
        attn.cross_attention(cfg, tw, tx, memory=torch.from_numpy(narrow)).numpy(),
        np.asarray(jattn.cross_attention(cfg, jw, jnp.asarray(x), memory=jnp.asarray(narrow))),
        **F32)


# ---------------------------------------------------------------------------
# forward, losses, gradients; prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_losses_and_gradient_match_jax(arch):
    jm, jparams, tm, tparams = _pair(arch)
    nb = _batch(tm.cfg, 2, 12, 4)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jlogits, jaux = jax.jit(jm.forward)(jparams, jb)
    tlogits, taux = tm.forward(tparams, tb)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **TOL)
    assert float(taux) == float(jaux) == 0.0
    # the frames or patches reach the logits
    key = "frames" if tm.cfg.family == "audio" else "patches"
    other = tm.forward(tparams, {**tb, key: torch.zeros_like(tb[key])})[0]
    assert float((other - tlogits).abs().max()) > 1e-3
    jpe, tpe = jax.jit(jm.per_example)(jparams, jb), tm.per_example(tparams, tb)
    for name in ("loss", "uncertainty"):
        np.testing.assert_allclose(getattr(tpe, name).detach().numpy(),
                                   np.asarray(getattr(jpe, name)), err_msg=name, **TOL)
    jloss, jgrad = jax.jit(jax.value_and_grad(jm.lm_loss))(jparams, jb)
    theta = tree.tree_map(lambda t: t.detach().clone().requires_grad_(), tparams)
    tloss = tm.lm_loss(theta, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    leaves, paths = tree.tree_flatten(theta)
    grads = torch.autograd.grad(tloss, leaves)
    _assert_tree_close(tree.tree_unflatten(paths, grads), jgrad)
    # every cross-attention weight learns (nonzero gates)
    xattn = _cross_params(tree.tree_unflatten(paths, grads), tm.cfg.family)
    assert all(float(g.abs().max()) > 0 for g in tree.tree_leaves(xattn))


def _filled_caches(jm, jparams, tm, tparams, B, CL, seed):
    """Both packages' f32 caches with ``cross_kv`` from random memory (B,
    M, d_model) through each package's ``cross_kv``, layer by layer."""
    cfg = tm.cfg
    M = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_tokens
    mem = np.random.default_rng(seed).standard_normal((B, M, cfg.d_model)).astype(np.float32)
    jx, tx = _cross_params(jparams, cfg.family), _cross_params(tparams, cfg.family)
    n = jax.tree_util.tree_leaves(jx)[0].shape[0]
    jkv = [jattn.cross_kv(cfg, jax.tree_util.tree_map(lambda a: a[i], jx), jnp.asarray(mem))
           for i in range(n)]
    tkv = [attn.cross_kv(cfg, cm.unstack_layer(tx, i), torch.from_numpy(mem))
           for i in range(n)]
    jc, tc = jm.init_cache(B, CL, jnp.float32), tm.init_cache(B, CL, torch.float32)
    jc["cross_kv"] = {k: jnp.stack([c[k] for c in jkv]) for k in ("k", "v")}
    for k in ("k", "v"):
        tc["cross_kv"][k].copy_(torch.stack([c[k] for c in tkv]))
    _assert_tree_close(tc, jc, **F32)
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_lane_decode_match_jax(arch):
    """Block prefill of B=3 prompts from position 0, then three one-token
    steps at per-lane positions, each feeding the cache forward."""
    jm, jparams, tm, tparams = _pair(arch)
    B, P, CL = 3, 10, 24
    jc, tc = _filled_caches(jm, jparams, tm, tparams, B, CL, 8)
    toks = _tokens(tm.cfg, (B, P), 1)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(toks), jnp.asarray(0, jnp.int32))
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


_SERVE = dict(lens=[5, 9, 3, 12, 7, 1], gens=[6, 4, 8, 5, 7, 1],
              cfg=dict(slots=2, page_size=4, max_len=32, max_new_tokens=8))
_SERVED = {}


def _served(arch):
    """Both executors over _SERVE's requests, once per arch, with the max
    |x| of every cross-attention output recorded in both packages (JAX's
    read out of its jitted steps by ``jax.debug.callback``; its executor
    gets a fresh model, whose jitted steps trace the recorder). Returns
    (prompts, (executor, ids, stats), (JAX's), {"torch": [...], "jax":
    [...]})."""
    if arch not in _SERVED:
        jm, jparams, tm, tparams = _pair(arch)
        seen = {"torch": [], "jax": []}
        t_cross, j_cross = attn.cross_attention, jattn.cross_attention

        def t_record(*a, **kw):
            out = t_cross(*a, **kw)
            seen["torch"].append(float(out.abs().max()))
            return out

        def j_record(*a, **kw):
            out = j_cross(*a, **kw)
            jax.debug.callback(lambda m: seen["jax"].append(float(m)), jnp.max(jnp.abs(out)))
            return out

        attn.cross_attention, jattn.cross_attention = t_record, j_record
        try:
            prompts = [_tokens(tm.cfg, (L,), i) for i, L in enumerate(_SERVE["lens"])]
            runs = []
            for pkg, model in ((serve, tm), (jserve, JaxModel(jm.cfg))):
                ex = pkg.ServeExecutor(model, tparams if pkg is serve else jparams,
                                       pkg.ServeConfig(**_SERVE["cfg"]))
                ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, _SERVE["gens"])]
                runs.append((ex, ids, ex.run()))
        finally:
            attn.cross_attention, jattn.cross_attention = t_cross, j_cross
        _SERVED[arch] = (prompts, runs[0], runs[1], seen)
    return _SERVED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batched_matches_serial_and_jax(arch):
    """Mixed-length staggered arrivals with early finishers at slots=2:
    the port's continuous batching gives the port's serial greedy tokens
    and the JAX executor's, and its memory accounting (allocated and peak
    bytes: the pages, the per-slot ``cross_kv`` store, the table) JAX's."""
    _, _, tm, tparams = _pair(arch)
    prompts, (ex, ids, stats), (jex, jids, jstats), _ = _served(arch)
    for rid, jid, p, g in zip(ids, jids, prompts, _SERVE["gens"]):
        ref = serve.greedy_generate(tm, tparams, torch.from_numpy(p[None]), g, 32)[0].tolist()
        assert ex.results[rid].status == serve.STATUS_OK
        assert ex.results[rid].tokens == ref == jex.results[jid].tokens
    assert stats.completed == len(prompts) and stats.errors == 0
    assert stats.memory == jstats.memory
    spec = ex.batcher.cache.spec
    names = ["/".join(spec.treedef[i]) for i in spec.state_idx]
    assert names == ["cross_kv/k", "cross_kv/v"]
    assert all(spec.leaves[i].batch_axis == 1 for i in spec.state_idx)


@pytest.mark.parametrize("arch", ARCHS)
def test_served_cross_attention_is_exactly_zero(arch):
    """The reference's serving never fills ``cross_kv`` (nothing in
    ``src/repro/`` calls ``attention.cross_kv``; the batcher builds its
    caches with ``init_cache``, whose cross K/V are zeros), so every served
    request cross-attends to zero keys and values: uniform weights over
    zero values. Every cross-attention output of a serving run is exactly
    0 in both packages, and the state store holds zeros at the end."""
    _, (ex, _, _), (jex, _, _), seen = _served(arch)
    assert len(seen["torch"]) > 0 and len(seen["jax"]) > 0
    assert set(seen["torch"]) == set(seen["jax"]) == {0.0}
    for x in ex.batcher.cache.states:
        assert not torch.any(x)
    for x in jex.batcher.cache.states:
        assert not np.any(np.asarray(x))


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


def _warm_batches(cfg, k=2, b=4, s=16):
    """The K base batches are row permutations of the meta batch's
    sequences and their frames or patches (warm Adam rows, as
    tests/test_torch_sama.py explains)."""
    def batches(i):
        r = np.random.default_rng(11 + i)
        toks = r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        key, x = _modality(cfg, (b,), 40 + i)
        perms = np.stack([r.permutation(b) for _ in range(k)])
        return {"tokens": toks[perms], key: x[perms]}, {"tokens": toks, key: x}
    return batches


@pytest.mark.parametrize("arch", ARCHS)
def test_sama_meta_step_matches_jax(arch):
    jm, jparams, tm, _ = _pair(arch)
    kw = dict(meta_opt="adam", meta_lr=1e-3, method="sama", unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example),
                                base_opt=joptim.adam(1e-3, eps=1e-3), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example),
                               base_opt=optim.adam(1e-3, eps=1e-3), **kw)
    _run_pair(jlearner, tlearner, _warm_batches(tm.cfg), steps=1)


def _assert_states_equal(tstate, jstate):
    jflat = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    names, leaves = tree.flatten_with_keys(convert.state_to_numpy(tstate))
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    for name, got, (_, want) in zip(names, leaves, jflat):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_vision_checkpoint_crosses_packages_bitwise(tmp_path):
    """The vision tree's doubly stacked ``self_groups`` (groups, layers,
    ...), its cross layers' f32 gates (one per group) and the projector
    through a port learner's save, the JAX learner's load and back, after
    one meta step (the gates moved, the Adam moments nonzero), every leaf
    exactly equal."""
    jm, jparams, tm, _ = _pair("llama-3.2-vision-90b")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="sama",
              unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example), **kw)
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    gate0 = tlearner.state.theta["cross_layers"]["gate_attn"].clone()
    base, meta = _warm_batches(tm.cfg)(0)
    tlearner.step(tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta))
    theta = tlearner.state.theta
    assert theta["cross_layers"]["gate_attn"].dtype == torch.float32
    assert not torch.equal(theta["cross_layers"]["gate_attn"], gate0)
    nu = tlearner.state.base_opt_state.nu["self_groups"]["attn"]["wq"]
    assert nu.shape[:2] == (1, 1) and bool(torch.any(nu != 0))
    jstate = jlearner.load(tlearner.save(str(tmp_path / "torch_ck")))
    _assert_states_equal(tlearner.state, jstate)
    back = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example), **kw)
    back.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    _assert_states_equal(back.load(jlearner.save(str(tmp_path / "jax_ck"))), jstate)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_smoke_on_cpu(arch, capsys):
    """Zero frames or patches, as the reference's CLI feeds them."""
    from repro_torch.launch import train

    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--log-every",
                "1", "--batch", "2", "--seq", "16"])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    cfg = configs.get_smoke_config(arch)
    b = train.make_batch_fn(cfg, 16, torch.device("cpu"), np.random.default_rng(0))(2, 3)
    key, (m, w) = (("frames", (cfg.encoder_seq, cfg.d_model)) if cfg.family == "audio"
                   else ("patches", (cfg.vision_tokens, cfg.vision_dim)))
    assert tuple(b[key].shape) == (3, 2, m, w) and not torch.any(b[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve as cli

    cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
              "--prompt-len", "9", "--gen", "4", "--slots", "2", "--page-size", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["statuses"] == {"ok": 3} and out["arch"] == arch and out["device"] == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
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
