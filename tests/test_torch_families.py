"""The port's moe family and dense family with MLA, the recurrent ssm and
hybrid families, and the configs that join with them (qwen2-moe-a2.7b,
kimi-k2-1t-a32b, minicpm3-4b, gemma2-9b, gemma3-27b, rwkv6-1.6b,
zamba2-7b), against the JAX package on each config's ``SMOKE``, on the
JAX weights carried over by ``repro_torch.convert`` and tokens from one
numpy seed:

* the config copies field for field, and the full-size parameter and
  cache trees path for path and shape for shape (``jax.eval_shape``
  against the port's ``meta`` device);
* ``forward`` logits and aux, ``lm_loss`` (which adds the MoE aux),
  ``per_example`` (which drops it) and the gradient of ``lm_loss`` in
  every parameter, within ``test_torch_model_decode.py``'s 1e-4;
* block prefill (the recurrent families: scan prefill at ragged lane
  lengths), then one-token decode at per-lane positions: logits and every
  cache leaf within 1e-4;
* the recurrent caches' state leaves in the paged cache, the refusal of
  block prefill for them, scan prefill of a padded prompt equal to the
  unpadded one, and their decode against the training forward at the
  reference's 2e-2;
* continuous batching token for token equal to the port's serial path
  and to the JAX executor, and the executor's memory accounting equal to
  JAX's (qwen2-moe, minicpm3, rwkv6, zamba2);
* one SAMA meta step through ``MetaLearner`` from one state, at
  ``test_torch_sama.py``'s tolerances, with warm rows and base Adam eps
  1e-3 (the same four);
* an MoE learner's and a hybrid learner's checkpoint across the packages,
  bitwise;
* the train and serve CLIs on the CPU for the new archs, and their
  refusal without a card.
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
from repro_torch import api, configs, convert, optim, serve, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

from test_torch_sama import _np_tree, _run_pair  # noqa: E402

RECURRENT = ["rwkv6-1.6b", "zamba2-7b"]
NEW = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "minicpm3-4b", "gemma2-9b", "gemma3-27b"] + RECURRENT
SERVED = ["qwen2-moe-a2.7b", "minicpm3-4b"] + RECURRENT
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
    """Every arch of the JAX registry, of every family: this file's, and
    whisper-small and llama-3.2-vision-90b (tests/test_torch_cross.py)."""
    assert configs.list_archs() == jconfigs.list_archs() == sorted(
        NEW + ["gemma3-1b", "bert-base", "whisper-small", "llama-3.2-vision-90b"])
    for name in configs.list_archs():
        assert configs.get_config(name).family in ("dense", "moe", "encoder", "ssm", "hybrid",
                                                   "audio", "vlm")


@pytest.mark.parametrize("arch", NEW)
def test_config_copy_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        a, b = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert a.__dict__ == b.__dict__
        assert a.layer_kinds == b.layer_kinds


# parameters from the JAX package's init under jax.eval_shape
FULL_PARAMS = {"qwen2-moe-a2.7b": 14.00e9, "kimi-k2-1t-a32b": 1027e9, "minicpm3-4b": 4.07e9,
               "gemma2-9b": 9.24e9, "gemma3-27b": 27.0e9, "rwkv6-1.6b": 1.4499e9,
               "zamba2-7b": 6.6364e9}


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


# ---------------------------------------------------------------------------
# forward, losses, gradients; prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_forward_losses_and_gradient_match_jax(arch):
    jm, jparams, tm, tparams = _pair(arch)
    # a recurrent forward takes whole chunks (rwkv6 SMOKE: 8 tokens)
    toks = _tokens(tm.cfg, (2, 16 if arch in RECURRENT else 12), 4)
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
    steps at per-lane positions, each feeding the cache forward. A
    recurrent family prefills by each package's scan (``chunked_prefill(
    mode="scan")``) at ragged lane lengths 10, 6 and 8, and decodes on from
    there."""
    jm, jparams, tm, tparams = _pair(arch)
    B, P, CL = 3, 10, 24
    toks = _tokens(tm.cfg, (B, P), 1)
    tc = tm.init_cache(B, CL, torch.float32)
    pos = np.array([10, 6, 8], np.int32)
    if arch in RECURRENT:
        from repro.serve import prefill as jprefill
        from repro_torch.serve import prefill as tprefill

        jl, jc = jprefill.chunked_prefill(jm, jparams, jnp.asarray(toks),
                                          jm.init_cache(B, CL, jnp.float32),
                                          lengths=jnp.asarray(pos), mode="scan")
        tl, same = tprefill.chunked_prefill(tm, tparams, torch.from_numpy(toks).long(), tc,
                                            lengths=torch.from_numpy(pos), mode="scan")
    else:
        jl, jc = jm.decode_step(jparams, jm.init_cache(B, CL, jnp.float32), jnp.asarray(toks),
                                jnp.asarray(0, jnp.int32))
        tl, same = tm.decode_step(tparams, tc, torch.from_numpy(toks).long(), 0)
    assert same is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc)
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


def test_reference_padded_prefill_departs_where_padding_drops_a_prompt_choice(monkeypatch):
    """ROADMAP queue 3, a fault of the reference pinned here: the JAX
    package's ``ContinuousBatcher.admit`` right-pads the prompt to a page
    multiple (``src/repro/serve/batcher.py:197-206``), and a MoE layer routes
    the padding with the prompt. ``capacity = max(int(cf K G / E), 4)`` is
    then taken at the padded length and the padding's first choices take
    capacity slots ahead of the prompt's second choices (choice-major
    positions), so the padded prefill drops prompt choices that the serial
    path keeps. The port prefills the P prompt tokens unpadded.

    qwen2-moe SMOKE (E 4, K 2, cf 1.25), P 5 at page 8 (capacity 5 padded,
    4 unpadded): the padded routing drops two of the prompt's choices that
    the unpadded routing keeps (the port's ``moe.route``, which equals the
    reference's, tests/test_torch_moe.py). The first-token logits of JAX's
    executor part from JAX's ``greedy_generate`` by more than 0.1; the
    port's executor, the port's ``greedy_generate`` and JAX's agree within
    1e-4, and so do their tokens. With random weights the last prompt
    token's own embedding sets each argmax, so no served token flips here:
    JAX's executor serves the same tokens from other logits."""
    from repro.serve import prefill as jprefill
    from repro_torch.models import moe
    from repro_torch.serve import prefill as tprefill

    jm, jparams, tm, tparams = _pair("qwen2-moe-a2.7b")
    P, page, gen = 5, 8, 6
    prompt = _tokens(tm.cfg, (P,), 31)
    assert (moe.moe_capacity(tm.cfg, page), moe.moe_capacity(tm.cfg, P)) == (5, 4)

    keeps, route = [], moe.route

    def recording(cfg, probs, capacity):
        out = route(cfg, probs, capacity)
        keeps.append(out[1][0, :, :P])
        return out

    padded = np.zeros(page, np.int32)
    padded[:P] = prompt
    with monkeypatch.context() as m:
        m.setattr(moe, "route", recording)
        for toks in (prompt, padded):
            tm.forward(tparams, {"tokens": torch.from_numpy(toks[None])})
    unpadded_keep, padded_keep = keeps[:2], keeps[2:]
    assert sum(int((a & ~b).sum()) for a, b in zip(unpadded_keep, padded_keep)) == 2

    lasts = []
    for mod in (jprefill, tprefill):
        real = mod.chunked_prefill

        def recorded(*args, _real=real, **kw):
            last, cache = _real(*args, **kw)
            lasts.append(np.asarray(last, np.float32).copy())
            return last, cache

        monkeypatch.setattr(mod, "chunked_prefill", recorded)
    scfg = dict(slots=2, page_size=page, max_len=32, max_new_tokens=gen)
    t_serial = serve.greedy_generate(tm, tparams, torch.from_numpy(prompt[None]), gen,
                                     32)[0].tolist()
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(**scfg))
    rid = ex.submit(prompt, max_new_tokens=gen)
    ex.run()
    j_serial = [int(t) for t in jserve.greedy_generate(jm, jparams, jnp.asarray(prompt[None]),
                                                        gen, 32)[0]]
    jex = jserve.ServeExecutor(jm, jparams, jserve.ServeConfig(**scfg))
    jid = jex.submit(prompt, max_new_tokens=gen)
    jex.run()
    t_serial_last, t_exec_last, j_serial_last, j_exec_last = lasts
    np.testing.assert_allclose(t_exec_last, t_serial_last, **TOL)
    np.testing.assert_allclose(t_serial_last, j_serial_last, **TOL)
    assert np.max(np.abs(j_exec_last - j_serial_last)) > 0.1
    assert ex.results[rid].tokens == t_serial == j_serial
    assert jex.results[jid].tokens == j_serial


def test_paged_cache_pages_the_mla_and_moe_leaves():
    """build_spec finds one batch and one time axis in MLA's 3-D ckv and
    krope leaves and in both stacks of kimi-k2's cache."""
    for arch, names in (("minicpm3-4b", ["kv/ckv", "kv/krope"]),
                        ("kimi-k2-1t-a32b", ["dense_kv/k", "dense_kv/v", "kv/k", "kv/v"])):
        tm = Model(configs.get_smoke_config(arch), device="cpu")
        spec = serve.build_spec(tm, page_size=4, dtype=torch.float32)
        assert ["/".join(p) for p in spec.treedef] == names
        assert all((ls.batch_axis, ls.time_axis) == (1, 2) for ls in spec.leaves)


def test_paged_cache_holds_the_recurrent_state_per_slot():
    """build_spec, as the reference's (tests/test_serve.py): rwkv6's cache is
    state alone (nothing paged, no bytes per token, refused with
    ``allow_unpaged=False``); zamba2's pages the shared block's K/V and holds
    the Mamba state per slot, batch axis 2 in the groups' (G, k, B, ...)
    leaves. The store is ``slots`` lanes of each state leaf, counted in the
    allocated bytes."""
    tm = Model(configs.get_smoke_config("rwkv6-1.6b"), device="cpu")
    spec = serve.build_spec(tm, page_size=4, dtype=torch.float32)
    assert spec.paged_idx == () and len(spec.state_idx) == 3
    assert spec.token_view_bytes() == 0
    assert [ls.batch_axis for ls in spec.leaves] == [1, 1, 1]
    with pytest.raises(ValueError, match="nothing to page"):
        serve.build_spec(tm, page_size=4, dtype=torch.float32, allow_unpaged=False)
    pc = serve.PagedCache(tm, slots=3, page_size=4, max_len=16, dtype=torch.float32)
    assert pc.pools == [] and [tuple(x.shape) for x in pc.states] == [
        (2, 3, 4, 32, 32), (2, 3, 128), (2, 3, 128)]
    assert pc.allocated_bytes() == spec.state_bytes(3) + pc.table.nbytes

    tm = Model(configs.get_smoke_config("zamba2-7b"), device="cpu")
    spec = serve.build_spec(tm, page_size=4, dtype=torch.bfloat16)
    names = ["/".join(p) for p in spec.treedef]
    assert names == ["attn_kv/k", "attn_kv/v", "groups/conv", "groups/ssm", "head/conv",
                     "head/ssm"]
    assert spec.paged_idx == (0, 1) and spec.state_idx == (2, 3, 4, 5)
    assert [(ls.batch_axis, ls.time_axis) for ls in spec.leaves] == [
        (1, 2), (1, 2), (2, None), (2, None), (1, None), (1, None)]
    assert spec.token_view_bytes() == 2 * 2 * 64 * 2  # k and v: G 1 x KV 2 x Dh 64, bf16


def test_state_store_commits_only_the_active_lanes():
    """gather_dense hands the decode step the state store itself, which the
    step advances in place for every lane. What an inactive lane's step
    writes into its free slot's row is never read: write_prefill writes
    the whole row when the slot is taken again, and leaves the other
    lanes' rows as they were."""
    tm = Model(configs.get_smoke_config("zamba2-7b"), device="cpu")
    pc = serve.PagedCache(tm, slots=2, page_size=4, max_len=16, dtype=torch.float32)
    pc.set_len(pc.alloc_slot(), 3)
    view = pc.table_view(4)
    dense = serve.gather_dense(pc.spec, pc.pools, pc.states, view)
    names = ["/".join(pc.spec.treedef[i]) for i in pc.spec.state_idx]
    by_name = dict(zip(names, pc.states))
    axis = {"groups/ssm": 2, "groups/conv": 2, "head/ssm": 1, "head/conv": 1}
    for name in names:
        group, leaf = name.split("/")
        assert dense[group][leaf] is by_name[name]
        # lane 0 live; lane 1 a free slot's row, which an inactive step advanced
        by_name[name].select(axis[name], 0).fill_(2.0)
        by_name[name].select(axis[name], 1).fill_(float("nan"))
    prefill = tm.init_cache(1, 4, torch.float32)
    for name in names:
        group, leaf = name.split("/")
        prefill[group][leaf].fill_(5.0)
    assert pc.alloc_slot() == 1
    pc.write_prefill(1, prefill, 3)
    for name in names:
        assert torch.all(by_name[name].select(axis[name], 1) == 5.0), name
        assert torch.all(by_name[name].select(axis[name], 0) == 2.0), name


@pytest.mark.parametrize("arch", RECURRENT)
def test_block_prefill_is_refused_for_recurrent_families(arch):
    _, _, tm, tparams = _pair(arch)
    prompt = torch.from_numpy(_tokens(tm.cfg, (1, 4), 0)).long()
    with pytest.raises(ValueError, match="order-unsafe"):
        serve.chunked_prefill(tm, tparams, prompt, tm.init_cache(1, 8, torch.float32),
                              mode="block")
    with pytest.raises(ValueError, match="recurrent: decode_step advances one token"):
        tm.decode_step(tparams, tm.init_cache(1, 8, torch.float32), prompt, 0)
    from repro_torch.serve import prefill

    assert prefill.default_mode(tm.cfg) == "scan"


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_the_training_forward(arch):
    """Token by token from an empty cache, the decode's logits equal the
    chunked forward's over the same prefix, at the reference's 2e-2
    (tests/test_arch_smoke.py)."""
    _, _, tm, tparams = _pair(arch)
    seq = 16
    toks = torch.from_numpy(_tokens(tm.cfg, (1, seq), 9)).long()
    full, _ = tm.forward(tparams, {"tokens": toks})
    cache = tm.init_cache(1, seq, torch.float32)
    steps = [tm.decode_step(tparams, cache, toks[:, t:t + 1], t)[0][:, 0] for t in range(seq)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.detach().numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", RECURRENT)
def test_scan_prefill_of_a_padded_prompt_equals_the_unpadded_one(arch):
    """JAX's admit right-pads the prompt to a page multiple and gates the
    scan at its length (``src/repro/serve/batcher.py:197-206``); the port
    prefills the P tokens unpadded. The two reach the same state and
    first-token logits: the port's padded and unpadded scans bitwise, and
    JAX's padded scan within 1e-4."""
    from repro.serve import prefill as jprefill

    jm, jparams, tm, tparams = _pair(arch)
    P, page = 5, 8
    prompt = _tokens(tm.cfg, (1, P), 21)
    padded = np.zeros((1, page), np.int32)
    padded[:, :P] = prompt
    caches, lasts = [], []
    for toks, lengths in ((prompt, None), (padded, torch.tensor([P]))):
        cache = tm.init_cache(1, page, torch.float32)
        last, _ = serve.chunked_prefill(tm, tparams, torch.from_numpy(toks).long(), cache,
                                        lengths=lengths)
        caches.append(cache)
        lasts.append(last)
    assert torch.equal(lasts[0], lasts[1])
    for a, b in zip(tree.tree_leaves(caches[0]), tree.tree_leaves(caches[1])):
        assert torch.equal(a, b)
    jlast, jcache = jprefill.chunked_prefill(jm, jparams, jnp.asarray(padded),
                                             jm.init_cache(1, page, jnp.float32),
                                             lengths=jnp.asarray([P], jnp.int32), mode="scan")
    np.testing.assert_allclose(lasts[0].numpy(), np.asarray(jlast), **TOL)
    _assert_tree_close(caches[0], jcache)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_a_recurrent_cache_mid_sequence(arch, dtype):
    """A JAX cache after three decode steps (zamba2: the (G, k, B, ...)
    groups' state, the head's, the shared block's K/V; rwkv6: S in f32 and
    the token-shift rows in the cache dtype) crosses by
    ``convert.params_from_jax`` with its dtypes, and the port's next two
    steps from it give JAX's logits and cache (f32 within 1e-4; bf16
    within the reference's 2e-2)."""
    jm, jparams, tm, tparams = _pair(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    toks = _tokens(tm.cfg, (2, 5), 3)
    jc = jm.init_cache(2, 8, jdt)
    for t in range(3):
        _, jc = jm.decode_step(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
    tc = convert.params_from_jax(_np_tree(jc), device="cpu")
    assert [x.dtype for x in tree.tree_leaves(tc)] == [
        tdt if x.dtype == jdt else torch.float32 for x in tree.tree_leaves(jc)]
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for t in range(3, 5):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(t, jnp.int32))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        _assert_tree_close(tc, jc, **tol)


@pytest.mark.parametrize("arch", RECURRENT)
def test_executor_memory_stats_match_jax(arch):
    """The continuous-batching run's cache accounting (allocated and peak
    bytes: pools, state store and page table; growth events, buckets)
    equals the JAX executor's on the same requests."""
    jm, jparams, tm, tparams = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = [_tokens(tm.cfg, (int(n),), i) for i, n in enumerate(rng.integers(2, 13, 6))]
    scfg = dict(slots=3, page_size=4, max_len=24, max_new_tokens=4)
    stats = []
    for pkg, model, params in ((serve, tm, tparams), (jserve, jm, jparams)):
        ex = pkg.ServeExecutor(model, params, pkg.ServeConfig(**scfg))
        for p in prompts:
            ex.submit(p, max_new_tokens=4)
        stats.append(ex.run().memory)
    assert stats[0] == stats[1]


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


def test_hybrid_checkpoint_crosses_packages_bitwise(tmp_path):
    """zamba2's doubly stacked ``mamba_groups`` (groups, blocks, ...) and its
    shared block through a port learner's save, the JAX learner's load and
    back, after one meta step (the Adam moments nonzero), every leaf
    exactly equal."""
    jm, jparams, tm, _ = _pair("zamba2-7b")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="sama",
              unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example), **kw)
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    base, meta = _lm_warm_batches(tm.cfg)(0)
    tlearner.step(tree.tree_map(torch.from_numpy, base), tree.tree_map(torch.from_numpy, meta))
    nu = tlearner.state.base_opt_state.nu["mamba_groups"]["mamba"]["in_proj"]
    assert nu.shape[:2] == (1, 2) and bool(torch.any(nu != 0))
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
