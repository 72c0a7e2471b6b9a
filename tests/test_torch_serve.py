"""The port's serving stack (``repro_torch.serve``): queue and paged-cache
cases mirrored from tests/test_serve.py, and the pin: the port's
continuous batching, the port's serial ``greedy_generate`` and the JAX
``ServeExecutor`` give the same tokens for mixed-length staggered prompts
with early finishers, on the JAX smoke weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import configs, convert, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402


class FakeClock:
    """Deterministic auto-advancing clock for deadline tests."""

    def __init__(self, dt=0.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def smoke():
    jm = JaxModel(jconfigs.get_smoke_config("gemma3-1b"))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(configs.get_smoke_config("gemma3-1b"), device="cpu")
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                      device="cpu")
    return jm, jparams, tm, tparams


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# queue
# ---------------------------------------------------------------------------


def test_queue_fifo_and_overflow_shed():
    q = serve.RequestQueue(max_depth=2, clock=FakeClock())
    r1 = q.submit({"a": 1})
    r2 = q.submit({"a": 2})
    with pytest.raises(serve.QueueFull) as ei:
        q.submit({"a": 3})
    assert ei.value.event.reason == serve.STATUS_SHED_OVERFLOW
    assert [r.id for r in q.pop(5)] == [r1.id, r2.id]
    st = q.stats()
    assert (st.submitted, st.admitted, st.shed_overflow) == (3, 2, 1)
    assert len(q.drain_shed()) == 1 and not q.drain_shed()
    assert len(r1.trace_id) == 16 and r1.trace_id != r2.trace_id


def test_queue_deadline_shed_on_pop():
    clock = FakeClock()
    q = serve.RequestQueue(max_depth=8, default_timeout_s=5.0, clock=clock)
    q.submit({"a": 1})
    keeper = q.submit({"a": 2}, timeout_s=100.0)
    clock.t = 50.0
    assert [r.id for r in q.pop(5)] == [keeper.id]
    assert q.stats().shed_deadline == 1
    assert q.drain_shed()[0].reason == serve.STATUS_SHED_DEADLINE


def test_queue_close_rejects():
    q = serve.RequestQueue(max_depth=2)
    q.close()
    with pytest.raises(serve.QueueClosed):
        q.submit({})


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def test_build_spec_finds_the_time_axis(smoke):
    _, _, tm, _ = smoke
    spec = serve.build_spec(tm, page_size=4, dtype=torch.float32)
    cfg = tm.cfg
    # k and v of (L, B, T, KV, Dh): batch axis 1, time axis 2
    assert [(ls.batch_axis, ls.time_axis) for ls in spec.leaves] == [(1, 2), (1, 2)]
    assert spec.token_view_bytes() == 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4


def test_paged_cache_allocator(smoke):
    _, _, tm, _ = smoke
    pc = serve.PagedCache(tm, slots=3, page_size=4, max_len=32, dtype=torch.float32)
    s0 = pc.alloc_slot()
    pc.set_len(s0, 10)  # 3 pages
    s1 = pc.alloc_slot()
    pc.set_len(s1, 4)  # 1 page
    assert pc.live_tokens() == 14
    assert list(pc.qo_indptr()) == [0, 10, 14, 14]
    used = set(pc.table[s0, :3]) | {pc.table[s1, 0]}
    assert len(used) == 4 and 0 not in used  # page 0 is the trash page
    base = pc.allocated_bytes()
    pc.free(s0)
    s2 = pc.alloc_slot()
    pc.set_len(s2, 12)  # reuses freed pages: no growth
    assert pc.allocated_bytes() == base
    with pytest.raises(serve.PagedCacheError):
        pc.set_len(s2, 33)  # > max_len
    pc.free(s1)
    pc.free(s2)
    assert pc.free_slot_count() == 3 and pc.live_tokens() == 0


def test_paged_cache_grows_and_respects_max_pages(smoke):
    _, _, tm, _ = smoke
    pc = serve.PagedCache(tm, slots=2, page_size=4, max_len=16, dtype=torch.float32,
                          initial_pages=1, max_pages=3)
    s0 = pc.alloc_slot()
    pc.set_len(s0, 8)  # needs 2 pages, pool has 1 free -> grow
    assert pc.grow_events == 1 and pc.pools[0].shape[0] == 3
    s1 = pc.alloc_slot()
    with pytest.raises(serve.PagedCacheError):
        pc.set_len(s1, 8)  # pool capped at max_pages=3 (incl. trash)


def test_paged_allocation_below_dense(smoke):
    _, _, tm, _ = smoke
    pc = serve.PagedCache(tm, slots=4, page_size=8, max_len=128, dtype=torch.float32)
    for n in (10, 24, 7, 40):
        pc.set_len(pc.alloc_slot(), n)
    dense = serve.dense_cache_bytes(tm, 4, 128, torch.float32)
    assert pc.allocated_bytes() < dense and pc.peak_bytes < dense


def test_gather_scatter_round_trip(smoke):
    """A token scattered into its page reads back through the gathered
    view at its position; inactive lanes write only the trash page."""
    _, _, tm, _ = smoke
    pc = serve.PagedCache(tm, slots=2, page_size=4, max_len=16, dtype=torch.float32)
    s0 = pc.alloc_slot()
    pc.set_len(s0, 6)
    view = pc.table_view(8)
    dense = serve.gather_dense(pc.spec, pc.pools, view)
    assert dense["kv"]["k"].shape == (tm.cfg.num_layers, 2, 8, 1, tm.cfg.head_dim)
    dense["kv"]["k"][:, 0, 6] = 1.5
    dense["kv"]["k"][:, 1, 0] = 7.0  # inactive lane 1
    pos = torch.tensor([6, 0])
    serve.scatter_token(pc.spec, pc.pools, dense, view, pos, torch.tensor([True, False]))
    again = serve.gather_dense(pc.spec, pc.pools, view)
    assert torch.all(again["kv"]["k"][:, 0, 6] == 1.5)
    assert torch.all(pc.pools[0][0, 0] == 7.0)  # trash page 0, offset 0


def test_decode_buckets_and_hbm_budget(smoke):
    _, _, tm, _ = smoke
    spec = serve.build_spec(tm, page_size=4, dtype=torch.float32)
    cfg = serve.ServeConfig(slots=2, page_size=4, max_len=32)
    assert serve.decode_buckets(spec, cfg) == (4, 8, 16, 32)
    per_token = spec.token_view_bytes() * cfg.slots
    ok = serve.ServeConfig(slots=2, page_size=4, max_len=32, hbm_budget_bytes=32 * per_token)
    assert serve.decode_buckets(spec, ok) == (4, 8, 16, 32)
    with pytest.raises(ValueError, match="hbm_budget"):
        serve.decode_buckets(spec, serve.ServeConfig(
            slots=2, page_size=4, max_len=32, hbm_budget_bytes=8 * per_token))


# ---------------------------------------------------------------------------
# prefill, greedy, continuous batching
# ---------------------------------------------------------------------------


def test_greedy_generate_matches_jax(smoke):
    jm, jparams, tm, tparams = smoke
    B, P, gen, CL = 2, 9, 6, 16
    prompt = np.stack([_prompt(tm.cfg, P, seed=i) for i in range(B)])
    ref = np.asarray(jserve.greedy_generate(jm, jparams, jnp.asarray(prompt), gen, CL))
    got = serve.greedy_generate(tm, tparams, torch.from_numpy(prompt), gen, CL)
    assert got.shape == (B, gen) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_block_prefill_padded_lengths(smoke):
    """Right-padded block prefill takes the logits at lengths - 1."""
    _, _, tm, tparams = smoke
    p = _prompt(tm.cfg, 7, seed=3)
    padded = np.zeros((1, 12), np.int64)
    padded[0, :7] = p
    last, _ = serve.chunked_prefill(tm, tparams, torch.from_numpy(padded),
                                    tm.init_cache(1, 12, torch.float32),
                                    lengths=torch.tensor([7]))
    exact, _ = serve.chunked_prefill(tm, tparams, torch.from_numpy(p[None]).long(),
                                     tm.init_cache(1, 7, torch.float32))
    torch.testing.assert_close(last, exact, atol=1e-5, rtol=1e-5)


def test_continuous_batched_matches_serial_and_jax(smoke):
    """The pin: mixed-length staggered arrivals with early finishers at
    slots=2 through queue -> batcher -> paged cache -> executor give
    exactly the port's serial greedy tokens and the JAX executor's."""
    jm, jparams, tm, tparams = smoke
    lens = [5, 9, 3, 12, 7, 1]
    gens = [6, 4, 8, 5, 7, 1]  # early finishers + a prefill-only request
    prompts = [_prompt(tm.cfg, L, seed=i) for i, L in enumerate(lens)]
    serial = [serve.greedy_generate(tm, tparams, torch.from_numpy(p[None]), g, 32)[0].tolist()
              for p, g in zip(prompts, gens)]

    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(
        slots=2, page_size=4, max_len=32, max_new_tokens=8))
    ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    stats = ex.run()

    jex = jserve.ServeExecutor(jm, jparams, jserve.ServeConfig(
        slots=2, page_size=4, max_len=32, max_new_tokens=8))
    jids = [jex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    jex.run()

    for rid, jid, ref in zip(ids, jids, serial):
        res = ex.results[rid]
        assert res.status == serve.STATUS_OK
        assert res.tokens == ref
        assert res.tokens == jex.results[jid].tokens
    assert stats.completed == len(lens) and stats.errors == 0
    assert stats.latency.n == len(lens) and stats.qps > 0
    assert stats.memory["peak_bytes"] < serve.dense_cache_bytes(tm, 2, 32, torch.float32)


def test_executor_overflow_shed(smoke):
    _, _, tm, tparams = smoke
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(
        slots=1, page_size=4, max_len=16, max_new_tokens=2, queue_depth=2))
    ids = [ex.submit(_prompt(tm.cfg, 4, seed=i)) for i in range(5)]
    stats = ex.run()
    statuses = [ex.results[i].status for i in ids]
    assert statuses.count(serve.STATUS_SHED_OVERFLOW) == 3
    assert stats.completed == 2 and stats.shed_overflow == 3
    assert all(ex.results[i].tokens == [] for i in ids
               if ex.results[i].status == serve.STATUS_SHED_OVERFLOW)


def test_executor_deadline_shed(smoke):
    _, _, tm, tparams = smoke
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(
        slots=1, page_size=4, max_len=16, max_new_tokens=4), clock=FakeClock(dt=1.0))
    first = ex.submit(_prompt(tm.cfg, 4, seed=0))  # no deadline
    late = [ex.submit(_prompt(tm.cfg, 4, seed=i), timeout_s=2.0) for i in range(1, 4)]
    stats = ex.run()
    assert ex.results[first].status == serve.STATUS_OK
    assert all(ex.results[i].status == serve.STATUS_SHED_DEADLINE for i in late)
    assert stats.shed_deadline == 3


def test_executor_submit_validation(smoke):
    _, _, tm, tparams = smoke
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(slots=1, page_size=4, max_len=16))
    with pytest.raises(ValueError, match="empty prompt"):
        ex.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="exceeds"):
        ex.submit(_prompt(tm.cfg, 10), max_new_tokens=10)  # 20 > max_len


def test_executor_nonfinite_falls_back_to_serial(smoke):
    """Poisoned params make the batched path emit nonfinite logits; the
    lane must retire into the serial fallback, not crash the loop."""
    _, _, tm, tparams = smoke
    bad = {k: v for k, v in tparams.items()}
    bad["final_norm"] = {"scale": torch.full_like(tparams["final_norm"]["scale"], float("inf"))}
    ex = serve.ServeExecutor(tm, bad, serve.ServeConfig(
        slots=2, page_size=4, max_len=16, max_new_tokens=3))
    ids = [ex.submit(_prompt(tm.cfg, 4, seed=i)) for i in range(2)]
    stats = ex.run()
    assert all(ex.results[i].status in (serve.STATUS_FALLBACK, serve.STATUS_ERROR)
               for i in ids)
    assert stats.completed + stats.errors == 2


def test_serve_dtype_follows_config(smoke):
    _, _, tm, tparams = smoke
    m = Model(tm.cfg.replace(dtype="bfloat16"), device="cpu")
    b = serve.ContinuousBatcher(m, tparams, serve.ServeConfig(slots=2, page_size=4, max_len=16))
    assert b.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in b.cache.pools)
    toks = serve.greedy_generate(m, tparams, torch.from_numpy(_prompt(tm.cfg, 5)[None]), 4, 16)
    assert toks.shape == (1, 4)
