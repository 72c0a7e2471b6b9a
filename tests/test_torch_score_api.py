"""The port's score API (``repro_torch.serve.score_api``: ``ScoreStore``,
``ScoreAPI``, ``ScoreAPIStats``) against the JAX package's
``repro.serve.score_api`` on one exported store:

* a store written by either package's ``export_scores`` loads in both;
* ``score`` and ``keep`` answers bitwise equal, ``weight`` within 1e-6
  relative (f64 softmax over the whole dataset, cast to f32) at
  temperatures 0.5, 1 and 4;
* under one injected clock, with deadlines and a queue that overflows: the
  same coalesced batch count, answered count, queue counters, latencies,
  and each request's answer or shed reason;
* ``obs=``: the JAX package's lifecycle events, request by request;
* ``repro_torch.serve`` exports what ``repro.serve`` exports of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.dataopt import export as jexport  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.dataopt import export  # noqa: E402

N = 257
TEMPS = (0.5, 1.0, 4.0)
WEIGHT_RTOL = 1e-6


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same scores and keep mask exported by each package."""
    rng = np.random.default_rng(3)
    scores = rng.standard_normal(N).astype(np.float32) * 3.0
    mask = rng.random(N) < 0.6
    root = tmp_path_factory.mktemp("stores")
    paths = {
        "jax": jexport.export_scores(str(root / "jax"), scores, scorer="meta", mask=mask),
        "torch": export.export_scores(str(root / "torch"), scores, scorer="meta", mask=mask),
        "torch_nomask": export.export_scores(str(root / "nomask"), scores, scorer="el2n"),
    }
    return scores, mask, paths


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_store_from_either_package_loads_in_both(stores, writer):
    scores, mask, paths = stores
    for store in (serve.ScoreStore.load(paths[writer], expect_n=N, expect_scorer="meta"),
                  jserve.ScoreStore.load(paths[writer], expect_n=N, expect_scorer="meta")):
        np.testing.assert_array_equal(store.scores, scores)
        np.testing.assert_array_equal(store.mask, mask)
        assert store.meta["kind"] == "dataopt.scores" and store.meta["n"] == N
    with pytest.raises(ValueError, match="scored by"):
        serve.ScoreStore.load(paths[writer], expect_scorer="el2n")


@pytest.mark.parametrize("writer", ["jax", "torch", "torch_nomask"])
def test_answers_match_jax(stores, writer):
    _, _, paths = stores
    got = serve.ScoreStore.load(paths[writer])
    want = jserve.ScoreStore.load(paths[writer])
    ids = np.random.default_rng(4).integers(0, N, 300)
    np.testing.assert_array_equal(got.lookup(ids), want.lookup(ids))
    np.testing.assert_array_equal(got.keep(ids), want.keep(ids))
    for t in TEMPS:
        a, b = got.weight(ids, t), want.weight(ids, t)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=WEIGHT_RTOL, atol=0)
    # the weights are a distribution over the whole dataset
    np.testing.assert_allclose(got.weight(np.arange(N), 1.0).sum(), 1.0, rtol=1e-5)
    for store in (got, want):
        with pytest.raises(IndexError, match="example ids"):
            store.lookup([N])
        with pytest.raises(ValueError, match="temperature"):
            store.weight([0], 0.0)
    assert len(got) == len(want) == N


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(pkg, store):
    """Nine requests of the three kinds into a queue of depth 6 (so three
    overflow), two with a deadline that passes before the drain, drained
    three at a time under an injected clock. Returns each request's
    outcome, the API and its stats."""
    clock = _Clock()
    api = pkg.ScoreAPI(store, max_batch=3, queue_depth=6, clock=clock)
    rng = np.random.default_rng(5)
    futs = []
    for i in range(9):
        kind = pkg.score_api.KINDS[i % 3]
        timeout = 0.5 if i in (1, 4) else None
        ids = rng.integers(0, N, 1 + i % 4)
        futs.append(api.submit(ids, kind=kind, temperature=TEMPS[i % 3], timeout_s=timeout))
        clock.t += 0.25
    clock.t += 1.0
    answered = api.run_pending()
    outcomes = []
    for fut in futs:
        err = fut.exception()
        outcomes.append(("err", type(err).__name__, str(err)) if err else ("ok", fut.result()))
    return answered, outcomes, api.stats()


def test_coalescing_and_shedding_match_jax(stores):
    _, _, paths = stores
    got = _script(serve, serve.ScoreStore.load(paths["torch"]))
    want = _script(jserve, jserve.ScoreStore.load(paths["torch"]))
    assert got[0] == want[0] == 4
    for (kind_g, *g), (kind_w, *w) in zip(got[1], want[1]):
        assert kind_g == kind_w
        if kind_g == "err":
            assert g == w
        else:
            np.testing.assert_allclose(g[0], w[0], rtol=WEIGHT_RTOL, atol=0)
            assert g[0].dtype == w[0].dtype
    reasons = [o[2] for o in got[1] if o[0] == "err"]
    assert reasons.count("request shed: shed_deadline") == 2 and len(reasons) == 5
    gs, ws = got[2], want[2]
    assert isinstance(gs, serve.ScoreAPIStats)
    assert (gs.answered, gs.batches) == (ws.answered, ws.batches) == (4, 2)
    assert gs.queue.__dict__ == ws.queue.__dict__
    assert gs.latency.as_dict() == ws.latency.as_dict()


def test_an_empty_drain_and_no_requests():
    store = serve.ScoreStore(np.zeros(4, np.float32))
    api = serve.ScoreAPI(store)
    assert api.run_pending() == 0
    stats = api.stats()
    assert (stats.answered, stats.batches, stats.latency.n) == (0, 0, 0)
    np.testing.assert_array_equal(store.keep([0, 3]), [True, True])
    with pytest.raises(ValueError, match="kind"):
        api.submit([0], kind="rank")
    with pytest.raises(IndexError):
        api.submit([4])
    with pytest.raises(ValueError, match="max_batch"):
        serve.ScoreAPI(store, max_batch=0)


def test_obs_emits_the_reference_events(stores):
    """``obs=``: each request's trace is ``enqueued`` and one terminal event
    (``done``, ``deadline_miss``, ``shed``) with the JAX package's data,
    and the queue's ``queue_shed`` events, in the JAX package's order."""
    from repro import obs as jobs
    from repro.obs import report as jreport
    from repro_torch import obs
    from repro_torch.obs import report

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    _, _, paths = stores
    seqs = {}
    for name, pkg, omod, rmod in (("torch", serve, obs, report), ("jax", jserve, jobs, jreport)):
        ring = omod.RingSink()
        clock = Clock()
        api = pkg.ScoreAPI(pkg.ScoreStore.load(paths["torch"]), max_batch=2, queue_depth=3,
                           default_timeout_s=5.0, clock=clock, obs=omod.Obs(sink=ring))
        api.submit([0, 1, 2])
        api.submit([5], kind="keep")
        api.run_pending()
        for ids, kind in (([1], "score"), ([2], "weight"), ([3], "score"), ([4], "keep")):
            api.submit(ids, kind=kind, temperature=2.0)  # the fourth overflows
        clock.t = 100.0
        api.run_pending()
        events = ring.events()
        assert rmod.validate_timelines(events) == []
        rid = {}
        seqs[name] = [(e.name, rid.setdefault(e.data["trace_id"], len(rid)),
                       {k: v for k, v in e.data.items() if k != "trace_id"})
                      for e in events if e.kind == "serve"]
    assert seqs["torch"] == seqs["jax"]
    names = [n for n, _, _ in seqs["torch"]]
    assert (names.count("done"), names.count("deadline_miss"), names.count("shed")) == (2, 3, 1)


def test_serve_exports_what_the_jax_package_exports():
    for name in ("ScoreAPI", "ScoreAPIStats", "ScoreStore", "LeafSpec", "QueueStats"):
        assert name in serve.__all__ and name in jserve.__all__
        assert getattr(serve, name).__name__ == getattr(jserve, name).__name__
    assert serve.score_api.KINDS == jserve.score_api.KINDS
