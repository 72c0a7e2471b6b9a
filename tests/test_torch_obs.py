"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``:

* schema and sinks: the same validation errors; a JSONL stream written by
  either package validates and reads in the other; the console lines;
* metrics: the same sample sequences give equal snapshots and quantiles;
* spans: ``phase`` records nothing without a tracer, nests under one, and
  the Chrome trace and span summary equal the JAX package's for the same
  spans; ``Span.traced`` is False outside a CUDA-graph capture;
* health: every monitor and ``replay``, fed one synthetic stream, give the
  same alerts and verdicts;
* report and diff: one log gives equal summaries, equal text (but for the
  package's name in the header) and the same ranking and verdict;
* the training loop: the quickstart ``fit`` with obs gives JAX's (kind,
  name, step) sequence with the metrics within tests/test_torch_sama.py's
  tolerances; obs on and off give bitwise-equal state and metrics and the
  same launch and route counts (one CPU thread: PyTorch's multithreaded
  CPU kernels are not bitwise reproducible from run to run); kernel routing
  is mirrored into the default pipeline; ``phase_profile``,
  ``verify_census`` and the checkpoint events;
* the train CLI: standard output is the same bytes with and without
  ``--obs-log`` (but for the wall clock ``elapsed_s``), and the log
  passes both packages' validation.
"""

import dataclasses
import io
import json
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.obs import diff as jdiff  # noqa: E402
from repro.obs import events as jevents  # noqa: E402
from repro.obs import health as jhealth  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import api, convert, tree  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.obs import diff as tdiff  # noqa: E402
from repro_torch.obs import events as tevents  # noqa: E402
from repro_torch.obs import health as thealth  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

from test_torch_sama import HYPER, LOSS, _np_tree, _quickstart_data  # noqa: E402

#: the two packages' event modules, for streams built in both
EVENTS = {"jax": jevents, "torch": tevents}


def _ev(pkg, kind, name, data=None, step=None, t=None):
    e = EVENTS[pkg].make_event(kind, name, data=data, step=step)
    return e if t is None else dataclasses.replace(e, t=t)


def _same_text(port_text, jax_text):
    assert port_text.replace("repro_torch.obs", "repro.obs") == jax_text


# ---------------------------------------------------------------------------
# schema and sinks
# ---------------------------------------------------------------------------

BAD_EVENTS = [
    "not a dict",
    {"v": 2, "t": 0.0, "kind": "log", "name": "x", "step": None, "data": {}},
    {"v": 1, "t": "now", "kind": "bogus", "name": "", "step": 1.5, "data": []},
    {"v": 1, "t": 1.0, "kind": "span", "name": "x", "step": None},
    {"v": 1, "t": 1.0, "kind": "metrics", "name": "step", "step": 3, "data": {}},
]


@pytest.mark.parametrize("bad", range(len(BAD_EVENTS)))
def test_validate_event_gives_the_jax_errors(bad):
    assert obs.validate_event(BAD_EVENTS[bad]) == jobs.validate_event(BAD_EVENTS[bad])
    assert obs.events.KINDS == jobs.events.KINDS
    assert obs.events.SCHEMA_VERSION == jobs.events.SCHEMA_VERSION
    with pytest.raises(ValueError, match="unknown event kind"):
        obs.make_event("bogus", "x")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_jsonl_written_by_either_package_reads_in_both(tmp_path, writer):
    path = str(tmp_path / "run.jsonl")
    sink = (tevents if writer == "torch" else jevents).JsonlSink(path)
    for i, (kind, name) in enumerate([("run", "run_start"), ("metrics", "step"),
                                      ("span", "base_unroll"), ("serve", "done"),
                                      ("alert", "nonfinite")]):
        sink.write(_ev(writer, kind, name, data={"i": i, "x": np.float32(0.5)},
                       step=i if kind == "metrics" else None))
    sink.close()
    with open(path, "a") as f:
        f.write('{"v": 1, "kind": "log", "na')  # a torn last line
    assert obs.validate_jsonl(path)[:-1] == [] and jobs.validate_jsonl(path)[:-1] == []
    got, io_t = obs.read_jsonl_stats(path)
    want, io_j = jobs.read_jsonl_stats(path)
    assert io_t == io_j == {"torn_lines": 1, "invalid_lines": 0}
    assert [e.as_dict() for e in got] == [e.as_dict() for e in want]
    assert [e.as_dict() for e in obs.read_jsonl(path)] == [e.as_dict() for e in got]
    with pytest.raises(ValueError, match="not JSON"):
        list(obs.read_jsonl(path, strict=True))


def test_ring_sink_eviction_and_tee_drop_count():
    ring = obs.RingSink(3)
    for i in range(5):
        ring.write(obs.make_event("log", f"e{i}"))
    assert [e.name for e in ring.events()] == ["e2", "e3", "e4"] and ring.dropped == 2
    o = obs.Obs(sink=obs.TeeSink([ring, obs.RingSink(10), obs.NullSink()]))
    assert o.sink_dropped() == 2
    with pytest.raises(ValueError):
        obs.RingSink(0)


def test_console_sink_renders_the_cli_lines():
    events = [("log", "a", {"text": "hello"}, None), ("log", "b", {"k": 1}, None),
              ("metrics", "step", {"loss": 0.5}, 3), ("metrics", "registry_snapshot", {}, None),
              ("alert", "nonfinite", {"severity": "degraded", "message": "m"}, 2),
              ("span", "x", {}, None), ("run", "run_start", {"arch": "a"}, None)]
    outs = {}
    for pkg, mod in (("torch", tevents), ("jax", jevents)):
        buf = io.StringIO()
        sink = mod.ConsoleSink(buf)
        for kind, name, data, step in events:
            sink.write(_ev(pkg, kind, name, data, step))
        outs[pkg] = buf.getvalue()
    assert outs["torch"] == outs["jax"]  # "run" is not printed by default
    # the port's CLI line: the step before the wall clock, which stays last
    buf = io.StringIO()
    tevents.ConsoleSink(buf).write(obs.make_event(
        "metrics", "step", data={"loss": 0.5, "elapsed_s": 1.2}, step=4))
    assert buf.getvalue() == '{"loss": 0.5, "step": 4, "elapsed_s": 1.2}\n'
    buf = io.StringIO()
    sink = tevents.ConsoleSink(buf, kinds=("run",))
    sink.write(obs.make_event("run", "run_start", data={"arch": "a"}))
    sink.write(obs.make_event("run", "run_end", data={}))
    assert buf.getvalue() == '{"run": {"arch": "a"}}\n'


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

SAMPLES = {
    "spread": np.random.default_rng(0).lognormal(8.0, 2.0, 500).tolist(),
    "single": [1234.5],
    "on_bound": [100.0, 100.0, 177.82794100389228],
    "overflow": [1e9, 5e7, 3.0],
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_matches_jax(name):
    got, want = tmetrics.Histogram("h"), jmetrics.Histogram("h")
    for v in SAMPLES[name]:
        got.observe(v)
        want.observe(v)
    assert got.snapshot() == want.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert tmetrics.log_buckets(1.0, 1e4, 3) == jmetrics.log_buckets(1.0, 1e4, 3)


def test_registry_counter_gauge_match_jax():
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    rng = np.random.default_rng(1)
    for v, lab in zip(rng.normal(size=40), rng.integers(0, 3, 40)):
        for reg in regs:
            reg.counter("c").inc(abs(float(v)), labels={"k": int(lab), "z": "a"})
            reg.gauge("g").set(float(v), labels={"k": int(lab)})
            reg.histogram("h", bounds=[-1.0, 0.0, 1.0]).observe(float(v))
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(TypeError):
        regs[0].gauge("c")
    with pytest.raises(ValueError):
        regs[0].counter("c").inc(-1)


def test_packed_read_is_one_stacked_copy():
    got = obs.packed_read({"a": torch.tensor(1.5), "b": torch.tensor(2, dtype=torch.int32),
                           "c": torch.tensor([3.25])})
    assert got == {"a": 1.5, "b": 2.0, "c": 3.25}
    from repro_torch.core import engine

    assert engine.packed_read is obs.packed_read  # one copy, in obs/metrics.py


# ---------------------------------------------------------------------------
# spans and the Chrome trace
# ---------------------------------------------------------------------------


def test_phase_records_spans_only_under_a_tracer():
    with ttrace.phase("base_unroll"):
        pass
    assert ttrace.active_tracer() is None
    ring = obs.RingSink()
    o = obs.Obs(sink=ring)
    tracer = obs.Tracer(obs=o)
    tracer.step = 7
    with obs.activate(tracer):
        with ttrace.phase("local_terms"):
            with ttrace.phase("meta_pass"):
                pass
        with tracer.span("custom"):
            pass
    assert ttrace.active_tracer() is None
    names = [(s.name, s.depth, s.parent, s.traced, s.step) for s in tracer.spans]
    assert names == [("meta_pass", 1, "local_terms", False, 7),
                     ("local_terms", 0, None, False, 7), ("custom", 0, None, False, 7)]
    assert [(e.kind, e.name, e.step) for e in ring.events()] == [
        ("span", "meta_pass", 7), ("span", "local_terms", 7), ("span", "custom", 7)]
    assert tracer.runtime_spans() == tracer.spans


def test_chrome_trace_and_summary_match_jax(tmp_path):
    rows = [("base_unroll", 0.0, 2.0, 0, None, False), ("meta_pass", 2.1, 0.5, 1, "local_terms",
                                                         False),
            ("local_terms", 2.0, 1.0, 0, None, False), ("serve_tick", 3.0, 0.1, 0, None, True),
            ("meta_pass", 5.0, 0.25, 1, "local_terms", False)]
    tspans = [ttrace.Span(n, s, d, dp, p, tr, step=1) for n, s, d, dp, p, tr in rows]
    jspans = [jtrace.Span(n, s, d, dp, p, tr, step=1) for n, s, d, dp, p, tr in rows]
    got, want = ttrace.chrome_trace(tspans), jtrace.chrome_trace(jspans)
    assert got["metadata"]["producer"] == "repro_torch.obs.trace"
    got["metadata"], want["metadata"] = {}, {}
    assert got == want
    assert ttrace.span_tree_summary(tspans) == jtrace.span_tree_summary(jspans)
    assert ttrace.PHASES == jtrace.PHASES
    path = ttrace.write_chrome_trace(str(tmp_path / "sub" / "t.json"), tspans,
                                     extra_events=[{"name": "x", "ph": "M"}])
    assert len(json.load(open(path))["traceEvents"]) == len(rows) + 1


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


def _stream(pkg, which):
    """One synthetic stream, built in ``pkg``'s event type."""
    e = lambda *a, **k: _ev(pkg, *a, **k)  # noqa: E731
    if which == "nonfinite":
        return ([e("gate", "meta_update", {"finite": False}, step=s) for s in range(3)]
                + [e("metrics", "step", {"meta_skipped": float(s % 3 == 0),
                                         "hypergrad_norm": math.inf if s == 7 else 1.0},
                     step=s) for s in range(120)])
    if which == "loss_scale":
        return [e("scale", "backoff" if s % 4 else "growth", {"scale": 2.0 ** (15 - s)},
                  step=s * 30) for s in range(12)]
    if which == "census":
        return [e("census", "all_reduce", {"observed": 3, "expected": 3, "ok": True}),
                e("census", "all_reduce", {"observed": 4, "expected": 3})]
    if which == "serve_slo":
        names = ["done"] * 12 + ["deadline_miss"] * 9 + ["shed"] * 14 + ["rejected"] + \
            ["done"] * 30 + ["deadline_miss"] * 25
        return [e("serve", n, {"trace_id": f"{i:016x}"}) for i, n in enumerate(names)]
    if which == "queue_depth":
        depths = [96, 96, 96, 50, 85, 85, 85, 85, 85, 99, 99, 99, 99, 99, 99]
        return [e("serve", "tick", {"queue_depth": d, "capacity": 100}) for d in depths]
    raise ValueError(which)


def _alerts(alerts):
    return [dataclasses.replace(a, t=0.0).as_dict() for a in alerts]


@pytest.mark.parametrize("which", ["nonfinite", "loss_scale", "census", "serve_slo",
                                   "queue_depth"])
def test_monitor_gives_the_jax_alerts_and_verdict(which):
    mons = {"torch": thealth.default_monitors(slo_budget=0.05),
            "jax": jhealth.default_monitors(slo_budget=0.05)}
    fired = {}
    for pkg in mons:
        fired[pkg] = []
        for event in _stream(pkg, which):
            for m in mons[pkg]:
                fired[pkg] += m.observe(event)
    assert fired["torch"], which
    assert _alerts(fired["torch"]) == _alerts(fired["jax"])
    assert [m.verdict() for m in mons["torch"]] == [m.verdict() for m in mons["jax"]]
    got = thealth.replay(_stream("torch", which), thealth.default_monitors(0.05))
    want = jhealth.replay(_stream("jax", which), jhealth.default_monitors(0.05))
    assert got.status == want.status != "ok"
    assert _alerts(got.alerts) == _alerts(want.alerts)


def test_obs_pipeline_alerts_and_derived_events_match_jax():
    """observe_step's derived scale and gate events and the alert events
    the pipeline writes, for one sequence of host metric rows."""
    rows = [{"loss_scale": 2.0 ** 16, "meta_skipped": 0.0, "hypergrad_norm": 1.0},
            {"loss_scale": 2.0 ** 15, "meta_skipped": 1.0, "hypergrad_norm": math.nan},
            {"loss_scale": 2.0 ** 14, "meta_skipped": 1.0, "hypergrad_norm": 1.0},
            {"loss_scale": 2.0 ** 14, "meta_skipped": 1.0, "hypergrad_norm": 1.0},
            {"loss_scale": 2.0 ** 15, "meta_skipped": 0.0, "hypergrad_norm": 2.0}]
    seqs = {}
    for pkg, mod in (("torch", obs), ("jax", jobs)):
        ring = mod.RingSink()
        o = mod.Obs(sink=ring)
        for i, row in enumerate(rows):
            o.observe_step(i, dict(row))
        o.observe_census(4, 3, detail={"schedule": "single_sync"})
        o.log("note", "text", step=2, k=1)
        seqs[pkg] = [(e.kind, e.name, e.step, {k: v for k, v in e.data.items()
                                               if not isinstance(v, float) or v == v})
                     for e in ring.events()]
        summary = o.summary()
        seqs[pkg].append((summary["health"]["status"], summary["metrics"]))
    assert seqs["torch"] == seqs["jax"]
    assert obs.NULL_OBS.emit("log", "x") is None and not obs.NULL_OBS.enabled


# ---------------------------------------------------------------------------
# report and diff
# ---------------------------------------------------------------------------


def _rich_log(path, scale=1.0):
    """A log with every section the report renders."""
    sink = tevents.JsonlSink(path)
    t = 1000.0

    def w(kind, name, data=None, step=None):
        nonlocal t
        t += 0.25
        sink.write(_ev("torch", kind, name, data, step, t=t))

    w("run", "run_start", {"cli": "train"})
    for s in range(3):
        for name, us in (("base_unroll", 900.0), ("local_terms", 300.0), ("meta_pass", 120.0),
                         ("cd_passes", 150.0), ("finalize", 20.0), ("meta_update", 40.0)):
            w("span", name, {"dur_us": us * scale * (1 + s / 10), "depth": 0, "parent": None,
                             "traced": False}, step=s)
        w("metrics", "step", {"base_loss": 2.0 - s / 3, "meta_loss": 1.5, "eps": 1e-4}, step=s)
    w("span", "base_unroll", {"dur_us": 5.0, "traced": True})
    w("scale", "backoff", {"scale": 512.0, "prev": 1024.0}, step=1)
    w("gate", "meta_update", {"finite": False, "reason": "nonfinite_hypergrad"}, step=1)
    w("dispatch", "adam_adapt", {"backend": "plain", "reason": "cpu tensor"})
    w("census", "all_reduce", {"observed": 3, "expected": 3, "ok": True})
    for r in range(3):
        tid = f"{r:016x}"
        w("serve", "enqueued", {"trace_id": tid, "request_id": r})
        w("serve", "admitted", {"trace_id": tid, "request_id": r})
        w("serve", "first_token", {"trace_id": tid, "slot": r % 2})
        w("serve", "tick", {"dur_us": 800.0 * scale + r, "queue_depth": r, "capacity": 8})
        term = "done" if r < 2 else "deadline_miss"
        w("serve", term, {"trace_id": tid, "request_id": r, "slot": r % 2, "tokens": 4,
                          "ttft_us": 5e3 * scale, "tpot_us": 800.0 * scale + r,
                          "queue_wait_us": 100.0, "resident_us": 9e3 * scale})
    w("serve", "lane_stats", {"lanes": [{"slot": 0, "useful_ticks": 5, "trash_ticks": 1,
                                         "tokens": 8, "goodput": 5 / 6}]})
    w("run", "run_end", {"ring_dropped": 2})
    sink.close()
    with open(path, "a") as f:
        f.write("torn\n")


def test_report_summary_and_text_match_jax(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    _rich_log(path)
    got = treport.summarize(*obs.read_jsonl_stats(path))
    want = jreport.summarize(*jobs.read_jsonl_stats(path))
    for s in (got, want):
        assert s["health"].pop("t") > 0
    assert got == want
    assert got["serve"]["trace_errors"] == [] and got["io"]["torn_lines"] == 1
    _same_text(treport.render(got), jreport.render(want))
    assert treport.main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["events"] == got["events"]
    assert treport.main([path, "--validate"]) == 1  # the torn line
    capsys.readouterr()
    assert treport.validate_timelines(obs.read_jsonl(path)) == []


def test_diff_ranks_and_renders_as_jax(tmp_path, capsys):
    base, cur = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _rich_log(base)
    _rich_log(cur, scale=1.5)
    rows = tdiff.diff_paths(base, cur)
    jrows, unit = jdiff.diff_paths(base, cur)
    assert unit == tdiff.UNIT
    assert [r.as_dict() for r in rows] == [r.as_dict() for r in jrows]
    assert tdiff.render_diff(rows) == jdiff.render_diff(jrows, unit)
    assert tdiff.top_regressor(rows).phase == jdiff.top_regressor(jrows).phase == "serve:resident"
    assert tdiff.main([base, cur, "--fail-over", "10"]) == 1
    assert tdiff.main([base, base, "--fail-over", "10"]) == 0
    capsys.readouterr()
    assert treport.main([cur, "--diff", base, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["diff"]["unit"] == "us" and out["diff"]["phases"][0]["phase"] == "serve:resident"


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _quickstart_pair():
    d, batches = _quickstart_data()
    kw = dict(base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2, unroll_steps=2)
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    tspec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    return d, batches, kw, jspec, tspec


def test_fit_with_obs_emits_the_jax_sequence():
    d, batches, kw, jspec, tspec = _quickstart_pair()
    jring, tring = jobs.RingSink(), obs.RingSink()
    jlearner = japi.MetaLearner(jspec, obs=jobs.Obs(sink=jring), **kw)
    jlearner.init({"w": jnp.zeros((d, 2)), "b": jnp.zeros((2,))},
                  jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True))
    tlearner = api.MetaLearner(tspec, obs=obs.Obs(sink=tring), **kw)
    tlearner.state = convert.state_from_jax(_np_tree(jlearner.state), device="cpu")
    steps = 5
    jhist = jlearner.fit((jax.tree_util.tree_map(jnp.asarray, batches(i)) for i in range(steps)),
                         steps, log_every=2)
    thist = tlearner.fit((tree.tree_map(torch.from_numpy, batches(i)) for i in range(steps)),
                         steps, log_every=2)
    seq = lambda ring: [(e.kind, e.name, e.step) for e in ring.events()]  # noqa: E731
    assert seq(tring) == seq(jring) == [("metrics", "step", s) for s in (0, 2, 4)]
    for t, j, th, jh in zip(tring.events(), jring.events(), thist, jhist):
        assert set(t.data) == set(j.data) and th == {**t.data, "step": t.step}
        for key in ("base_loss", "meta_loss"):
            np.testing.assert_allclose(t.data[key], j.data[key], err_msg=key, **LOSS)
        for key in ("eps", "hypergrad_norm"):
            np.testing.assert_allclose(t.data[key], j.data[key], err_msg=key, **HYPER)
        assert jh["step"] == th["step"]


def test_obs_on_and_off_give_bitwise_state_and_launches():
    d, batches, kw, _, tspec = _quickstart_pair()
    theta = {"w": torch.full((d, 2), 0.01), "b": torch.zeros(2)}
    lam = problems.init_data_optimization_lam(3, reweight=True, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arm in ("off", "on"):
            ring = obs.RingSink()
            o = obs.Obs(sink=ring) if arm == "on" else None
            learner = api.MetaLearner(tspec, obs=o, **kw)
            learner.init(theta, lam)
            dispatch.reset_launches()
            obs.set_default(o)
            try:
                with obs.activate(obs.Tracer(obs=o)) if o else _null():
                    hist = learner.fit((tree.tree_map(torch.from_numpy, batches(i))
                                        for i in range(3)), 3, log_every=1)
            finally:
                obs.set_default(None)
            out[arm] = (tree.tree_leaves(learner.state.theta), tree.tree_leaves(learner.state.lam),
                        hist, dispatch.launch_counts(), dispatch.route_counts(), ring.events())
    finally:
        torch.set_num_threads(threads)
    off, on = out["off"], out["on"]
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        assert torch.equal(a, b)
    assert off[2] == on[2] and off[3] == on[3] and off[4] == on[4] and off[4]
    assert off[5] == []
    kinds = {(e.kind, e.name) for e in on[5]}
    assert {("metrics", "step"), ("span", "base_unroll"), ("span", "meta_pass"),
            ("dispatch", "adam_adapt")} <= kinds


def _null():
    import contextlib

    return contextlib.nullcontext()


def test_dispatch_routes_mirror_into_the_default_obs():
    ring = obs.RingSink()
    o = obs.Obs(sink=ring)
    x = torch.ones(4)
    obs.set_default(o)
    try:
        for _ in range(5):
            dispatch.route("adam_adapt", x)
        dispatch.route("weighted_ce", x, backend="plain")
        with dispatch.second_order():
            dispatch.route("adam_adapt", x)
    finally:
        obs.set_default(None)
    dispatch.route("adam_adapt", x)  # the default is off again
    c = o.metrics.get("dispatch_total")
    assert c.value({"kernel": "adam_adapt", "backend": "plain", "reason": "cpu tensor"}) == 5
    assert c.total() == 7
    assert [(e.kind, e.name, e.data) for e in ring.events()] == [
        ("dispatch", "adam_adapt", {"backend": "plain", "reason": "cpu tensor"}),
        ("dispatch", "weighted_ce", {"backend": "plain", "reason": "forced"}),
        ("dispatch", "adam_adapt", {"backend": "plain", "reason": "second order"})]
    assert obs.get_default() is obs.NULL_OBS


def test_phase_profile_census_and_checkpoint_events(tmp_path):
    d, batches, kw, _, tspec = _quickstart_pair()
    from repro_torch.launch.mesh import make_host_mesh

    ring = obs.RingSink()
    o = obs.Obs(sink=ring)
    learner = api.MetaLearner(tspec, obs=o, mesh=make_host_mesh("cpu"), checkpoint_dir=str(
        tmp_path), **kw)
    learner.init({"w": torch.zeros((d, 2)), "b": torch.zeros(2)},
                 problems.init_data_optimization_lam(3, reweight=True, device="cpu"))
    base, meta = tree.tree_map(torch.from_numpy, batches(0))
    before = [x.clone() for x in tree.tree_leaves(learner.state.theta)]
    spans = learner.phase_profile(base, meta)
    assert {s.name for s in spans} == {"base_unroll", "local_terms", "meta_pass", "cd_passes",
                                       "allreduce_flat", "finalize", "meta_update"}
    assert all(s.dur_s > 0 and not s.traced for s in spans)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.tree_leaves(learner.state.theta)))
    census = learner.verify_census(base, meta)
    assert census["single_sync_ok"]
    path = learner.save()
    learner.load(path)
    names = [(e.kind, e.name) for e in ring.events() if e.kind != "span"]
    assert names == [("census", "all_reduce"), ("checkpoint", "save"),
                     ("checkpoint", "restore")]
    c = [e for e in ring.events() if e.kind == "census"][0]
    assert c.data == {"observed": 3, "expected": 3, "ok": True, "schedule": "single_sync"}


def _obs_arm(o, steps=3):
    """The quickstart ``fit`` with ``o`` the learner's and the default
    pipeline, under an activated tracer of it: what ``perf/bench_obs.py``'s
    obs arm does."""
    d, batches, kw, _, tspec = _quickstart_pair()
    learner = api.MetaLearner(tspec, obs=o, **kw)
    learner.init({"w": torch.full((d, 2), 0.01), "b": torch.zeros(2)},
                 problems.init_data_optimization_lam(3, reweight=True, device="cpu"))
    obs.set_default(o)
    try:
        with obs.activate(obs.Tracer(obs=o)):
            learner.fit((tree.tree_map(torch.from_numpy, batches(i)) for i in range(steps)),
                        steps, log_every=1)
    finally:
        obs.set_default(None)


@pytest.mark.parametrize("sink", ["ring", "jsonl"])
def test_train_replay_remakes_the_arms_obs_calls(tmp_path, sink):
    """``perf/obs_cost.py`` counts what obs costs a training arm by
    replaying its calls (routing, spans, metric rows) on a fresh pipeline:
    the replay must end with the arm's events and routing counts (checked
    inside ``train_cost``), into a ring or a JSONL file read back."""
    from repro_torch.perf import obs_cost

    def make():
        if sink == "ring":
            return obs.Obs(sink=obs.RingSink(4096))
        return obs.Obs(sink=obs.JsonlSink(str(tmp_path / f"{len(list(tmp_path.iterdir()))}.jsonl")))

    o = make()
    _obs_arm(o)
    o.close()
    events = o.sink.events() if sink == "ring" else list(obs.read_jsonl(o.sink.path))
    assert {"metrics", "span", "dispatch"} <= {e.kind for e in events}
    cost = obs_cost.train_cost(o, events, make, 2.0, spans_under_tracer=True, rounds=3,
                               read_back=None if sink == "ring"
                               else lambda p: obs.read_jsonl(p.sink.path))
    assert cost["replay_ms"] > 0 and cost["retained_objects"] >= 0
    assert cost["ratio"] == pytest.approx(1 + cost["cost_ms"] / 2e3)
    assert cost["collector"]["full_ms"] > 0 and cost["collector"]["kept_objects"] > 0
    assert obs.get_default() is obs.NULL_OBS


def test_train_replay_that_leaves_a_call_out_is_refused():
    from repro_torch.perf import obs_cost

    o = obs.Obs(sink=obs.RingSink(4096))
    _obs_arm(o, steps=2)
    events = o.sink.events()
    with pytest.raises(AssertionError, match="does not remake"):  # no routing counts
        obs_cost.train_cost(obs.Obs(sink=obs.RingSink()), events,
                            lambda: obs.Obs(sink=obs.RingSink(4096)), 1.0,
                            spans_under_tracer=True, rounds=1)
    with pytest.raises(AssertionError, match="does not remake"):  # the spans not traced
        obs_cost.train_cost(o, events, lambda: obs.Obs(sink=obs.RingSink(4096)), 1.0,
                            rounds=1)


def test_gc_meter_counts_the_collections_by_generation():
    import gc

    from repro_torch.perf import obs_cost

    before = list(gc.callbacks)
    with obs_cost.GcMeter() as meter:
        gc.collect(0)
        gc.collect(2)
    assert meter.counts[0] >= 1 and meter.counts[2] >= 1 and min(meter.ms) >= 0
    assert gc.callbacks == before
    got = meter.as_dict()
    gc.collect(1)
    assert meter.as_dict() == got  # it listens only while active


def test_timed_rounds_rotate_the_order():
    from repro_torch.perf import obs_cost

    order = []
    t = obs_cost.timed_rounds({k: (lambda k=k: order.append(k)) for k in "abc"}, 3)
    assert order == list("abc") + list("abc") + list("bca") + list("cab")
    assert {k: len(v) for k, v in t.items()} == {"a": 3, "b": 3, "c": 3}


def test_train_cli_stdout_is_unchanged_by_obs_log(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "bert-base", "--smoke", "--device", "cpu", "--steps", "2",
            "--log-every", "1", "--batch", "4", "--seq", "16"]
    outs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for extra in ([], ["--obs-log", str(tmp_path / "o.jsonl")]):
            train.main(argv + extra)
            outs.append(capsys.readouterr())
    finally:
        torch.set_num_threads(threads)
    wall = re.compile(r'"elapsed_s": [0-9.]+')
    plain, logged = (wall.sub('"elapsed_s": T', o.out) for o in outs)
    assert plain == logged and plain.count("\n") == 2
    assert outs[0].err == outs[1].err and outs[0].err.startswith('{"run": {"arch": "bert-base"')
    path = str(tmp_path / "o.jsonl")
    assert obs.validate_jsonl(path) == [] and jobs.validate_jsonl(path) == []
    events = list(jobs.read_jsonl(path))
    kinds = [(e.kind, e.name) for e in events]
    assert kinds[0] == ("run", "run_start") and kinds[-1] == ("run", "run_end")
    assert {("span", p) for p in ("base_unroll", "local_terms", "meta_pass", "cd_passes",
                                  "finalize", "meta_update")} <= set(kinds)
    assert [e.step for e in events if e.kind == "metrics" and e.name == "step"] == [0, 1]
    assert treport.main([path, "--validate"]) == 0
    assert obs.get_default() is obs.NULL_OBS
