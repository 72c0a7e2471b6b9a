"""The port's request-lifecycle tracing, flight recorder and hang watchdog
(``repro_torch.serve`` with ``repro_torch.obs``) against the JAX
package's:

* the executor under a fake clock, with staggered submissions: ok,
  deadline-shed, overflow-shed and non-finite-fallback runs give, request
  by request, the JAX executor's stage sequences, statuses and derived
  splits (``queue_wait_us``, ``ttft_us``, ``tpot_us``, ``resident_us``),
  and every timeline rebuilds (``validate_timelines == []``) in both
  packages; the flight ring alone rebuilds them with obs off;
* the flight recorder: ring bounds, dumps, throttling and the alert
  trigger, bundles equal in shape to the JAX recorder's; the bundle of an
  ``inject_hang`` run validates under the JAX package's
  ``validate_bundle``, and its state holds the queue, the lanes and the
  memory;
* the hang watchdog: fires once per stall, re-arms on a beat;
* the SLO burn rate, the lane tracks of the Chrome trace, the report's
  serve sections and postmortem text, and the diff's serve pseudo-phases,
  equal to the JAX package's on one stream;
* ``perf/obs_cost.py``'s replay of a traced run's obs calls remakes the
  run's events, metric counts and flight ring on every request path, and
  a replay that leaves calls out is refused;
* the serve CLI's ``--inject-hang`` writes a bundle that validates in
  both packages.
"""

import dataclasses
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.obs import diff as jdiff  # noqa: E402
from repro.obs import flight as jflight  # noqa: E402
from repro.obs import health as jhealth  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch import configs, convert, obs, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import diff as tdiff  # noqa: E402
from repro_torch.obs import flight as tflight  # noqa: E402
from repro_torch.obs import health as thealth  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402

from test_torch_obs import _ev, _same_text  # noqa: E402


class FakeClock:
    """Deterministic auto-advancing clock."""

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


def _prompt(n, seed):
    vocab = configs.get_smoke_config("gemma3-1b").vocab_size
    return np.random.default_rng(seed).integers(0, vocab, size=(n,)).astype(np.int32)


#: case -> (ServeConfig fields, [(prompt length, timeout_s, clock advance before submit)])
CASES = {
    "ok": (dict(slots=2, max_new_tokens=3),
           [(4, None, 0.0), (7, None, 2.5), (3, None, 0.0), (5, None, 4.0)]),
    "deadline": (dict(slots=1, max_new_tokens=4),
                 [(4, None, 0.0), (4, 2.0, 1.0), (6, 30.0, 0.5), (4, 2.0, 0.0)]),
    "overflow": (dict(slots=1, max_new_tokens=2, queue_depth=2),
                 [(4, None, 0.0), (5, None, 1.0), (4, None, 0.0), (3, None, 0.0),
                  (6, None, 2.0)]),
    "fallback": (dict(slots=2, max_new_tokens=3), [(4, None, 0.0), (5, None, 1.5)]),
}


def _served(pkg, model, params, case):
    """One executor run of ``case`` under a fake clock (every reading
    advances it by 1): the results, the obs ring's events and the flight
    ring's."""
    fields, subs = CASES[case]
    mod, obs_mod = (serve, obs) if pkg == "torch" else (jserve, jobs)
    if case == "fallback":
        params = (jax.tree_util.tree_map(lambda x: jnp.full_like(x, jnp.inf), params)
                  if pkg == "jax" else convert.params_from_jax(
                      jax.tree_util.tree_map(lambda x: np.full_like(np.asarray(x), np.inf),
                                             params), device="cpu"))
    ring = obs_mod.RingSink(4096)
    clock = FakeClock(dt=1.0)
    ex = mod.ServeExecutor(model, params, mod.ServeConfig(page_size=4, max_len=16, **fields),
                           clock=clock, obs=obs_mod.Obs(sink=ring))
    ids = []
    for i, (n, timeout, advance) in enumerate(subs):
        clock.t += advance
        ids.append(ex.submit(_prompt(n, i), timeout_s=timeout))
    ex.run()
    return ex, ids, ring.events(), ex.flight.events()


def _lifecycle(ex, events):
    """The serve stream with trace ids replaced by request ids and the
    ticks' wall times dropped."""
    rid = {r.trace_id: i for i, r in ex.results.items()}
    out = []
    for e in events:
        if e.kind != "serve":
            continue
        d = {k: v for k, v in e.data.items() if k not in ("trace_id", "dur_us")}
        out.append((e.name, rid.get(e.data.get("trace_id")), e.step, d))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_lifecycle_matches_jax(smoke, case):
    jm, jparams, tm, tparams = smoke
    tex, tids, tevents, tflight_events = _served("torch", tm, tparams, case)
    jex, jids, jevents, _ = _served("jax", jm, jparams, case)
    assert tids == jids
    for i in tids:
        t, j = tex.results[i], jex.results[i]
        assert (t.status, t.tokens, t.slot) == (j.status, j.tokens, j.slot)
        assert (t.submit_t, t.admitted_t, t.first_token_t, t.resolved_t) == \
            (j.submit_t, j.admitted_t, j.first_token_t, j.resolved_t)
    got, want = _lifecycle(tex, tevents), _lifecycle(jex, jevents)
    assert got == want
    assert treport.validate_timelines(tevents) == []
    assert jreport.validate_timelines(tevents) == []  # the port's stream, JAX's check
    assert jreport.validate_timelines(jevents) == []
    # the always-on flight ring alone carries the same lifecycle
    assert _lifecycle(tex, tflight_events) == got
    terminals = [e for e in tevents if e.name in treport.TERMINAL_NAMES]
    assert len(terminals) == len(tids)
    statuses = {tex.results[i].status for i in tids}
    want_status = {"ok": {"ok"}, "deadline": {"ok", "shed_deadline"},
                   "overflow": {"ok", "shed_overflow"}, "fallback": {"ok_serial_fallback"}}
    assert statuses == want_status[case]
    for e in terminals:
        r = tex.results[e.data["request_id"]]
        assert e.name == serve.ServeExecutor.TERMINAL_EVENT[r.status]
        if r.status in serve.OK_STATUSES:
            assert {"ttft_us", "tpot_us", "queue_wait_us", "resident_us"} <= set(e.data)
        assert e.data["resident_us"] == r.resident_s * 1e6


def test_terminal_vocabulary_and_queue_events_match_jax():
    assert serve.ServeExecutor.TERMINAL_EVENT == jserve.ServeExecutor.TERMINAL_EVENT
    assert set(serve.ServeExecutor.TERMINAL_EVENT.values()) <= set(treport.TERMINAL_NAMES)
    assert (treport.TERMINAL_NAMES, treport.STAGE_NAMES) == \
        (jreport.TERMINAL_NAMES, jreport.STAGE_NAMES)
    seqs = {}
    for pkg, mod, omod in (("torch", serve, obs), ("jax", jserve, jobs)):
        ring = omod.RingSink()
        o = omod.Obs(sink=ring)
        clock = FakeClock()
        q = mod.RequestQueue(max_depth=2, default_timeout_s=5.0, clock=clock, obs=o)
        q.submit({"a": 1})
        q.submit({"a": 2}, timeout_s=100.0)
        with pytest.raises(mod.QueueFull):
            q.submit({"a": 3})
        clock.t = 50.0
        q.pop(5)
        seqs[pkg] = ([(e.name, e.data["request_id"], e.data.get("reason"),
                       e.data.get("deadline_s")) for e in ring.events()],
                     o.metrics.snapshot())
    assert seqs["torch"] == seqs["jax"]


def test_flight_recorder_matches_jax(tmp_path):
    bundles = {}
    for pkg, fmod in (("torch", tflight), ("jax", jflight)):
        clock = FakeClock()
        out = tmp_path / pkg
        fr = fmod.FlightRecorder(capacity=4, out_dir=str(out), min_interval_s=5.0, clock=clock)
        for i in range(10):
            fr.record("serve", "token", data={"i": i})
        fr.record_snapshot({"queue_depth": 3})
        fr.add_state_provider("queue", lambda: {"depth": 3})
        fr.add_state_provider("broken", lambda: 1 / 0)
        got = [fr.dump(fmod.REASON_HANG, detail="x"), fr.dump(fmod.REASON_HANG),
               fr.dump(fmod.REASON_EXCEPTION), fr.dump(fmod.REASON_HANG, force=True)]
        clock.t = 100.0
        got.append(fr.dump(fmod.REASON_HANG))
        assert [b is None for b in got] == [False, True, False, False, False]
        assert fr.dropped == 6 and len(fr.dumps) == 4
        assert not glob.glob(str(out / "*.tmp"))
        for path in fr.dumps:
            assert jflight.validate_bundle(tflight.load_bundle(path)) == []
            assert tflight.validate_bundle(jflight.load_bundle(path)) == []
        b = got[0]
        bundles[pkg] = {k: v for k, v in b.items() if k != "env"}
        bundles[pkg]["events"] = [(e["kind"], e["name"], e["data"]) for e in b["events"]]
        assert set(b["env"]) == {"pid", "unix_time"}
    assert bundles["torch"] == bundles["jax"]
    garbage = [[], {"kind": "postmortem"},
               {"v": 1, "kind": "postmortem", "trigger": {"reason": "hang", "t": 1.0},
                "events": [{"nope": 1}], "dropped": 0, "metrics_snapshots": [], "state": {}}]
    for g in garbage:
        assert tflight.validate_bundle(g) == jflight.validate_bundle(g) != []


def test_flight_attach_dumps_on_a_degraded_alert():
    monitor = thealth.ServeSLOMonitor(window=20, min_events=4, warn_rate=2.0,
                                      degraded_rate=0.5)
    o = obs.Obs(sink=obs.RingSink(64), health=thealth.HealthMonitor(monitors=[monitor]))
    fr = tflight.FlightRecorder(capacity=16)
    fr.attach(o)
    fr.attach(obs.NULL_OBS)  # no health: nothing to attach
    for _ in range(6):
        o.emit("serve", "deadline_miss", data={"trace_id": "x"})
    assert fr.last_bundle["trigger"]["reason"] == tflight.REASON_ALERT
    assert "serve_slo" in fr.last_bundle["trigger"]["detail"]
    # emit_teed: one event for both destinations; the ring alone without obs
    ring = obs.RingSink()
    fr2 = tflight.FlightRecorder(capacity=8)
    tflight.emit_teed(obs.Obs(sink=ring, monitor=False), fr2, "serve", "enqueued",
                      data={"trace_id": "t"})
    tflight.emit_teed(obs.NULL_OBS, fr2, "serve", "enqueued", data={"trace_id": "u"})
    tflight.emit_teed(obs.NULL_OBS, None, "serve", "enqueued")
    assert ring.events()[0] is fr2.events()[0] and len(fr2.events()) == 2


def test_hang_watchdog_fires_once_and_rearms():
    fired = []
    t = [0.0]
    wd = tflight.HangWatchdog(1.0, fired.append, clock=lambda: t[0])
    assert not wd.check()
    t[0] = 0.9
    assert not wd.check()
    t[0] = 1.5
    assert wd.check() and fired == [1.5]
    t[0] = 3.0
    assert not wd.check()
    wd.beat()
    t[0] = 5.0
    assert wd.check() and (wd.fires, wd.beats) == (2, 1)
    with pytest.raises(ValueError):
        tflight.HangWatchdog(0.0, lambda s: None)
    wd.start()
    wd.stop()
    assert wd._thread is None


def test_executor_inject_hang_bundle_validates_in_jax(smoke, tmp_path):
    _, _, tm, tparams = smoke
    # a deadline well above a tick of this size on a loaded CPU: the
    # injected stall, not a slow prefill, trips the watchdog
    ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(
        slots=1, page_size=4, max_len=16, max_new_tokens=3, flight_dir=str(tmp_path),
        hang_deadline_s=0.6))
    ex.inject_hang(2.0)
    ids = [ex.submit(_prompt(4, i)) for i in range(2)]
    ex.run()
    assert all(ex.results[i].status == serve.STATUS_OK for i in ids)
    paths = sorted(glob.glob(str(tmp_path / "postmortem-hang-*.json")))
    assert len(paths) == 1 and ex.flight.dumps == paths
    bundle = jflight.load_bundle(paths[0])
    assert jflight.validate_bundle(bundle) == [] == tflight.validate_bundle(bundle)
    assert bundle["trigger"]["reason"] == "hang" and bundle["events"]
    state = bundle["state"]
    assert set(state) == {"queue", "lanes", "memory"}
    assert state["queue"]["submitted"] == 2 and len(state["lanes"]) == 1
    assert state["memory"]["buckets"] == ex.batcher.memory_stats()["buckets"]
    assert "device_allocated_bytes" not in state["memory"]  # the CPU has no allocator count
    assert serve.ServeExecutor(tm, tparams, serve.ServeConfig(flight_capacity=0)).flight is None


def _lifecycle_stream(pkg, n_ok=3, n_miss=1):
    out, t = [], 0.0
    for i in range(n_ok + n_miss):
        tid = f"{i:016x}"
        out.append(_ev(pkg, "serve", "enqueued", {"trace_id": tid}, t=t))
        out.append(_ev(pkg, "serve", "admitted", {"trace_id": tid, "queue_wait_us": 1e3},
                       t=t + 0.001))
        out.append(_ev(pkg, "serve", "prefill_start", {"trace_id": tid}, t=t + 0.002))
        if i < n_ok:
            out.append(_ev(pkg, "serve", "first_token", {"trace_id": tid, "slot": i % 2},
                           t=t + 0.003))
            out.append(_ev(pkg, "serve", "done", {
                "trace_id": tid, "status": "ok", "tokens": 4, "slot": i % 2,
                "ttft_us": 3e3 + i, "tpot_us": 500.0 + i, "queue_wait_us": 1e3,
                "resident_us": 5e3 + i}, t=t + 0.005))
        else:
            out.append(_ev(pkg, "serve", "deadline_miss", {
                "trace_id": tid, "status": "shed_deadline", "resident_us": 2500.0},
                t=t + 0.004))
        t += 0.01
    out.append(_ev(pkg, "serve", "lane_stats", {"lanes": [
        {"slot": 0, "useful_ticks": 8, "trash_ticks": 2, "tokens": 8, "goodput": 0.8}]}, t=t))
    return out


def test_serve_report_lanes_postmortem_and_burn_match_jax(tmp_path, capsys):
    got = treport.summarize(_lifecycle_stream("torch"))
    want = jreport.summarize(_lifecycle_stream("jax"))
    got["health"].pop("t"), want["health"].pop("t")
    assert got == want and got["serve"]["trace_errors"] == []
    _same_text(treport.render(got), jreport.render(want))
    broken = [e for e in _lifecycle_stream("torch") if e.name != "done"]
    assert treport.validate_timelines(broken) == jreport.validate_timelines(broken) != []
    assert obs.lane_chrome_events(_lifecycle_stream("torch")) == \
        jobs.lane_chrome_events(_lifecycle_stream("jax"))
    assert obs.lane_chrome_events(_lifecycle_stream("torch")[:3]) == []
    # the postmortem of an open trace, rendered by both
    texts = []
    for pkg, fmod, rmod in (("torch", tflight, treport), ("jax", jflight, jreport)):
        fr = fmod.FlightRecorder(capacity=16, out_dir=str(tmp_path / pkg))
        for e in _lifecycle_stream(pkg, n_ok=1, n_miss=0)[:-2]:
            fr.write(e)
        fr.record_snapshot({"queue_depth": 2})
        fr.add_state_provider("queue", lambda: {"depth": 2})
        fr.dump(fmod.REASON_EXCEPTION, detail="RuntimeError('boom')")
        bundle = fmod.load_bundle(fr.dumps[0])
        bundle["metrics_snapshots"][0]["t"] = 0.0
        texts.append(rmod.render_postmortem(bundle))
    _same_text(*texts)
    assert "still open" in texts[0]
    path = glob.glob(str(tmp_path / "torch" / "*.json"))[0]
    assert treport.main([path, "--postmortem", "--validate"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"v": 99}))
    assert treport.main([str(bad), "--postmortem", "--validate"]) == 1
    capsys.readouterr()
    # the SLO burn rate: one degraded alert per episode, as in JAX
    alerts = {}
    for pkg, hmod in (("torch", thealth), ("jax", jhealth)):
        mon = hmod.ServeSLOMonitor(window=20, min_events=5, warn_rate=2.0, degraded_rate=2.0,
                                   budget=0.05, fast_window=5, burn_threshold=4.0)
        fired = []
        for name in ["done"] * 5 + ["deadline_miss"] * 10 + ["done"] * 5 + \
                ["deadline_miss"] * 5:
            fired += mon.observe(_ev(pkg, "serve", name, {"trace_id": "x"}))
        alerts[pkg] = ([dataclasses.replace(a, t=0.0).as_dict() for a in fired], mon.verdict())
    assert alerts["torch"] == alerts["jax"] and alerts["torch"][1]["burn_alerts"] == 2
    assert obs.make_obs(ring=16, slo_budget=0.05).health.monitors[3].budget == 0.05


def test_diff_serve_pseudophases_match_jax(tmp_path):
    def stream(name, ttft):
        path = str(tmp_path / name)
        sink = obs.JsonlSink(path)
        sink.write(obs.make_event("serve", "done", data={
            "trace_id": "t", "status": "ok", "ttft_us": ttft, "tpot_us": 100.0,
            "queue_wait_us": 50.0, "resident_us": 2000.0}))
        sink.close()
        return path

    base, cur = stream("base.jsonl", 1000.0), stream("cur.jsonl", 3000.0)
    assert tdiff.phase_costs_from_events(obs.read_jsonl(base)) == \
        jdiff.phase_costs_from_events(jobs.read_jsonl(base))
    rows = tdiff.diff_paths(base, cur)
    jrows, _ = jdiff.diff_paths(base, cur)
    assert [r.as_dict() for r in rows] == [r.as_dict() for r in jrows]
    assert tdiff.top_regressor(rows).phase == "serve:ttft"


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_replay_remakes_the_runs_obs_calls(smoke, case):
    """``perf/obs_cost.py`` counts what tracing costs a served run by
    replaying its obs calls: a fresh pipeline must end with the run's
    events, metric counts and flight-ring length (checked inside
    ``serve_cost``), for every path a request takes."""
    from repro_torch.perf import obs_cost

    _, _, tm, tparams = smoke
    ex, _, _, _ = _served("torch", tm, tparams, case)
    cost = obs_cost.serve_cost(ex._obs, ex.flight, lambda: obs.Obs(sink=obs.RingSink(4096)),
                               1.0, flight_capacity=ex.cfg.flight_capacity,
                               snapshot_every=ex.cfg.flight_snapshot_every, rounds=3)
    for arm in ("traced", "flight"):
        c = cost[arm]
        assert c["replay_ms"] > 0 and c["retained_objects"] > 0
        assert c["ratio"] == pytest.approx(1 + c["cost_ms"] / 1e3) and c["limit"] == 1.03
        assert c["cost_ms"] == pytest.approx(c["replay_ms"] + c["collector_ms"])


def test_serve_replay_that_leaves_a_call_out_is_refused(smoke):
    from repro_torch.perf import obs_cost

    _, _, tm, tparams = smoke
    ex, _, events, _ = _served("torch", tm, tparams, "ok")
    short = [e for e in events if e.name != "tick"]
    replay = obs_cost.serve_replay(short, lambda: obs.Obs(sink=obs.RingSink(4096)),
                                   ex.cfg.flight_capacity)
    o, fr = replay()
    assert obs_cost.signature(o) != obs_cost.signature(ex._obs)
    ring = obs.RingSink(4096)
    for e in short:
        ring.write(e)
    with pytest.raises(AssertionError, match="does not remake"):
        obs_cost.serve_cost(obs.Obs(sink=ring), ex.flight,
                            lambda: obs.Obs(sink=obs.RingSink(4096)), 1.0,
                            flight_capacity=ex.cfg.flight_capacity, rounds=1)


def test_executor_is_freed_without_the_cycle_collector(smoke):
    """The flight recorder's state providers and the hang watchdog hold
    the executor weakly: with the collector off, dropping the executor
    frees its batcher (its paged cache) at once, as before the recorder
    existed. A cycle through them once kept served caches on the card into
    the next phase of ``chip_smoke.py``."""
    import gc
    import weakref

    _, _, tm, tparams = smoke
    gc.disable()
    try:
        for o in (None, obs.Obs(sink=obs.RingSink())):
            ex = serve.ServeExecutor(tm, tparams, serve.ServeConfig(
                slots=2, page_size=4, max_len=16, max_new_tokens=2, hang_deadline_s=5.0), obs=o)
            ex.submit(_prompt(4, 0))
            ex.run()
            gone = weakref.ref(ex.batcher)
            del ex
            assert gone() is None
    finally:
        gc.enable()


def test_serve_cli_inject_hang_writes_a_valid_postmortem(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli

    pm, log, trace = tmp_path / "pm", tmp_path / "s.jsonl", tmp_path / "t.json"
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "6",
                    "--gen", "3", "--slots", "2", "--page-size", "4", "--obs-log", str(log),
                    "--chrome-trace", str(trace), "--inject-hang", "2.0",
                    "--hang-deadline-s", "0.6", "--flight-dir", str(pm),
                    "--slo-budget", "0.1"])
    payload = json.loads(capsys.readouterr().out)
    assert payload["statuses"] == {"ok": 3} and len(payload["postmortems"]) == 1
    bundle = jflight.load_bundle(payload["postmortems"][0])
    assert jflight.validate_bundle(bundle) == [] and bundle["trigger"]["reason"] == "hang"
    assert jobs.validate_jsonl(str(log)) == [] and obs.validate_jsonl(str(log)) == []
    events = list(jobs.read_jsonl(str(log)))
    assert jreport.validate_timelines(events) == []
    assert len(jreport.serve_timelines(events)) == 3
    doc = json.load(open(trace))
    lanes = [e for e in doc["traceEvents"] if e.get("pid") == 1 and e["ph"] == "X"]
    assert len(lanes) == 3 and payload["chrome_trace"]["lane_events"] == len(lanes) + 3
    assert treport.main([payload["postmortems"][0], "--postmortem", "--validate"]) == 0
    assert obs.get_default() is obs.NULL_OBS
