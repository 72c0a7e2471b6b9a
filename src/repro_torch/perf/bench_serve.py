"""The serving claims on the card, the port's twin of
``benchmarks/bench_serve.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_serve \
        [--device cpu] [--full] [--out DIR]

Arms, on gemma3-1b's smoke config (dense GQA: the paged KV pool and the
bucketed decode views; weights from seed 0):

* ``serve_serial``: R requests one at a time through the dense-cache
  ``greedy_generate`` reference loop: wall time (median over repeats) and
  per-request latency;
* ``serve_continuous``: the same requests submitted together to a
  ``ServeExecutor`` with 8 decode slots: wall time, sustained qps,
  p50/p99, decode steps, the paged cache's peak bytes, and the
  attribution of one more whole run by phase (``obs.profile``);
* ``serve_paged_memory``: the paged peak against the dense ``slots x
  max_len`` cache (a meta-device probe, nothing allocated);
* ``serve_traced``: the continuous arm with the whole request lifecycle
  traced (an obs ring, the health monitors with the SLO burn rate, the
  per-token events; the untraced arm already runs the always-on flight
  ring, so this measures what tracing adds): every request's timeline
  must rebuild (``validate_timelines``) with one terminal event each;
* ``serve_noflight`` (a record, no row: the JAX bench has none): the
  continuous arm with the flight ring off (``flight_capacity=0``), which
  says what the always-on ring costs the untraced executor.

It keeps the JAX bench's hard asserts: tokens identical request by
request (the traced arm's too), continuous batching's qps strictly above
the serial loop's at 8 or more requests, the paged peak strictly below
the dense cache, and tracing within 3% of the untraced arm's median
wall. That last one is counted (``perf/obs_cost.py``: the traced run's
obs calls replayed on a fresh pipeline against the untraced one's, and
the collector's share), because the walls of whole runs on a shared host
spread by more than 3% from run to run; the wall ratio of the JAX bench
is recorded beside it, with each arm's collections. It holds on the
card; on the CPU it is recorded (the claim ``tracing_within_3pct``).
Writes ``BENCH_torch_serve.json``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.perf.common import Bench, cli

ARCH = "gemma3-1b"  # dense GQA: paged KV pool + bucketed attention views
SLOTS = 8


def _workload(cfg, n, gen, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 17, size=n)  # mixed lengths: the paged regime
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(L),)).astype(np.int32)
               for L in lens]
    return prompts, [gen] * n


def run(*, fast: bool = True, device="cuda") -> Bench:
    import torch

    from repro_torch import configs, obs as obs_mod, perf, serve
    from repro_torch.models import Model
    from repro_torch.obs import report as report_mod
    from repro_torch.perf import obs_cost

    n_req = 8 if fast else 16
    gen = 8 if fast else 16
    repeats = 3 if fast else 5
    max_len = 32 if fast else 64

    cfg = configs.get_smoke_config(ARCH)
    model = Model(cfg, device=device)
    bench = Bench("serve")
    params = model.init(0)
    prompts, gens = _workload(cfg, n_req, gen)
    scfg = serve.ServeConfig(slots=SLOTS, page_size=4, max_len=max_len, max_new_tokens=gen)

    # -- serial reference loop ----------------------------------------------
    serial_lat = []

    def run_serial():
        serial_lat.clear()
        outs = []
        for p, g in zip(prompts, gens):
            t0 = time.perf_counter()
            toks = serve.greedy_generate(model, params, torch.from_numpy(p[None]), g, max_len)
            outs.append([int(t) for t in toks[0]])  # reads the tokens: a sync
            serial_lat.append(time.perf_counter() - t0)
        return outs

    serial_out = run_serial()  # warmup (kernel builds) + the correctness reference
    t_serial = perf.time_callable(run_serial, warmup=0, repeats=repeats)
    qps_serial = n_req / (t_serial.median_us / 1e6)

    # -- continuous batching over the paged cache ---------------------------
    runs = []

    def run_continuous():
        ex = serve.ServeExecutor(model, params, scfg)
        ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
        stats = ex.run()
        runs.append((ex, ids, stats))

    run_continuous()  # warmup
    runs.clear()
    with obs_cost.GcMeter() as gc_cb:
        t_cb = perf.time_callable(run_continuous, warmup=0, repeats=repeats)
    qps_cb = n_req / (t_cb.median_us / 1e6)
    ex, ids, stats = runs[-1]

    # correctness before speed: identical tokens, every request served
    for rid, ref in zip(ids, serial_out):
        assert ex.results[rid].status == serve.STATUS_OK, ex.results[rid]
        assert ex.results[rid].tokens == ref, \
            f"continuous/serial token mismatch on request {rid}"

    # acceptance: CB strictly faster at >= 8 concurrent requests
    assert n_req >= 8 and SLOTS >= 8
    assert qps_cb > qps_serial, \
        f"continuous batching QPS {qps_cb:.2f} <= serial {qps_serial:.2f}"

    # acceptance: paged peak strictly below dense slots x max_len
    paged_peak = stats.memory["peak_bytes"]
    dense = serve.dense_cache_bytes(model, SLOTS, max_len, ex.batcher.dtype)
    assert paged_peak < dense, \
        f"paged peak {paged_peak} >= dense slots x max_len {dense}"

    # -- the whole lifecycle traced: the <= 3% bar ---------------------------
    def traced_obs():
        return obs_mod.make_obs(ring=16384, slo_budget=0.25)

    def timed_runs(make_ex):
        """Whole ``run()`` calls of fresh executors, as serve_continuous
        times them, and the collections that ran meanwhile."""
        runs = []

        def once():
            ex = make_ex()
            ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
            runs.append((ex, ids, ex.run()))

        once()  # warmup
        runs.clear()
        with obs_cost.GcMeter() as meter:
            t = perf.time_callable(once, warmup=0, repeats=repeats)
        return t, runs[-1], meter

    pipelines = []

    def traced_executor():
        pipelines.append(traced_obs())
        return serve.ServeExecutor(model, params, scfg, obs=pipelines[-1])

    t_traced, (ex_t, ids_t, stats_t), gc_traced = timed_runs(traced_executor)
    # the always-on flight ring off: what it costs the untraced executor
    t_bare, _, gc_bare = timed_runs(lambda: serve.ServeExecutor(
        model, params, dataclasses.replace(scfg, flight_capacity=0)))
    qps_traced = n_req / (t_traced.median_us / 1e6)
    obs_t = pipelines[-1]
    events = obs_t.sink.events()
    errors = report_mod.validate_timelines(events)
    assert errors == [], f"broken request timelines: {errors[:5]}"
    timelines = report_mod.serve_timelines(events)
    assert len(timelines) == n_req, f"expected {n_req} request timelines, got {len(timelines)}"
    for tid, evs in timelines.items():
        terms = [e for e in evs if e.name in report_mod.TERMINAL_NAMES]
        assert len(terms) == 1, f"trace {tid}: {len(terms)} terminal events"
    assert stats_t.ttft.n == n_req and stats_t.tpot.n == n_req
    for rid, ref in zip(ids_t, serial_out):
        assert ex_t.results[rid].tokens == ref, f"traced/serial token mismatch on request {rid}"
    # what tracing costs, counted (perf/obs_cost.py): the walls of whole
    # runs on a shared host spread too far to resolve 3%, and are reported
    cost = obs_cost.serve_cost(obs_t, ex_t.flight, traced_obs, t_cb.median_us / 1e6,
                               flight_capacity=scfg.flight_capacity,
                               snapshot_every=scfg.flight_snapshot_every)
    overhead = cost["traced"]["ratio"]
    wall_ratio = t_traced.median_us / t_cb.median_us
    if torch.device(device).type == "cuda":
        assert overhead <= obs_cost.LIMIT, \
            f"tracing costs {(overhead - 1) * 100:.2f}% of the untraced run's wall, over 3%"

    lat_serial = perf.LatencyStats.from_samples(serial_lat)
    bench.emit_record(perf.PerfRecord(
        name="serve_serial", us_per_step=t_serial.as_dict(),
        samples_per_s=qps_serial, latency=lat_serial.as_dict(),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "mode": "serial"},
    ))
    # attribute one whole run of the same requests: the fused decode step
    # runs under the "serve_step" phase, prefill under "serve_prefill"
    from repro_torch.obs import profile as profile_mod

    attr_ex = serve.ServeExecutor(model, params, scfg)
    for p, g in zip(prompts, gens):
        attr_ex.submit(p, max_new_tokens=g)
    cb_rec = perf.PerfRecord(
        name="serve_continuous", us_per_step=t_cb.as_dict(),
        samples_per_s=qps_cb, latency=stats.latency.as_dict(),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "slots": SLOTS,
               "mode": "continuous", "decode_steps": stats.steps,
               "cache_peak_bytes": paged_peak, "dense_cache_bytes": dense,
               "buckets": stats.memory["buckets"]},
    )
    cb_rec.attribution = profile_mod.attribute(
        attr_ex.run, phases=profile_mod.DEFAULT_PHASES + ("serve_prefill",),
        device=torch.device(device))
    bench.emit_record(cb_rec)
    bench.emit("serve_serial", t_serial.median_us,
               f"qps={qps_serial:.3f};p50_us={lat_serial.p50_us:.0f};"
               f"p99_us={lat_serial.p99_us:.0f}")
    bench.emit("serve_continuous", t_cb.median_us,
               f"qps={qps_cb:.3f};p50_us={stats.latency.p50_us:.0f};"
               f"p99_us={stats.latency.p99_us:.0f};speedup={qps_cb / qps_serial:.2f}")
    bench.emit("serve_paged_memory", 0.0,
               f"paged_peak_bytes={paged_peak};dense_bytes={dense};"
               f"ratio={paged_peak / dense:.3f}")
    bench.emit_record(perf.PerfRecord(
        name="serve_traced", us_per_step=t_traced.as_dict(),
        samples_per_s=qps_traced, latency=stats_t.latency.as_dict(),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "slots": SLOTS,
               "mode": "continuous+trace", "events": len(events),
               "overhead_vs_untraced": overhead, "counted": cost["traced"],
               "wall_ratio_vs_untraced": wall_ratio,
               "collections": {"untraced": gc_cb.as_dict(), "traced": gc_traced.as_dict()},
               "ttft_p50_us": stats_t.ttft.p50_us, "ttft_p99_us": stats_t.ttft.p99_us,
               "tpot_p50_us": stats_t.tpot.p50_us, "tpot_p99_us": stats_t.tpot.p99_us,
               "queue_wait_p50_us": stats_t.queue_wait.p50_us},
    ))
    bench.emit("serve_traced", t_traced.median_us,
               f"qps={qps_traced:.3f};overhead={overhead:.4f};wall_ratio={wall_ratio:.4f};"
               f"ttft_p50_us={stats_t.ttft.p50_us:.0f};"
               f"tpot_p50_us={stats_t.tpot.p50_us:.0f};"
               f"queue_wait_p50_us={stats_t.queue_wait.p50_us:.0f}")
    bench.emit_record(perf.PerfRecord(
        name="serve_noflight", us_per_step=t_bare.as_dict(),
        samples_per_s=n_req / (t_bare.median_us / 1e6),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "slots": SLOTS,
               "mode": "continuous, flight_capacity=0",
               "flight_ring_cost": cost["flight"],
               "wall_ratio_untraced_vs_noflight": t_cb.median_us / t_bare.median_us,
               "collections": gc_bare.as_dict()},
    ))
    bench.claim("tracing_within_3pct", overhead <= obs_cost.LIMIT)
    bench.notes.update({
        "asserts": ["tokens identical request by request", "qps_continuous > qps_serial "
                    "at >= 8 requests", "paged peak < dense slots x max_len",
                    "every traced request timeline rebuilds with one terminal event",
                    "tracing's counted cost <= 3% of the untraced median wall "
                    "(perf/obs_cost.py; on the card)"]})
    return bench


def main(argv=None):
    return cli("serve", run, argv)


if __name__ == "__main__":
    main()
