"""Serving CLI of the port, a thin layer over ``repro_torch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        [--device cuda] [--serial] [--smoke] [--obs-log run.jsonl] \
        [--chrome-trace trace.json] [--flight-dir DIR] [--hang-deadline-s S] \
        [--inject-hang S] [--slo-budget F]

Submits a mixed-length request set to the continuous-batching executor
and prints one JSON line with per-request latency (p50/p99), TTFT, TPOT,
sustained QPS, statuses and paged-cache memory: the keys of
``repro.launch.serve``'s payload. ``--serial`` runs the same requests
through the serial dense-cache ``greedy_generate`` reference loop. The
weights and the prompts are random, from ``--seed``. It runs on the card
unless ``--device cpu`` is given. As in the reference, serving reads no
audio or image: a whisper or llama-3.2-vision request cross-attends to the
cache's zero ``cross_kv``.

Observability (``repro_torch.obs``): ``--obs-log`` appends the event
stream (every request's lifecycle, ticks, lane stats, health alerts) for
``python -m repro_torch.obs.report``; ``--slo-budget`` arms the SLO
monitor's burn-rate alert. ``--chrome-trace`` writes a Perfetto timeline:
a span per tick and a track per decode lane (a span per request under
``--serial``). The executor's flight recorder is always on; with
``--flight-dir`` its postmortem bundles (a degraded alert, an exception,
or the hang watchdog under ``--hang-deadline-s``) are written there and
listed in the payload's ``postmortems``. ``--inject-hang S`` stalls the
tick loop once for S seconds, which the watchdog must catch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch import configs, serve
from repro_torch import obs as obs_mod
from repro_torch.models import Model
from repro_torch.perf import LatencyStats


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int = 0):
    """Mixed-length prompts around ``prompt_len``."""

    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, prompt_len // 2), prompt_len + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=(int(L),)).astype(np.int64)
            for L in lens], [gen] * n


def run_continuous(model, params, prompts, gens, scfg: serve.ServeConfig, obs=None,
                   inject_hang=None):
    ex = serve.ServeExecutor(model, params, scfg, obs=obs)
    if inject_hang:
        ex.inject_hang(inject_hang)
    ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    stats = ex.run()
    return ex, ids, stats


def run_serial(model, params, prompts, gens, max_len: int, tracer=None):
    """The requests one at a time through ``greedy_generate``; returns the
    tokens and the per-request wall times (each ends in a device sync).
    Under ``tracer`` each request is a ``serial_request`` span."""

    outs, lat = [], []
    for p, g in zip(prompts, gens):
        t0 = time.perf_counter()
        with tracer.span("serial_request") if tracer is not None else contextlib.nullcontext():
            toks = serve.greedy_generate(model, params, torch.as_tensor(p)[None], g, max_len)
            outs.append([int(t) for t in toks[0].cpu()])
        lat.append(time.perf_counter() - t0)
    return outs, lat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request token cap (0 = prompt+gen rounded to a "
                         "page multiple)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline (shed on miss)")
    ap.add_argument("--serial", action="store_true",
                    help="serial dense-cache reference loop instead of "
                         "continuous batching")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-log", default=None, metavar="PATH",
                    help="append structured events (JSONL) for "
                         "`python -m repro_torch.obs.report`")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="write a Perfetto/chrome://tracing timeline (serve ticks and "
                         "per-lane request tracks, or per-request spans under --serial)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="write flight-recorder postmortem bundles here (read with "
                         "`repro_torch.obs.report --postmortem`)")
    ap.add_argument("--hang-deadline-s", type=float, default=None,
                    help="hang watchdog: dump a postmortem when no tick completes "
                         "within this deadline")
    ap.add_argument("--inject-hang", type=float, default=None, metavar="SECONDS",
                    help="fault injection: stall the tick loop once for SECONDS")
    ap.add_argument("--slo-budget", type=float, default=None,
                    help="allowed deadline-miss fraction; arms the SLO burn-rate alert "
                         "(which also dumps a postmortem)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    prompts, gens = make_requests(cfg, args.requests, args.prompt_len,
                                  args.gen, args.seed)
    pg = args.page_size
    max_len = args.max_len or pg * ((args.prompt_len + args.gen + pg - 1) // pg)
    obs = None
    if args.obs_log:
        obs = obs_mod.make_obs(log_path=args.obs_log, run_id=f"serve-{cfg.name}",
                               slo_budget=args.slo_budget)
        obs_mod.set_default(obs)
        obs.emit("run", "run_start", data={
            "cli": "serve", "arch": cfg.name,
            "mode": "serial" if args.serial else "continuous", "requests": args.requests})
    # the executor finds the tracer through active_tracer() and spans each
    # tick; the serial arm spans each request
    tracer = obs_mod.Tracer(obs=obs) if args.chrome_trace else None
    try:
        with obs_mod.activate(tracer) if tracer is not None else contextlib.nullcontext():
            payload, ex = _serve(args, cfg, model, params, prompts, gens, max_len, obs,
                                 tracer)
        if tracer is not None:
            # each decode lane is a track, built from the flight ring's
            # lifecycle events (always on by default)
            lane_events = (obs_mod.lane_chrome_events(ex.flight.events())
                           if ex is not None and ex.flight is not None else [])
            obs_mod.write_chrome_trace(args.chrome_trace, tracer.spans,
                                       extra_events=lane_events)
            payload["chrome_trace"] = {"path": args.chrome_trace, "spans": len(tracer.spans),
                                       "lane_events": len(lane_events)}
        payload["device"] = str(model.device)
        print(json.dumps(payload))
        if obs is not None:
            obs.emit("metrics", "registry_snapshot", data=obs.metrics.snapshot())
            obs.emit("run", "run_end", data={"qps": payload["qps"],
                                             "health": obs.health.status,
                                             "ring_dropped": obs.sink_dropped()})
    finally:
        if obs is not None:
            obs.close()
            obs_mod.set_default(None)


def _serve(args, cfg, model, params, prompts, gens, max_len, obs, tracer):
    """The serial loop or the executor; returns the payload and the
    executor (None for the serial loop)."""

    if args.serial:
        t0 = time.perf_counter()
        outs, lat = run_serial(model, params, prompts, gens, max_len, tracer)
        elapsed = time.perf_counter() - t0
        return {
            "mode": "serial", "arch": cfg.name, "requests": args.requests,
            "qps": round(args.requests / elapsed, 2),
            "latency_us": LatencyStats.from_samples(lat).as_dict(),
            "sample": outs[0],
        }, None
    scfg = serve.ServeConfig(
        slots=args.slots, page_size=args.page_size, max_len=max_len,
        max_new_tokens=args.gen, default_timeout_s=args.timeout_s,
        flight_dir=args.flight_dir, hang_deadline_s=args.hang_deadline_s)
    ex, ids, stats = run_continuous(model, params, prompts, gens, scfg, obs=obs,
                                    inject_hang=args.inject_hang)
    payload = {
        "mode": "continuous", "arch": cfg.name, "requests": args.requests,
        "statuses": {s: sum(ex.results[i].status == s for i in ids)
                     for s in set(ex.results[i].status for i in ids)},
        "qps": round(stats.qps, 2),
        "latency_us": stats.latency.as_dict(),
        "ttft_us": stats.ttft.as_dict(),
        "tpot_us": stats.tpot.as_dict(),
        "queue_wait_us": stats.queue_wait.as_dict(),
        "lanes": stats.lanes,
        "decode_steps": stats.steps,
        "memory": stats.memory,
        "sample": ex.results[ids[0]].tokens,
    }
    if ex.flight is not None and ex.flight.dumps:
        payload["postmortems"] = list(ex.flight.dumps)
    return payload, ex

if __name__ == "__main__":
    main()
