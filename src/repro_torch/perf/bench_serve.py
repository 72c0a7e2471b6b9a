"""The serving claims on the card, the port's twin of
``benchmarks/bench_serve.py`` (its ``serve_traced`` arm waits for the
observability pipeline, ROADMAP queue 1 item 6).

    PYTHONPATH=src python -m repro_torch.perf.bench_serve \
        [--device cpu] [--full] [--out DIR]

Arms, on gemma3-1b's smoke config (dense GQA: the paged KV pool and the
bucketed decode views; weights from seed 0):

* ``serve_serial``: R requests one at a time through the dense-cache
  ``greedy_generate`` reference loop: wall time (median over repeats) and
  per-request latency;
* ``serve_continuous``: the same requests submitted together to a
  ``ServeExecutor`` with 8 decode slots: wall time, sustained qps,
  p50/p99, decode steps, the paged cache's peak bytes;
* ``serve_paged_memory``: the paged peak against the dense ``slots x
  max_len`` cache (a meta-device probe, nothing allocated).

It keeps the JAX bench's hard asserts: tokens identical request by
request, continuous batching's qps strictly above the serial loop's at 8
or more requests, and the paged peak strictly below the dense cache.
Writes ``BENCH_torch_serve.json``.
"""

from __future__ import annotations

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

    from repro_torch import configs, perf, serve
    from repro_torch.models import Model

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

    lat_serial = perf.LatencyStats.from_samples(serial_lat)
    bench.emit_record(perf.PerfRecord(
        name="serve_serial", us_per_step=t_serial.as_dict(),
        samples_per_s=qps_serial, latency=lat_serial.as_dict(),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "mode": "serial"},
    ))
    bench.emit_record(perf.PerfRecord(
        name="serve_continuous", us_per_step=t_cb.as_dict(),
        samples_per_s=qps_cb, latency=stats.latency.as_dict(),
        extra={"arch": ARCH, "requests": n_req, "gen": gen, "slots": SLOTS,
               "mode": "continuous", "decode_steps": stats.steps,
               "cache_peak_bytes": paged_peak, "dense_cache_bytes": dense,
               "buckets": stats.memory["buckets"]},
    ))
    bench.emit("serve_serial", t_serial.median_us,
               f"qps={qps_serial:.3f};p50_us={lat_serial.p50_us:.0f};"
               f"p99_us={lat_serial.p99_us:.0f}")
    bench.emit("serve_continuous", t_cb.median_us,
               f"qps={qps_cb:.3f};p50_us={stats.latency.p50_us:.0f};"
               f"p99_us={stats.latency.p99_us:.0f};speedup={qps_cb / qps_serial:.2f}")
    bench.emit("serve_paged_memory", 0.0,
               f"paged_peak_bytes={paged_peak};dense_bytes={dense};"
               f"ratio={paged_peak / dense:.3f}")
    bench.notes.update({
        "left_out": "serve_traced and its <= 3% tracing-overhead assert wait for the "
                    "observability pipeline (ROADMAP queue 1 item 6); serve_continuous has "
                    "no attribution section (the JAX package's attribute() parses XLA HLO)",
        "asserts": ["tokens identical request by request", "qps_continuous > qps_serial "
                    "at >= 8 requests", "paged peak < dense slots x max_len"]})
    return bench


def main(argv=None):
    return cli("serve", run, argv)


if __name__ == "__main__":
    main()
