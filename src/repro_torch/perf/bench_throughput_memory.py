"""Paper Table 2 / Fig. 1 (left) on the card: throughput and memory of SAMA
against the baseline hypergradient estimators at a fixed batch, the port's
twin of ``benchmarks/bench_throughput_memory.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_throughput_memory \
        [--out build/table2] [--repeats 20]

Six methods (``sama``, ``sama_na``, ``t1t2``, ``neumann``, ``cg``,
``iterdiff``) each take meta steps of bert-base at full width and depth
(``configs/bert_base.py``: f32 parameters, bf16 activations) with
MetaWeightNet reweighting on WRENCH-analog data at the model's vocabulary,
batch 48, seq 128, unroll 2, Adam at both levels, all from one state and
one batch. Per method, through ``MetaLearner.profile``: the step's wall
time (median, range), samples/s (batch x unroll per step) and peak device
memory; the launches of each kernel and the routing decisions by (route,
reason) over the measured calls, counted from 0 just before them (the
baselines' second-order passes take the plain route, ``dispatch.
second_order``); and one more step under ``torch.profiler``: its device
time, the busy share (device time over the median wall time), its
hypergradient norm and whether lam stayed finite (a NaN is reported, not
caught); for a baseline, one more step splits its peak memory at the
outermost ``dispatch.second_order`` passes (``second_order_peaks``), the
part of the step that takes the plain route. Writes ``BENCH_torch_table2.json`` through ``perf.write_bench``.
It runs on the card unless ``--device cpu`` is given (with ``--smoke`` on
the CPU, where no device time is measured).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

METHODS = ("sama", "sama_na", "t1t2", "neumann", "cg", "iterdiff")

#: device categories of a chrome trace that hold the card's work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def wrench_task(cfg, seq: int, n_train: int, n_meta: int, seed: int):
    """WRENCH-analog data at the model's vocabulary (``benchmarks/common.py``
    ``wrench_task``): majority-vote weak labels (LF accuracy 0.5) on train,
    clean labels on meta."""
    from repro_torch import data

    ccfg = data.ClassificationConfig(num_classes=cfg.num_labels, vocab_size=cfg.vocab_size,
                                     seq_len=seq, seed=seed)
    train = data.make_classification_dataset(ccfg, n_train, seed=seed)
    train["y"] = data.weak_labels(train["y_true"], cfg.num_labels, num_lfs=5, lf_accuracy=0.5,
                                  seed=seed + 1)
    meta = data.make_classification_dataset(ccfg, n_meta, seed=seed + 2)
    return train, meta


def profiled_device_ms(fn, trace_path: str):
    """Run ``fn()`` once under ``torch.profiler`` on the card, tracing the
    card's activity only (the host's ops would multiply the trace). Returns
    (its result, wall ms, device ms: the trace's kernels, copies and fills,
    kernel launches). The trace file is removed after it is read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    try:
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(trace_path)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    return (out, wall_ms, sum(e["dur"] for e in device) / 1e3,
            sum(e.get("cat") == "kernel" for e in device))


@contextlib.contextmanager
def second_order_peaks():
    """Within: the card's peak memory split at the outermost
    ``dispatch.second_order`` passes (the passes that differentiate twice,
    on the plain route). Yields a dict filled in as the passes end:
    ``in_passes``, the highest peak inside a pass; ``outside``, the highest
    peak outside them; ``live_at_entry``, the most memory held when a pass
    began; ``passes``, their number. ``in_passes - live_at_entry`` bounds
    from above what the plain route's passes add to the step's peak."""
    from repro_torch.kernels import dispatch

    inner, depth = dispatch.second_order, [0]
    out = {"in_passes": 0, "outside": 0, "live_at_entry": 0, "passes": 0}

    @contextlib.contextmanager
    def measured():
        if depth[0] == 0:
            out["outside"] = max(out["outside"], torch.cuda.max_memory_allocated())
            out["live_at_entry"] = max(out["live_at_entry"], torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        depth[0] += 1
        try:
            with inner():
                yield
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                out["in_passes"] = max(out["in_passes"], torch.cuda.max_memory_allocated())
                out["passes"] += 1
                torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.second_order = measured
    try:
        yield out
    finally:
        dispatch.second_order = inner
        torch.cuda.synchronize()
        out["outside"] = max(out["outside"], torch.cuda.max_memory_allocated())


def run(cfg=None, *, batch: int = 48, seq: int = 128, unroll: int = 2, warmup: int = 1,
        repeats: int = 20, methods: Sequence[str] = METHODS, device="cuda", seed: int = 0,
        trace_dir: Optional[str] = None, log=None) -> List[Any]:
    """Profile each method's meta step; returns the PerfRecords (their
    ``extra`` holds the launches, routes, device time and finiteness).
    ``cfg`` defaults to bert-base; ``trace_dir`` holds the profiled steps'
    traces while they are read (on the card only)."""
    from repro_torch import api, configs, data, tree
    from repro_torch.core import problems
    from repro_torch.core.engine import packed_read
    from repro_torch.kernels import dispatch
    from repro_torch.models import Model

    cfg = cfg or configs.get_config("bert-base")
    model = Model(cfg, device=device)
    on_card = model.device.type == "cuda"
    train, meta = wrench_task(cfg, seq, 1024, 256, seed + 1)
    it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                            unroll=unroll, seed=seed, device=model.device)
    base_b, meta_b = next(it)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    theta = model.init(seed)
    lam = problems.init_data_optimization_lam(seed + 1, reweight=True, device=model.device)
    records = []
    for method in methods:
        t_method = time.perf_counter()
        learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                                  meta_lr=1e-3, method=method, unroll_steps=unroll)
        learner.init(theta, lam)
        dispatch.reset_launches()  # counts of this method's measured calls only
        rec = learner.profile(base_b, meta_b, warmup=warmup, repeats=repeats,
                              name=f"table2_{method}", samples_per_step=batch * unroll)
        counts = dispatch.launch_counts()
        routes = dispatch.route_counts()

        def one_step():
            state, metrics = learner.step_fn(learner.state, base_b, meta_b)
            return state, packed_read(metrics)

        t_profile = time.perf_counter()
        if on_card:
            path = os.path.join(trace_dir or ".", f"table2_{method}_trace.json")
            (state, metrics), wall_ms, device_ms, kernels = profiled_device_ms(one_step, path)
        else:
            (state, metrics), wall_ms, device_ms, kernels = one_step(), None, None, None
        lam_finite = all(bool(torch.isfinite(x).all()) for x in tree.tree_leaves(state.lam))
        del state
        split = None
        if on_card and method not in ("sama", "sama_na"):
            with second_order_peaks() as split:
                learner.step_fn(learner.state, base_b, meta_b)
        median_ms = rec.us_per_step["median_us"] / 1e3
        rec.extra.update({
            "method": method, "batch": batch, "seq": seq, "unroll": unroll,
            "arch": cfg.name, "dtype": cfg.dtype, "steps_counted": warmup + repeats,
            "launches": counts, "routes": [[r, why, n] for (r, why), n in sorted(routes.items())],
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": None if device_ms is None else device_ms / median_ms,
            "profiled_kernel_launches": kernels,
            "hypergrad_norm": metrics["hypergrad_norm"],
            "metrics_finite": all(math.isfinite(v) for v in metrics.values()),
            "lam_finite": lam_finite,
            "bench_s": time.perf_counter() - t_method,
            "profiled_step_s": time.perf_counter() - t_profile,
            "second_order_peak_bytes": split,
        })
        records.append(rec)
        if log is not None:
            log(rec)
        del learner
        if on_card:
            torch.cuda.empty_cache()
    return records


def row(rec) -> Dict[str, Any]:
    """The bench file's row of one record."""
    peak = rec.memory["per_device"]["peak_bytes"]
    return {"name": rec.name, "us_per_call": round(rec.us_per_step["median_us"], 1),
            "derived": {"samples_per_s": rec.samples_per_s,
                        "peak_mb": None if peak is None else peak / 2**20,
                        "busy_share": rec.extra["device_busy_share"],
                        "lam_finite": rec.extra["lam_finite"]}}


def write(out_dir: str, records, elapsed_s: float) -> str:
    from repro_torch import perf

    path = os.path.join(out_dir, "BENCH_torch_table2.json")
    perf.write_bench(path, perf.bench_payload("torch_table2", fast=False, elapsed_s=elapsed_s,
                                              rows=[row(r) for r in records],
                                              records=records))
    return path


def main(argv=None):
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "table2"))
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config("bert-base") if args.smoke else configs.get_config("bert-base")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    records = run(cfg, batch=args.batch, seq=args.seq, repeats=args.repeats, device=args.device,
                  trace_dir=args.out, log=lambda rec: print(json.dumps(row(rec)), flush=True))
    print(write(args.out, records, time.perf_counter() - t0))


if __name__ == "__main__":
    main()
