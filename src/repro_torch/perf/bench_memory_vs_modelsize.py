"""Paper Figure 1 (right) on the card: device memory against model size for
SAMA and the second-order baselines, the port's twin of
``benchmarks/bench_memory_vs_modelsize.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_memory_vs_modelsize \
        [--device cpu] [--full] [--out DIR]

Sweeps mini-RoBERTa width (128, 256, 384; and 512 with ``--full``) and
takes one meta step (unroll 1, batch 16, MetaWeightNet reweighting, Adam
at both levels) of SAMA, Neumann, CG and iterdiff at each: its peak,
``torch.cuda.max_memory_allocated`` after a reset less what the
process held before the bench began (``memory_source``
``cuda_max_allocated``; the JAX rows hold XLA's compiled argument + output
+ temp bytes, not the same quantity; on the CPU it is not measured), the
parameter count, and one ``PerfRecord`` per (method, width). The paper's
claim (SAMA's flattest growth) is recorded, not asserted. Writes
``BENCH_torch_memory_vs_modelsize.json``.
"""

from __future__ import annotations

from repro_torch.perf.common import (MEMORY_NOTE, MEMORY_SOURCE, Bench, cli, live_bytes,
                                     mini_bert, peak_mb, reset_peak, wrench_task)

METHODS = ["sama", "neumann", "cg", "iterdiff"]


def run(*, fast: bool = True, device="cuda", widths=None, n_train: int = 128,
        n_meta: int = 64, layers: int = 2) -> Bench:
    from repro_torch import api, data, perf
    from repro_torch.core import problems
    from repro_torch.device import resolve_device

    base = live_bytes(resolve_device(device))
    ccfg, train, meta, _ = wrench_task(seed=2, n_train=n_train, n_meta=n_meta, n_test=0)
    widths = widths or ([128, 256, 384] if fast else [128, 256, 384, 512])
    batch, unroll = 16, 1
    bench = Bench("memory_vs_modelsize")
    peaks = {m: [] for m in METHODS}

    for width in widths:
        model = mini_bert(num_labels=ccfg.num_classes, d_model=width, layers=layers,
                          device=device)
        spec = problems.make_data_optimization_spec(model.classifier_per_example,
                                                    reweight=True)
        lam = problems.init_data_optimization_lam(1, reweight=True, device=model.device)
        theta = model.init(0)
        n_params = model.num_params(theta)
        it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                                unroll=unroll, seed=0, device=model.device)
        base_b, meta_b = next(it)

        for method in METHODS:
            learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                                      meta_lr=1e-3, method=method, unroll_steps=unroll)
            learner.init(theta, lam)
            state = learner.state
            reset_peak(model.device)
            learner.step(base_b, meta_b)
            peak = peak_mb(model.device, base)
            peaks[method].append(peak)
            mem = perf.memory_report(example_args=(state, base_b, meta_b),
                                     peak_bytes=None if peak is None else int(peak * 2**20))
            name = f"fig1_mem_{method}_d{width}"
            bench.emit_record(perf.PerfRecord(
                name=name, memory=mem,
                extra={"method": method, "d_model": width, "params": n_params,
                       "memory_source": MEMORY_SOURCE if peak is not None else "not measured"},
            ))
            shown = "not_measured" if peak is None else f"{peak:.1f}"
            bench.emit(name, 0.0, f"params={n_params};peak_mb={shown}")
            del learner, state

    on_card = peaks["sama"][0] is not None
    growth = {m: p[-1] - p[0] for m, p in peaks.items()} if on_card else None
    bench.claim("sama_flattest_growth",
                all(growth["sama"] < growth[m] for m in METHODS if m != "sama")
                if on_card else None)
    bench.claim("sama_least_peak_each_width",
                all(peaks["sama"][i] < peaks[m][i] for i in range(len(widths))
                    for m in METHODS if m != "sama") if on_card else None)
    bench.notes.update({"widths": widths, "batch": batch, "unroll": unroll,
                        "memory": MEMORY_NOTE, "growth_mb": growth})
    return bench


def main(argv=None):
    return cli("memory_vs_modelsize", run, argv)


if __name__ == "__main__":
    main()
