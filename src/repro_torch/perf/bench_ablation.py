"""Paper Tables 8/9 on the card: accuracy, throughput and memory of
finetuning and of the six hypergradient methods on the WRENCH-analog task,
the port's twin of ``benchmarks/bench_ablation.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_ablation \
        [--device cpu] [--full] [--out DIR]

Finetuning (``dataopt.train_plain``) and iterdiff, CG, Neumann, T1-T2,
SAMA-NA and SAMA (``dataopt.meta_train``) on mini-BERT at the JAX bench's
seeds, steps and sizes: test accuracy and µs per step. Then one more meta
step per method (unroll 2, batch 32, from a fresh state) gives its peak
memory, ``torch.cuda.max_memory_allocated`` after a reset less what the
process held before the bench began
(``memory_source`` ``cuda_max_allocated``; the JAX rows hold XLA's compiled
argument + output + temp bytes, not the same quantity; on the CPU it is
not measured). The paper's claims (SAMA the least memory and the fastest
step of the meta methods that differentiate twice, and the best
accuracy) are recorded, not asserted. Writes ``BENCH_torch_ablation.json``.
"""

from __future__ import annotations

import time

from repro_torch.perf.common import (MEMORY_NOTE, MEMORY_SOURCE, Bench, cli, live_bytes,
                                     mini_bert, peak_mb, reset_peak, wrench_task)

METHODS = ["iterdiff", "cg", "neumann", "t1t2", "sama_na", "sama"]
SECOND_ORDER = ("iterdiff", "cg", "neumann")


def peak_step_mb(model, train, meta, method, since):
    """The card's peak memory (MiB) over one meta step of ``method`` from a
    fresh state (MetaWeightNet reweighting, Adam at both levels), after a
    reset, less ``since`` bytes; None on the CPU."""
    from repro_torch import api, data
    from repro_torch.core import problems

    unroll, batch = 2, 32
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                              meta_lr=1e-3, method=method, unroll_steps=unroll)
    learner.init(model.init(0), problems.init_data_optimization_lam(1, reweight=True,
                                                                    device=model.device))
    it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                            unroll=unroll, device=model.device)
    bb, mb = next(it)
    reset_peak(model.device)
    learner.step(bb, mb)
    return peak_mb(model.device, since)


def run(*, fast: bool = True, device="cuda", steps=None, n_train: int = 512,
        n_meta: int = 128, n_test: int = 512) -> Bench:
    """``steps`` defaults to the JAX bench's (40, or 200 with
    ``fast=False``); finetuning takes twice as many."""
    from repro_torch.dataopt import meta_train, model_accuracy, train_plain
    from repro_torch.device import resolve_device
    from repro_torch.perf import synchronize

    base = live_bytes(resolve_device(device))
    steps = steps or (40 if fast else 200)
    ccfg, train, meta, test = wrench_task(seed=3, n_train=n_train, n_meta=n_meta,
                                          n_test=n_test)
    model = mini_bert(num_labels=ccfg.num_classes, device=device)
    bench = Bench("ablation")

    t0 = time.perf_counter()
    theta = train_plain(model, train, steps=steps * 2)
    synchronize()
    bench.emit("table8_finetune", (time.perf_counter() - t0) * 1e6 / (steps * 2),
               f"acc={model_accuracy(model, theta, test):.4f}")

    peaks = {}
    for method in METHODS:
        t0 = time.perf_counter()
        learner = meta_train(model, train, meta, method=method, steps=steps,
                             log_every=max(steps // 4, 1))
        synchronize()
        us = (time.perf_counter() - t0) * 1e6 / steps
        acc = model_accuracy(model, learner.state.theta, test)
        del learner
        peaks[method] = peak_step_mb(model, train, meta, method, base)
        peak = "not_measured" if peaks[method] is None else f"{peaks[method]:.1f}"
        bench.emit(f"table8_{method}", us,
                   f"acc={acc:.4f};peak_mb={peak};memory_source={MEMORY_SOURCE}")

    row = {r["name"].removeprefix("table8_"): r for r in bench.rows}
    acc = {k: r["derived"]["acc"] for k, r in row.items()}
    on_card = peaks["sama"] is not None
    bench.claim("sama_peak_mb<second_order",
                all(peaks["sama"] < peaks[m] for m in SECOND_ORDER) if on_card else None)
    bench.claim("sama_us<second_order", all(row["sama"]["us_per_call"]
                                            < row[m]["us_per_call"] for m in SECOND_ORDER))
    bench.claim("sama_acc_best", all(acc["sama"] >= a for a in acc.values()))
    bench.notes.update({"steps": steps, "memory": MEMORY_NOTE,
                        "init": "torch generator seeds (not the JAX draws); the data are "
                                "the JAX bench's numpy draws"})
    return bench


def main(argv=None):
    return cli("ablation", run, argv)


if __name__ == "__main__":
    main()
