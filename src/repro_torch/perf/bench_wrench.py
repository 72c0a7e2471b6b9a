"""Paper Table 1 on the card: noisy finetuning with weak supervision
(WRENCH-analog), the port's twin of ``benchmarks/bench_wrench.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_wrench \
        [--device cpu] [--full] [--out DIR]

Test accuracy of plain finetuning on weak labels, SAMA-NA (+R), SAMA (+R)
and SAMA (+R&C) on mini-BERT, through ``repro_torch.dataopt``
(``train_plain`` / ``meta_train``), the JAX bench's seeds, steps and
sizes. The paper's claims (finetune < SAMA-NA < SAMA, and +C on top of +R
helping) are recorded, not asserted: the JAX bench asserts nothing.
Writes ``BENCH_torch_wrench.json``.
"""

from __future__ import annotations

import time

from repro_torch.perf.common import Bench, cli, mini_bert, wrench_task


def run(*, fast: bool = True, device="cuda", steps=None, n_train: int = 512,
        n_meta: int = 128, n_test: int = 512) -> Bench:
    """``steps`` defaults to the JAX bench's (100, or 400 with
    ``fast=False``); finetuning takes twice as many."""
    from repro_torch.dataopt import meta_train, model_accuracy, train_plain
    from repro_torch.perf import synchronize

    steps = steps or (100 if fast else 400)
    ccfg, train, meta, test = wrench_task(seed=0, n_train=n_train, n_meta=n_meta,
                                          n_test=n_test)
    model = mini_bert(num_labels=ccfg.num_classes, device=device)
    bench = Bench("wrench")

    t0 = time.perf_counter()
    theta = train_plain(model, train, steps=steps * 2)
    acc = model_accuracy(model, theta, test)
    bench.emit("table1_finetune_weak", (time.perf_counter() - t0) * 1e6 / steps,
               f"acc={acc:.4f}")

    rows = [
        ("table1_sama_na_R", dict(method="sama_na", correct=False)),
        ("table1_sama_R", dict(method="sama", correct=False)),
        ("table1_sama_RC", dict(method="sama", correct=True)),
    ]
    for name, kw in rows:
        t0 = time.perf_counter()
        learner = meta_train(model, train, meta, steps=steps,
                             log_every=max(steps // 4, 1), **kw)
        synchronize()
        us = (time.perf_counter() - t0) * 1e6 / steps
        acc = model_accuracy(model, learner.state.theta, test)
        bench.emit(name, us, f"acc={acc:.4f}")

    acc = {r["name"]: r["derived"]["acc"] for r in bench.rows}
    bench.claim("finetune<sama_na<sama", acc["table1_finetune_weak"]
                < acc["table1_sama_na_R"] < acc["table1_sama_R"])
    bench.claim("sama_RC>sama_R", acc["table1_sama_RC"] > acc["table1_sama_R"])
    bench.notes.update({"steps": steps, "init": "torch generator seeds (not the JAX draws); "
                                                "the data are the JAX bench's numpy draws"})
    return bench


def main(argv=None):
    return cli("wrench", run, argv)


if __name__ == "__main__":
    main()
