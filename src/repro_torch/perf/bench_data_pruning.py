"""Paper Figure 3 and Sec. 4.3 on the card: scale-agnostic data pruning
through ``repro_torch.dataopt``, the port's twin of
``benchmarks/bench_data_pruning.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_data_pruning \
        [--device cpu] [--full] [--out DIR]

Meta-learns per-sample importance with MetaWeightNet through SAMA with the
train data at both levels (meta split = train: the paper's no-validation
setting), prunes the lowest-scored fraction and retrains from scratch,
against EL2N and random pruning at ratios 0.1 and 0.3 (0.1, 0.2, 0.3, 0.5
with ``--full``) on a classification set with 25% of its labels flipped.
Every arm is ``DataOptimizer(..., scorer=<name>)``; the JAX bench's seeds,
steps and sizes. Per arm and ratio: the retrained test accuracy and the
kept count; then SAMA's mean weight on clean and on corrupted examples.
The paper's claims (SAMA's pruning above EL2N's and random's at every
ratio; corrupted examples weighted below clean ones) are recorded, not
asserted. Writes ``BENCH_torch_data_pruning.json``.
"""

from __future__ import annotations

from repro_torch.perf.common import Bench, cli, mini_bert

#: scorer name -> DataOptimizer knobs. Swapping arms is this one argument.
SCORERS = {
    "sama": lambda steps: dict(scorer="meta", method="sama", unroll=2,
                               uncertainty="none", steps=steps),
    "el2n": lambda steps: dict(scorer="el2n", train_steps=20),
    "random": lambda steps: dict(scorer="random"),
}


def run(*, fast: bool = True, device="cuda", steps=None, retrain_steps=None, n: int = 512,
        n_test: int = 512) -> Bench:
    """``steps`` (the meta scorer's) and ``retrain_steps`` default to the
    JAX bench's (60 and 100, or 250 and 400 with ``fast=False``)."""
    from repro_torch import data
    from repro_torch.dataopt import DataOptimizer

    ccfg = data.ClassificationConfig(num_classes=4, vocab_size=512, seq_len=32, seed=7)
    train = data.make_classification_dataset(ccfg, n, noise=0.25, seed=7)
    test = data.make_classification_dataset(ccfg, n_test, noise=0.0, seed=8)
    model = mini_bert(num_labels=ccfg.num_classes, device=device)
    bench = Bench("data_pruning")
    steps = steps or (60 if fast else 250)
    retrain_steps = retrain_steps or (100 if fast else 400)
    ratios = [0.1, 0.3] if fast else [0.1, 0.2, 0.3, 0.5]

    for tag, knobs in SCORERS.items():
        # meta split = train: the paper's no-validation Sec. 4.3 setting
        opt = DataOptimizer(model, train, meta=train, seed=7, **knobs(steps))
        opt.fit_scores()
        for r in ratios:
            _, mask = opt.prune(r)
            theta = opt.retrain(steps=retrain_steps, mask=mask)
            acc = opt.evaluate(theta, test)
            bench.emit(f"fig3_{tag}_r{int(r * 100)}", 0.0,
                       f"acc={acc:.4f};kept={int(mask.sum())}")
        if tag == "sama":
            # how well do the learned weights identify the corrupted samples?
            bad = train["corrupted"]
            w = opt.scores
            bench.emit("fig3_sama_weight_auc", 0.0,
                       f"w_clean={w[~bad].mean():.3f};w_noisy={w[bad].mean():.3f}")

    def acc(tag, r):
        return bench.derived(f"fig3_{tag}_r{int(r * 100)}")["acc"]

    bench.claim("sama>el2n,random at every ratio",
                all(acc("sama", r) > max(acc("el2n", r), acc("random", r)) for r in ratios))
    auc = bench.derived("fig3_sama_weight_auc")
    bench.claim("w_noisy<w_clean", auc["w_noisy"] < auc["w_clean"])
    bench.notes.update({"steps": steps, "retrain_steps": retrain_steps, "ratios": ratios,
                        "init": "torch generator seeds (not the JAX draws); the data are "
                                "the JAX bench's numpy draws"})
    return bench


def main(argv=None):
    return cli("data_pruning", run, argv)


if __name__ == "__main__":
    main()
