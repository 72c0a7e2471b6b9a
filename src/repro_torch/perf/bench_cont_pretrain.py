"""Paper Table 3 on the card: continued pretraining as one-stage multitask
learning with a SAMA-reweighted auxiliary loss, the port's twin of
``benchmarks/bench_cont_pretrain.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_cont_pretrain \
        [--device cpu] [--full] [--out DIR]

Synthetic analogue, as in the JAX bench: the fine-tune task is language
modeling on a structured stream (the Markov stream of ``data.lm_batch``);
the auxiliary corpus is a 50/50 mix of in-domain data and harmful
(uniform) tokens, all drawn from the same numpy seeds. Arms: ft-only Adam,
TARTAN-MT (ft + equally weighted aux) and SAMA (ft + meta-reweighted aux
through ``problems.make_auxiliary_spec``, unroll 2, base Adam 1e-3, meta
Adam 3e-3), on gemma3-1b's smoke config (remat off), from one seeded
init. Metric: the held-out ft loss (lower is better), then the learned
weights of in-domain and harmful auxiliary sequences. The paper's claims
(SAMA < TARTAN-MT < ft-only; in-domain weighted above harmful) are
recorded, not asserted: the JAX bench asserts nothing. Writes
``BENCH_torch_cont_pretrain.json``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.perf.common import Bench, cli


def _streams(cfg, n, seq, seed):
    from repro_torch import data

    lm = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq, markov_strength=0.8)
    rng = np.random.default_rng(seed)
    indomain = data.lm_batch(lm, rng, n)["tokens"]
    harmful = rng.integers(0, cfg.vocab_size, size=(n, seq)).astype(np.int32)  # no structure
    return indomain, harmful


def run(*, fast: bool = True, device="cuda", steps=None, n_train: int = 256,
        n_meta: int = 128, n_test: int = 256) -> Bench:
    """The three arms. ``steps`` defaults to the JAX bench's (60, or 250
    with ``fast=False``); the plain arms take twice as many."""
    from repro_torch import configs, optim
    from repro_torch.core import problems
    from repro_torch.core.meta_modules import apply_weight_net, weight_features
    from repro_torch.core.sama import value_and_grad
    from repro_torch.api import MetaLearner
    from repro_torch.models import Model
    from repro_torch.perf import synchronize

    cfg = configs.get_smoke_config("gemma3-1b").replace(remat=False)
    model = Model(cfg, device=device)
    bench = Bench("cont_pretrain")
    dev = model.device
    seq, batch = 32, 16
    steps = steps or (60 if fast else 250)

    ft_train, _ = _streams(cfg, n_train, seq, seed=0)
    ft_meta, _ = _streams(cfg, n_meta, seq, seed=1)
    ft_test, _ = _streams(cfg, n_test, seq, seed=2)
    aux_in, aux_bad = _streams(cfg, n_train, seq, seed=3)
    aux_all = np.concatenate([aux_in, aux_bad])  # first half in-domain

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def ft_loss(theta, b):
        return model.lm_loss(theta, b)

    spec = problems.make_auxiliary_spec(ft_loss, model.per_example)
    rng = np.random.default_rng(0)  # one stream across the arms, as in JAX

    def batches(k: int):
        while True:
            fi = rng.integers(0, len(ft_train), (k, batch))
            ai = rng.integers(0, len(aux_all), (k, batch))
            mi = rng.integers(0, len(ft_meta), batch)
            base = {"ft": {"tokens": put(ft_train[fi])}, "pt": {"tokens": put(aux_all[ai])}}
            meta = {"ft": {"tokens": put(ft_meta[mi])}}
            yield base, meta

    @torch.no_grad()
    def test_loss(theta):
        losses = [float(ft_loss(theta, {"tokens": put(ft_test[i:i + 64])}))
                  for i in range(0, len(ft_test), 64)]
        return float(np.mean(losses))

    def plain_arm(loss_fn, strip):
        theta = model.init(0)
        opt = optim.adam(1e-3)
        st = opt.init(theta)
        grad_fn = value_and_grad(loss_fn, 0)
        it = batches(1)
        synchronize()
        t0 = time.perf_counter()
        for _ in range(steps * 2):
            b, _ = next(it)
            _, g = grad_fn(theta, strip(b))
            upd, st = opt.update(g, st, theta)
            theta = optim.apply_updates(theta, upd)
        synchronize()
        return theta, (time.perf_counter() - t0) * 1e6 / steps

    # --- Baseline: ft only ---
    theta, us = plain_arm(ft_loss, lambda b: {"tokens": b["ft"]["tokens"][0]})
    bench.emit("table3_baseline_ft_only", us, f"test_loss={test_loss(theta):.4f}")

    # --- TARTAN-MT: equal aux weights (multitask) ---
    def mt_loss(th, b):
        return ft_loss(th, b["ft"]) + torch.mean(model.per_example(th, b["pt"]).loss)

    theta, us = plain_arm(mt_loss, lambda b: {"ft": {"tokens": b["ft"]["tokens"][0]},
                                              "pt": {"tokens": b["pt"]["tokens"][0]}})
    bench.emit("table3_tartan_mt", us, f"test_loss={test_loss(theta):.4f}")

    # --- SAMA: meta-reweighted aux ---
    learner = MetaLearner(spec, base_opt=optim.adam(1e-3), meta_opt=optim.adam(3e-3),
                          method="sama", unroll_steps=2)
    learner.init(model.init(0), problems.init_data_optimization_lam(5, reweight=True,
                                                                    device=dev))
    synchronize()
    t0 = time.perf_counter()
    learner.fit(batches(2), steps, log_every=steps)
    synchronize()
    bench.emit("table3_sama", (time.perf_counter() - t0) * 1e6 / steps,
               f"test_loss={test_loss(learner.state.theta):.4f}")

    # diagnostics: learned weights should split in- vs out-of-domain
    with torch.no_grad():
        pe = model.per_example(learner.state.theta, {"tokens": put(aux_all[::4])})
        w = apply_weight_net(learner.state.lam["reweight"], weight_features(pe.loss))
    half = len(aux_all[::4]) // 2
    bench.emit("table3_sama_weight_split", 0.0,
               f"w_indomain={float(torch.mean(w[:half])):.3f};"
               f"w_harmful={float(torch.mean(w[half:])):.3f}")

    loss = {r: bench.derived(f"table3_{r}")["test_loss"]
            for r in ("baseline_ft_only", "tartan_mt", "sama")}
    bench.claim("sama<tartan_mt<ft_only (test loss)",
                loss["sama"] < loss["tartan_mt"] < loss["baseline_ft_only"])
    split = bench.derived("table3_sama_weight_split")
    bench.claim("w_indomain>w_harmful", split["w_indomain"] > split["w_harmful"])
    bench.notes.update({"arch": cfg.name, "steps": steps, "batch": batch, "seq": seq,
                        "init": "torch generator seed 0 (not the JAX draws); the data are "
                                "the JAX bench's numpy draws"})
    return bench


def main(argv=None):
    return cli("cont_pretrain", run, argv)


if __name__ == "__main__":
    main()
