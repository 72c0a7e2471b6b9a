"""SAMA training CLI of the port, on the MetaLearner facade:

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gemma3-1b] \
        [--smoke] [--steps 50] [--batch 8] [--seq 64] [--unroll 2] \
        [--method sama] [--device cuda]

Wires together: config registry -> synthetic data -> Model ->
data-optimization BilevelSpec with MetaWeightNet reweighting ->
``repro_torch.api.MetaLearner`` (Adam at both levels). Prints one JSON
line of metrics per logged step, as ``repro.launch.train`` does; the
metrics are read once per log, in one device-to-host copy. The weights
and the data are random, from ``--seed``. It runs on the card unless
``--device cpu`` is given (use it with ``--smoke`` on the CPU). The
default arch is gemma3-1b, as in the JAX CLI: its per-sequence LM loss
over 262,144 tokens takes the ``weighted_ce`` kernels; ``bert-base``
trains the encoder classifier.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import api, configs, data
from repro_torch.core import available_methods, problems
from repro_torch.core.engine import packed_read
from repro_torch.models import Model


def make_batch_fn(cfg, seq: int, device, rng: np.random.Generator):
    """``make_batch(batch, unroll=None)``: token sequences from the LM
    stream and, for an encoder, random labels, as ``repro.launch.train``
    draws them."""

    lm_cfg = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    def make_batch(batch, unroll=None):
        toks = data.lm_batch(lm_cfg, rng, batch * (unroll or 1))["tokens"]
        out = {"tokens": put(toks.reshape((unroll, batch, seq) if unroll else (batch, seq)))}
        if cfg.family == "encoder":
            yshape = (unroll, batch) if unroll else (batch,)
            out["y"] = put(rng.integers(0, cfg.num_labels, size=yshape).astype(np.int32))
        return out

    return make_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--unroll", type=int, default=2)
    ap.add_argument("--method", default="sama", choices=list(available_methods()))
    ap.add_argument("--base-lr", type=float, default=1e-3)
    ap.add_argument("--meta-lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    model = Model(cfg, device=args.device)
    spec = problems.make_data_optimization_spec(
        model.classifier_per_example if cfg.family == "encoder" else model.per_example,
        reweight=True,
    )
    learner = api.MetaLearner(spec, base_opt="adam", base_lr=args.base_lr,
                              meta_opt="adam", meta_lr=args.meta_lr,
                              method=args.method, unroll_steps=args.unroll)
    theta = model.init(args.seed)
    lam = problems.init_data_optimization_lam(args.seed + 1, reweight=True, device=model.device)
    learner.init(theta, lam)
    make_batch = make_batch_fn(cfg, args.seq, model.device, np.random.default_rng(args.seed))

    t0 = time.time()
    for i in range(args.steps):
        base = make_batch(args.batch, args.unroll)
        meta = make_batch(max(args.batch // 2, 1))
        metrics = learner.step(base, meta)
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: round(v, 4) for k, v in packed_read(metrics).items()}
            row["step"] = i
            row["elapsed_s"] = round(time.time() - t0, 1)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
