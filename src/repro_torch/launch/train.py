"""SAMA training CLI of the port, on the MetaLearner facade:

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gemma3-1b] \
        [--smoke] [--steps 50] [--batch 8] [--seq 64] [--unroll 2] \
        [--method sama] [--device cuda] [--ckpt out/ck] \
        [--precision bf16] [--microbatch 4 | --hbm-budget-gb 40] \
        [--manual-collectives] [--production-mesh]

    torchrun --standalone --nproc_per_node N -m repro_torch.launch.train --arch bert-base \
        --production-mesh --manual-collectives

Wires together: config registry -> synthetic data -> Model ->
data-optimization BilevelSpec with MetaWeightNet reweighting ->
``repro_torch.api.MetaLearner`` (Adam at both levels). Prints one JSON
line of metrics per logged step, as ``repro.launch.train`` does; the
metrics are read once per log, in one device-to-host copy. With ``--ckpt``
the final state is saved to ``{ckpt}/step_NNNNNN`` in the JAX package's
checkpoint format and a last JSON line names it. The weights
and the data are random, from ``--seed``. It runs on the card unless
``--device cpu`` is given (use it with ``--smoke`` on the CPU). The
default arch is gemma3-1b, as in the JAX CLI: its per-sequence LM loss
over 262,144 tokens takes the ``weighted_ce`` kernels; ``bert-base``
trains the encoder classifier.

The scale knobs (``repro_torch.scale``): ``--precision`` picks the policy
(f32, bf16, f16), ``--microbatch`` forces an accumulation factor, and
``--hbm-budget-gb`` asks the planner (``scale.plan_microbatch``) for the
smallest M whose step fits that budget instead; a line
``{"planner": {...}}`` then comes first. On the card the planner runs
each candidate step it measures (from the initial state, which does not
advance).

The distributed knobs (``repro_torch.launch``): ``--production-mesh`` runs
data parallel over the ``torchrun`` ranks (NCCL, one card each:
``launch.mesh.make_production_mesh``) with the global-batch step unless
``--manual-collectives`` takes the paper's single-sync schedule;
``--manual-collectives`` alone runs that schedule on the 1-rank host mesh.
Every rank draws the same global batches and steps on its rows; rank 0
prints the lines. A startup line ``{"run": {...}}`` with the mesh's shape
and the schedule goes to standard error, so that standard output stays
one JSON line per logged step.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import api, configs, data, scale
from repro_torch.core import available_methods, problems
from repro_torch.core.engine import packed_read
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Model


def make_batch_fn(cfg, seq: int, device, rng: np.random.Generator):
    """``make_batch(batch, unroll=None)``: token sequences from the LM
    stream; for an encoder, random labels; for the audio and vision
    families, zero ``frames`` (encoder_seq, d_model) and ``patches``
    (vision_tokens, vision_dim) f32 per sequence: as ``repro.launch.train``
    draws them."""

    lm_cfg = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    def make_batch(batch, unroll=None):
        toks = data.lm_batch(lm_cfg, rng, batch * (unroll or 1))["tokens"]
        out = {"tokens": put(toks.reshape((unroll, batch, seq) if unroll else (batch, seq)))}
        lead = (unroll, batch) if unroll else (batch,)
        if cfg.family == "vlm":
            out["patches"] = torch.zeros(lead + (cfg.vision_tokens, cfg.vision_dim),
                                         dtype=torch.float32, device=device)
        if cfg.family == "audio":
            out["frames"] = torch.zeros(lead + (cfg.encoder_seq, cfg.d_model),
                                        dtype=torch.float32, device=device)
        if cfg.family == "encoder":
            out["y"] = put(rng.integers(0, cfg.num_labels, size=lead).astype(np.int32))
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
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--precision", default="f32", choices=sorted(scale.POLICIES),
                    help="repro_torch.scale precision policy")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="accumulate each base batch as M microbatches")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="let scale.plan_microbatch pick the smallest M whose step fits "
                         "this device-memory budget (overrides --microbatch)")
    ap.add_argument("--manual-collectives", action="store_true",
                    help="the paper's single-sync schedule (launch.distributed)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="data parallel over the torchrun ranks, NCCL, one card each")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.production_mesh:
        mesh = make_production_mesh()
        device = mesh.device
    else:
        mesh = make_host_mesh(args.device) if args.manual_collectives else None
        device = args.device
    lead = mesh is None or mesh.rank == 0
    schedule = "single_sync" if args.manual_collectives else "pjit"
    model = Model(cfg, device=device)
    spec = problems.make_data_optimization_spec(
        model.classifier_per_example if cfg.family == "encoder" else model.per_example,
        reweight=True,
    )
    scale_cfg = scale.ScaleConfig(policy=args.precision, microbatch=args.microbatch)
    learner_args = dict(base_opt="adam", base_lr=args.base_lr, meta_opt="adam",
                        meta_lr=args.meta_lr, method=args.method, unroll_steps=args.unroll,
                        checkpoint_dir=args.ckpt, mesh=mesh, schedule=schedule)
    learner = api.MetaLearner(spec, scale=scale_cfg, **learner_args)
    theta = model.init(args.seed)
    lam = problems.init_data_optimization_lam(args.seed + 1, reweight=True, device=model.device)
    learner.init(theta, lam)
    if args.hbm_budget_gb is not None:
        # the learner's batch shapes from a throwaway stream, so that the
        # training stream is a --microbatch run's
        plan_batch = make_batch_fn(cfg, args.seq, model.device, np.random.default_rng(args.seed))
        plan = scale.plan_microbatch(
            spec, learner.base_opt, learner.meta_opt, learner.cfg, learner.state,
            plan_batch(args.batch, args.unroll), plan_batch(max(args.batch // 2, 1)),
            hbm_budget=int(args.hbm_budget_gb * 2 ** 30), mesh=mesh, schedule=schedule)
        if lead:
            print(json.dumps({"planner": {"microbatch": plan.microbatch, "fits": plan.fits,
                                          "peak_bytes": plan.peak_bytes, "source": plan.source,
                                          "budget_gb": args.hbm_budget_gb,
                                          "candidates": plan.candidates}}), flush=True)
        if plan.microbatch != scale_cfg.microbatch:
            learner = api.MetaLearner(spec, scale=plan.scale, **learner_args)
            learner.init(theta, lam)
    make_batch = make_batch_fn(cfg, args.seq, model.device, np.random.default_rng(args.seed))
    if lead:
        print(json.dumps({"run": {
            "arch": cfg.name, "params": model.num_params(theta), "method": args.method,
            "schedule": learner.schedule, "precision": args.precision,
            "microbatch": learner.cfg.scale.microbatch, "device": str(model.device),
            "mesh": dict(mesh.shape) if mesh is not None else None,
            "backend": mesh.backend if mesh is not None else None}}), file=sys.stderr,
            flush=True)

    t0 = time.time()
    for i in range(args.steps):
        base = make_batch(args.batch, args.unroll)
        meta = make_batch(max(args.batch // 2, 1))
        metrics = learner.step(base, meta)
        if (i % args.log_every == 0 or i == args.steps - 1) and lead:
            row = {k: round(v, 4) for k, v in packed_read(metrics).items()}
            row["step"] = i
            row["elapsed_s"] = round(time.time() - t0, 1)
            print(json.dumps(row), flush=True)
    if args.ckpt:
        path = learner.save(meta={"arch": cfg.name})
        if lead:
            print(json.dumps({"checkpoint": path}), flush=True)
    if args.production_mesh:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
