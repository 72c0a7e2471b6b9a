"""SAMA training CLI of the port, on the MetaLearner facade:

    PYTHONPATH=src python -m repro_torch.launch.train [--arch gemma3-1b] \
        [--smoke] [--steps 50] [--batch 8] [--seq 64] [--unroll 2] \
        [--method sama] [--device cuda] [--ckpt out/ck] \
        [--precision bf16] [--microbatch 4 | --hbm-budget-gb 40] \
        [--manual-collectives] [--production-mesh] \
        [--obs-log run.jsonl] [--chrome-trace trace.json]

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

Every line goes through one ``repro_torch.obs`` pipeline: its console
sinks print the lines above (and a health monitor's alert, such as a
skipped f16 meta update, to standard error), and ``--obs-log PATH`` adds
the JSONL event
stream (``run_start``, the metrics and any loss-scale, gate and alert
events, the kernels' routing, a ``registry_snapshot`` and ``run_end``) for
``python -m repro_torch.obs.report``, leaving standard output as it is.
With ``--obs-log`` or ``--chrome-trace PATH`` the CLI first runs
``MetaLearner.phase_profile`` on batches of its own random stream (the
training stream is unchanged; the state does not advance), whose phase
spans go to the log and to the chrome trace (then a line
``{"chrome_trace": {...}}``); with ``--obs-log`` and
``--manual-collectives`` a last step checks the collective census
(``verify_census``: a ``census`` event and a line ``{"census": {...}}``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import api, configs, data, scale
from repro_torch import obs as obs_mod
from repro_torch.core import available_methods, problems
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
    ap.add_argument("--obs-log", default=None, metavar="PATH",
                    help="append structured events (JSONL) for "
                         "`python -m repro_torch.obs.report`")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="write a chrome://tracing file of the per-phase span profile")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.production_mesh:
        mesh = make_production_mesh()
        device = mesh.device
    else:
        mesh = make_host_mesh(args.device) if args.manual_collectives else None
        device = args.device
    lead = mesh is None or mesh.rank == 0
    obs = obs_mod.NULL_OBS
    if lead:
        # the console sinks print the CLI's lines: the metrics, checkpoint
        # and planner lines to standard output, the startup line and any
        # health alert to standard error; --obs-log adds the JSONL the
        # report CLI reads
        sinks = [obs_mod.ConsoleSink(kinds=("log", "metrics")),
                 obs_mod.ConsoleSink(sys.stderr, kinds=("run", "alert"))]
        if args.obs_log:
            sinks.append(obs_mod.JsonlSink(args.obs_log))
        obs = obs_mod.Obs(sink=obs_mod.TeeSink(sinks),
                          run_id=f"train-{args.arch}-{args.method}")
    obs_mod.set_default(obs)  # the kernels' routing decisions
    try:
        _train(args, cfg, mesh, device, obs)
    finally:
        obs.close()
        obs_mod.set_default(None)
    if args.production_mesh:
        torch.distributed.destroy_process_group()


def _train(args, cfg, mesh, device, obs):
    schedule = "single_sync" if args.manual_collectives else "pjit"
    model = Model(cfg, device=device)
    spec = problems.make_data_optimization_spec(
        model.classifier_per_example if cfg.family == "encoder" else model.per_example,
        reweight=True,
    )
    scale_cfg = scale.ScaleConfig(policy=args.precision, microbatch=args.microbatch)
    learner_args = dict(base_opt="adam", base_lr=args.base_lr, meta_opt="adam",
                        meta_lr=args.meta_lr, method=args.method, unroll_steps=args.unroll,
                        checkpoint_dir=args.ckpt, mesh=mesh, schedule=schedule, obs=obs)
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
        fields = {"microbatch": plan.microbatch, "fits": plan.fits,
                  "peak_bytes": plan.peak_bytes, "source": plan.source,
                  "budget_gb": args.hbm_budget_gb}
        obs.log("planner", json.dumps({"planner": {**fields, "candidates": plan.candidates}}),
                **fields)
        if plan.microbatch != scale_cfg.microbatch:
            learner = api.MetaLearner(spec, scale=plan.scale, **learner_args)
            learner.init(theta, lam)
    make_batch = make_batch_fn(cfg, args.seq, model.device, np.random.default_rng(args.seed))
    obs.emit("run", "run_start", data={
        "arch": cfg.name, "params": model.num_params(theta), "method": args.method,
        "schedule": learner.schedule, "precision": args.precision,
        "microbatch": learner.cfg.scale.microbatch, "device": str(model.device),
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "backend": mesh.backend if mesh is not None else None})

    if args.obs_log or args.chrome_trace:
        # one step under the span tracer, on batches of a stream of its
        # own: the training stream is unchanged and the state does not
        # advance
        prof_batch = make_batch_fn(cfg, args.seq, model.device, np.random.default_rng(2 ** 20))
        spans = learner.phase_profile(prof_batch(args.batch, args.unroll),
                                      prof_batch(max(args.batch // 2, 1)))
        if args.chrome_trace and obs.enabled:
            obs_mod.write_chrome_trace(args.chrome_trace, spans)
            obs.log("chrome_trace", json.dumps({"chrome_trace": {
                "path": args.chrome_trace, "spans": len(spans)}}), path=args.chrome_trace)

    t0 = time.time()
    for i in range(args.steps):
        base = make_batch(args.batch, args.unroll)
        meta = make_batch(max(args.batch // 2, 1))
        metrics = learner.step(base, meta)
        if (i % args.log_every == 0 or i == args.steps - 1) and obs.enabled:
            # one device-to-host copy for the whole metric dict; the console
            # prints it with the step and the wall clock
            row = {k: round(v, 4) for k, v in obs_mod.packed_read(metrics).items()}
            row["elapsed_s"] = round(time.time() - t0, 1)
            obs.observe_step(i, row)
    if args.manual_collectives and args.obs_log:
        census = learner.verify_census(base, meta)  # every rank: it runs collectives
        obs.log("census", json.dumps({"census": {
            "all_reduces": census.get("all-reduce_count", 0),
            "expected": census["expected_all_reduces"], "ok": census["single_sync_ok"]}}))
    if args.ckpt:
        path = learner.save(meta={"arch": cfg.name})
        obs.log("checkpoint", json.dumps({"checkpoint": path}), path=path)
    if args.obs_log:  # for the report CLI, not the console
        obs.emit("metrics", "registry_snapshot", data=obs.metrics.snapshot())
    obs.emit("run", "run_end", data={
        "elapsed_s": round(time.time() - t0, 1), "steps": args.steps,
        "health": obs.health.status if obs.health is not None else None,
        "ring_dropped": obs.sink_dropped()})

if __name__ == "__main__":
    main()
