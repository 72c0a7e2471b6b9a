"""Peak memory and step time of the SAMA step by microbatch count and
precision policy on the card, the port's twin of ``benchmarks/bench_scale.py``
(the paper's memory lever: activation memory O(batch / M)).

    PYTHONPATH=src python -m repro_torch.perf.bench_scale [--out build/scale]

Each arm (policy, M) takes meta steps of gemma3-1b at full width and depth
(f32 parameters, the config's bf16 activations, the per-sequence LM loss
through ``weighted_ce``) with MetaWeightNet reweighting, Adam at both
levels, base batch 4, seq 1024, unroll 2, meta batch 4 (``BATCH``,
``SEQ``, ``UNROLL``, ``META_BATCH``), all arms from one state and one
batch. Per arm, through ``MetaLearner.profile`` (one warm-up call, three
timed): the step's wall time (median, range over the timed calls), samples/s and the peak of
``torch.cuda.max_memory_allocated`` over the timed calls, and each
kernel's launches over the measured calls, counted from 0 just before
them. An arm that exhausts the card (``torch.cuda.OutOfMemoryError``) is
recorded as such, with no peak. Writes ``BENCH_torch_scale.json`` through
``perf.write_bench``. It runs on the card unless ``--device cpu`` is given
(with ``--smoke``: the reduced config at ``SMOKE_SIZES``; on the CPU the
memory is the trees' bytes).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

#: the arms of the memory-by-M reading: (policy, microbatch count)
ARMS = (("bf16", 1), ("bf16", 2), ("bf16", 4))
#: the workload: base batch, sequence length, unroll steps, meta batch
BATCH, SEQ, UNROLL, META_BATCH = 4, 1024, 2, 4
#: calls per arm: one warm-up, then the timed calls
WARMUP, REPEATS = 1, 3
#: the reduced workload of ``--smoke`` (the CPU)
SMOKE_SIZES = dict(batch=4, seq=8, meta_batch=4, repeats=1)


def run(cfg=None, *, batch: int = BATCH, seq: int = SEQ, meta_batch: int = META_BATCH,
        arms: Sequence[Tuple[str, int]] = ARMS, repeats: int = REPEATS,
        device="cuda", seed: int = 0, log=None) -> List[Any]:
    """Profile the meta step once per arm; returns the PerfRecords (their
    ``extra`` holds the arm, the launches and whether it ran out of
    memory). ``cfg`` defaults to gemma3-1b; the sizes are the bench's own
    unless the CPU's ``SMOKE_SIZES`` are passed, and ``meta_batch`` is
    halved where the full one does not fit (``chip_smoke.py``)."""
    from repro_torch import api, configs, perf, scale
    from repro_torch.core import problems
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import Model

    cfg = cfg or configs.get_config("gemma3-1b")
    model = Model(cfg, device=device)
    on_card = model.device.type == "cuda"
    make_batch = make_batch_fn(cfg, seq, model.device, np.random.default_rng(seed))
    base_b, meta_b = make_batch(batch, UNROLL), make_batch(meta_batch)
    per_example = (model.classifier_per_example if cfg.family == "encoder"
                   else model.per_example)
    spec = problems.make_data_optimization_spec(per_example, reweight=True)
    theta = model.init(seed)
    lam = problems.init_data_optimization_lam(seed + 1, reweight=True, device=model.device)
    records = []
    for policy, m in arms:
        t_arm = time.perf_counter()
        learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                                  meta_lr=1e-3, unroll_steps=UNROLL,
                                  scale=scale.ScaleConfig(policy=policy, microbatch=m))
        learner.init(theta, lam)
        dispatch.reset_launches()  # counts of this arm's measured calls only
        extra = {"policy": policy, "microbatch": m, "arch": cfg.name, "dtype": cfg.dtype,
                 "batch": batch, "seq": seq, "unroll": UNROLL, "meta_batch": meta_batch}
        try:
            rec = learner.profile(base_b, meta_b, warmup=WARMUP, repeats=repeats,
                                  name=f"scale_{policy}_m{m}",
                                  samples_per_step=batch * UNROLL)
            extra["out_of_memory"] = False
        except torch.cuda.OutOfMemoryError:
            # recorded, not hidden: this arm does not fit the card
            mem = perf.memory_report(example_args=(learner.state, base_b, meta_b))
            mem["per_device"]["source"] = "out_of_memory"
            rec = perf.PerfRecord(name=f"scale_{policy}_m{m}", memory=mem)
            extra["out_of_memory"] = True
        extra.update({"launches": dispatch.launch_counts(), "steps_counted": WARMUP + repeats,
                      "tokens_per_step": batch * UNROLL * seq,
                      "bench_s": time.perf_counter() - t_arm})
        rec.extra.update(extra)
        records.append(rec)
        if log is not None:
            log(rec)
        del learner
        if on_card:
            torch.cuda.empty_cache()
    return records


def row(rec) -> Dict[str, Any]:
    """The bench file's row of one record."""
    mem = rec.memory or {}
    peak = mem.get("per_device", {}).get("peak_bytes")
    timing = rec.us_per_step or {}
    return {"name": rec.name, "us_per_call": timing.get("median_us"),
            "derived": {"policy": rec.extra["policy"], "microbatch": rec.extra["microbatch"],
                        "peak_mb": None if peak is None else peak / 2**20,
                        "samples_per_s": rec.samples_per_s,
                        "out_of_memory": rec.extra["out_of_memory"]}}


def write(out_dir: str, records, elapsed_s: float) -> str:
    from repro_torch import perf

    path = os.path.join(out_dir, "BENCH_torch_scale.json")
    perf.write_bench(path, perf.bench_payload("torch_scale", fast=False, elapsed_s=elapsed_s,
                                              rows=[row(r) for r in records],
                                              records=records))
    return path


def main(argv=None):
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("build", "scale"))
    ap.add_argument("--smoke", action="store_true", help="reduced config and sizes (CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg, sizes = configs.get_smoke_config("gemma3-1b"), SMOKE_SIZES
    else:
        cfg, sizes = configs.get_config("gemma3-1b"), {}
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    records = run(cfg, device=args.device,
                  log=lambda rec: print(json.dumps(row(rec)), flush=True), **sizes)
    print(write(args.out, records, time.perf_counter() - t0))


if __name__ == "__main__":
    main()
