"""The single-sync schedule against the global-batch (naive-DDP) step on
N ranks, the port's twin of ``benchmarks/bench_distributed.py`` (paper
Table 2's multi-GPU rows, Fig. 2).

    PYTHONPATH=src python -m repro_torch.perf.bench_distributed \
        [--world 2] [--backend gloo] [--device cuda] [--smoke] [--out build/distributed]

Spawns ``--world`` ranks (``launch.distributed.spawn``) of one process
group over ``--backend``; each builds ``mini_bert`` (the bert-base smoke
encoder at d_model 128, 2 layers, 4 labels, f32; ``benchmarks/common.py``)
with MetaWeightNet reweighting, Adam at both levels, unroll 2, global base
batch 64, meta batch 32, seq 32 (``--smoke``: 8, 8, 16), and runs SAMA's
manual and pjit steps from one state: per schedule the collective census
of one step (``perf.collectives``: all-reduce calls and bytes, the
single-sync verdict) and the step's wall time over five calls (``--smoke``:
one) after one warm-up (``perf.time_callable``, synchronized). Rank 0 writes
``BENCH_torch_distributed.json`` (``perf.write_bench``) with the world
size and backend. NCCL takes one card per rank; ranks that share one card
take gloo, which stages every all-reduce through the host, so their wall
times say nothing of the paper's multi-GPU throughput. It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

UNROLL = 2
#: global base batch, meta batch, sequence length, timed calls per schedule
SIZES = dict(batch=64, meta_batch=32, seq=32, repeats=5)
SMOKE_SIZES = dict(batch=8, meta_batch=8, seq=16, repeats=1)


def _rank(rank: int, device: str, sizes: Dict[str, int], out_path: str):
    from repro_torch import configs, optim, perf
    from repro_torch.core import EngineConfig, init_state, problems
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import Model
    from repro_torch.perf import collectives

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    elif torch.cuda.device_count() > 1:  # one card per rank; one card is shared
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_data_mesh(device=device)
    cfg = configs.get_smoke_config("bert-base").replace(
        d_model=128, num_layers=2, num_labels=4, num_heads=2, num_kv_heads=2, head_dim=64,
        d_ff=256, remat=False, dtype="float32")
    model = Model(cfg, device=mesh.device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    bo, mo = optim.adam(1e-3), optim.adam(1e-3)
    ecfg = EngineConfig(method="sama", unroll_steps=UNROLL)
    state = init_state(model.init(0), problems.init_data_optimization_lam(
        1, device=mesh.device), bo, mo)
    rng = np.random.default_rng(0)
    b, mb, s = sizes["batch"], sizes["meta_batch"], sizes["seq"]
    put = lambda x: torch.from_numpy(x).to(mesh.device)  # noqa: E731
    bb = {"tokens": put(rng.integers(0, cfg.vocab_size, (UNROLL, b, s)).astype(np.int32)),
          "y": put(rng.integers(0, 4, (UNROLL, b)).astype(np.int32))}
    mbat = {"tokens": put(rng.integers(0, cfg.vocab_size, (mb, s)).astype(np.int32)),
            "y": put(rng.integers(0, 4, mb).astype(np.int32))}
    out = {}
    for sched, make in (("manual", D.make_manual_step), ("pjit", D.make_pjit_step)):
        step = make(spec, bo, mo, ecfg, mesh)
        with D.CollectiveCounter() as counter:
            step(state, bb, mbat)
        timing = perf.time_callable(step, state, bb, mbat, warmup=1, repeats=sizes["repeats"])
        census = (collectives.verify_single_sync(counter, UNROLL) if sched == "manual"
                  else collectives.census(counter))
        out[sched] = {"census": census, "timing": timing}
    if rank == 0:
        torch.save({"out": out, "world": mesh.size, "backend": mesh.backend,
                    "device": str(mesh.device)}, out_path)


def run(world: int = 2, backend: str = "gloo", device: str = "cuda", smoke: bool = False,
        out_dir: str = os.path.join("build", "distributed")) -> str:
    """Spawn the ranks; returns the path of ``BENCH_torch_distributed.json``."""
    from repro_torch import perf
    from repro_torch.device import resolve_device
    from repro_torch.launch import distributed as D

    resolve_device(device)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards; share a card over gloo")
    sizes = SMOKE_SIZES if smoke else SIZES
    os.makedirs(out_dir, exist_ok=True)
    raw = os.path.join(out_dir, "ranks.pt")
    t0 = time.perf_counter()
    D.spawn(_rank, world, (device, sizes, raw), store_dir=out_dir, backend=backend)
    got = torch.load(raw, weights_only=False)
    os.remove(raw)
    records, rows = [], []
    extra_common = {"unroll_steps": UNROLL, "world": got["world"], "backend": got["backend"],
                    "device": got["device"], **sizes}
    for sched in ("manual", "pjit"):
        r = got["out"][sched]
        rec = perf.PerfRecord(name=f"fig2_{sched}_step", us_per_step=r["timing"].as_dict(),
                              collectives=r["census"],
                              extra={"schedule": "single_sync" if sched == "manual"
                                     else "pjit", **extra_common})
        records.append(rec)
        rows.append({"name": rec.name, "us_per_call": r["timing"].median_us,
                     "derived": {"all_reduces_per_step": r["census"]["all-reduce_count"],
                                 "all_reduce_bytes_per_step": r["census"]["all-reduce_bytes"],
                                 "world": got["world"], "backend": got["backend"]}})
    path = os.path.join(out_dir, "BENCH_torch_distributed.json")
    perf.write_bench(path, perf.bench_payload("torch_distributed", fast=smoke,
                                              elapsed_s=time.perf_counter() - t0, rows=rows,
                                              records=records))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced sizes (CPU)")
    ap.add_argument("--out", default=os.path.join("build", "distributed"))
    args = ap.parse_args(argv)
    path = run(args.world, args.backend, args.device, args.smoke, args.out)
    for row in json.load(open(path))["rows"]:
        print(json.dumps(row), flush=True)
    print(path)


if __name__ == "__main__":
    main()
