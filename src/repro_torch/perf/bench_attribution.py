"""The per-phase attribution's acceptance bench, the port's twin of
``benchmarks/bench_attribution.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_attribution [--device cpu] \
        [--full] [--out DIR]

Arms, each hard-asserted before its record:

* ``attribution_sama``: the WRENCH-analog mini-BERT SAMA step (batch 48,
  unroll 2; the Table 2 configuration of the reference's bench):
  ``perf.profile_step(attribution=True)`` (one warm-up and three timed
  calls, ``--full``: two and five) with the per-phase wall times of one
  step under a span tracer that synchronises at each span's end
  (``MetaLearner.phase_profile``'s protocol), so each phase carries its
  utilization. Coverage >= 0.90 and ``attention.py`` the top FLOP sink.
* ``attribution_manual``: the single-sync schedule on two gloo ranks on
  the host (``launch.distributed.spawn``; the reference forces 8 host
  devices), whatever ``device`` the bench runs on: the arm checks where
  the collectives fall, not the card. The step attributed on each rank:
  coverage >= 0.90, no collective outside
  ``base_unroll`` and ``allreduce_flat``, exactly one on
  ``allreduce_flat`` (which carries every byte of the meta all-reduce) and
  unroll + 1 in all.

Writes ``BENCH_torch_attribution.json``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.perf.common import Bench, cli

BATCH, UNROLL = 48, 2
COVERAGE_FLOOR = 0.90
TOP_MODULE = "attention.py"


def _sama_arm(bench: Bench, device, fast: bool):
    from repro_torch import data, obs as obs_mod, optim, perf
    from repro_torch.core import EngineConfig, init_state, make_meta_step, problems
    from repro_torch.perf.common import mini_bert, wrench_task

    warmup, repeats = (1, 3) if fast else (2, 5)
    ccfg, train, meta, _ = wrench_task(seed=8)
    model = mini_bert(num_labels=ccfg.num_classes, d_model=128, device=device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    lam = problems.init_data_optimization_lam(1, reweight=True, device=device)
    it = data.BatchIterator(train, meta, batch_size=BATCH, meta_batch_size=BATCH,
                            unroll=UNROLL, seed=0, device=device)
    base_b, meta_b = next(it)
    base_opt, meta_opt = optim.adam(1e-3), optim.adam(1e-3)
    cfg = EngineConfig(method="sama", unroll_steps=UNROLL)
    state = init_state(model.init(0), lam, base_opt, meta_opt, scale=cfg.scale)
    step = make_meta_step(spec, base_opt, meta_opt, cfg)

    step(state, base_b, meta_b)  # the kernels built before the spans
    tracer = obs_mod.Tracer(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    with obs_mod.activate(tracer):
        step(state, base_b, meta_b)
    rec = perf.profile_step("attribution_sama", step, state, base_b, meta_b,
                            samples_per_step=BATCH * UNROLL, warmup=warmup, repeats=repeats,
                            extra={"method": "sama", "batch": BATCH, "unroll": UNROLL},
                            attribution=True, attribution_spans=tracer.runtime_spans())
    attr = rec.attribution
    if attr["coverage"] < COVERAGE_FLOOR:
        raise AssertionError(f"attribution coverage {attr['coverage']:.3f} below the "
                             f"{COVERAGE_FLOOR} floor: phases are not reaching the count")
    if attr["top_module"] != TOP_MODULE:
        raise AssertionError(f"top FLOP sink is {attr['top_module']!r}, expected "
                             f"{TOP_MODULE!r}: the FLOP model or module attribution moved")
    bench.emit_record(rec)
    phases = attr["phases"]
    top_phase = next(iter(phases))
    bench.emit("attribution_sama", rec.us_per_step["median_us"],
               f"coverage={attr['coverage']:.4f};top_phase={top_phase};"
               f"top_phase_frac={phases[top_phase]['flop_frac']:.3f};"
               f"top_module={attr['top_module']}")
    return rec


def _manual_rank(rank: int, out_path: str):
    from repro_torch import optim
    from repro_torch.core import EngineConfig, init_state, problems
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.obs import profile
    from repro_torch.perf.common import mini_bert

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))
    mesh = make_data_mesh(device="cpu")
    model = mini_bert(num_labels=4, d_model=128, device=mesh.device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    bo, mo = optim.adam(1e-3), optim.adam(1e-3)
    cfg = EngineConfig(method="sama", unroll_steps=UNROLL)
    state = init_state(model.init(0), problems.init_data_optimization_lam(
        1, device=mesh.device), bo, mo, scale=cfg.scale)
    k, b, s, mb = UNROLL, 16, 32, 8
    rng = np.random.default_rng(0)
    put = lambda x: torch.from_numpy(x).to(mesh.device)  # noqa: E731
    bb = {"tokens": put(rng.integers(0, model.cfg.vocab_size, (k, b, s)).astype(np.int32)),
          "y": put(rng.integers(0, 4, (k, b)).astype(np.int32))}
    mbat = {"tokens": put(rng.integers(0, model.cfg.vocab_size, (mb, s)).astype(np.int32)),
            "y": put(rng.integers(0, 4, mb).astype(np.int32))}
    step = D.make_manual_step(spec, bo, mo, cfg, mesh)
    attr = profile.attribute(step, state, bb, mbat, n_devices=mesh.size)
    if rank == 0:
        torch.save({"attribution": attr, "world": mesh.size, "backend": mesh.backend}, out_path)


def _manual_arm(bench: Bench):
    from repro_torch import perf
    from repro_torch.launch import distributed as D

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        D.spawn(_manual_rank, 2, (out,), store_dir=tmp, backend="gloo")
        got = torch.load(out, weights_only=False)
    attr = got["attribution"]
    if attr["coverage"] < COVERAGE_FLOOR:
        raise AssertionError(f"manual-schedule attribution coverage {attr['coverage']:.3f} "
                             f"below the {COVERAGE_FLOOR} floor")
    phases = attr["phases"]
    stray = sum(b["collective_count"] for ph, b in phases.items()
                if ph not in ("base_unroll", "allreduce_flat"))
    flat = phases.get("allreduce_flat", {}).get("collective_count", 0)
    if stray or flat != 1:
        raise AssertionError(f"collective attribution broke the single-sync shape: {stray} "
                             f"stray collectives in the hypergradient phases, {flat} on "
                             "allreduce_flat (expected exactly 1)")
    total = attr["total"]["collective_count"]
    if total != UNROLL + 1:
        raise AssertionError(f"{total} attributed collectives, expected unroll + 1 = "
                             f"{UNROLL + 1}")
    rec = perf.PerfRecord(name="attribution_manual", attribution=attr,
                          extra={"schedule": "single_sync", "unroll_steps": UNROLL,
                                 "ranks": got["world"], "backend": got["backend"]})
    bench.emit_record(rec)
    ar = phases.get("allreduce_flat", {})
    bench.emit("attribution_manual", 0.0,
               f"coverage={attr['coverage']:.4f};"
               f"allreduce_bytes={ar.get('collective_bytes', 0):.3e};"
               f"allreduce_count={ar.get('collective_count', 0):.0f}")


def run(*, fast: bool = True, device="cuda") -> Bench:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    bench = Bench("attribution")
    _sama_arm(bench, dev, fast)
    _manual_arm(bench)
    bench.notes.update({"asserts": [
        f"coverage >= {COVERAGE_FLOOR} on both arms", f"{TOP_MODULE} the top FLOP sink of the "
        "SAMA step", "the manual step's collectives: unroll on base_unroll, one on "
        "allreduce_flat, none elsewhere"]})
    return bench


def main(argv=None):
    return cli("attribution", run, argv)


if __name__ == "__main__":
    main()
