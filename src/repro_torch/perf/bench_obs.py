"""What observability costs the training loop, the port's twin of
``benchmarks/bench_obs.py``:

    PYTHONPATH=src python -m repro_torch.perf.bench_obs \
        [--device cpu] [--full] [--out DIR]

Arms, on the WRENCH-analog mini-BERT task at the paper's batch (48,
unroll 2; the JAX bench's data and sizes):

* ``obs_off_loop``: ``run_loop`` over the SAMA step with obs off;
* ``obs_on_loop``: the same loop with a whole pipeline on (a ring sink,
  the health monitors, an activated span tracer, the metrics read at the
  same ``log_every``, the kernels' routing mirrored into the default
  pipeline). Both loops run whole from one copy of the state, as the JAX
  bench times them, in pairs whose order alternates; the bench asserts
  that their final theta and metrics are bitwise equal to a plain loop's;
* ``obs_overhead_ratio``: what obs costs over the plain loop's median
  wall, counted (``perf/obs_cost.py``: the last obs loop's calls replayed
  on a fresh pipeline, and the collector's share), because the walls of
  whole loops on a shared host spread by more than 3% from pair to pair.
  The JAX bench's wall ratio is recorded beside it, with each arm's
  collections; the ratio stays within 3%;
* ``obs_census``: the single-sync schedule on a process group of one
  (gloo on the CPU, NCCL on the card), stepped once under an activated
  tracer with a default obs installed: exactly unroll + 1 all-reduces,
  observability adds no collective.

The 3% bound holds on the card; on the CPU the ratio is recorded (the
claim ``obs_within_3pct``), not held, and the loops run on one thread:
PyTorch's multithreaded CPU kernels are not bitwise reproducible from run
to run, which the equality check would catch. ``pairs`` and ``steps``
cut the run (the CPU tests).
Writes ``BENCH_torch_obs.json``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

from repro_torch.perf.common import Bench, cli, mini_bert, wrench_task

BATCH, UNROLL = 48, 2  # the paper's WRENCH global batch
LOG_EVERY = 5


def _census(spec, theta, lam, base_b, meta_b, device, obs_mod):
    """The single-sync step's collective census on a process group of one,
    under an activated tracer and a default obs."""
    import torch
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.launch.mesh import make_data_mesh

    owned = not dist.is_initialized()
    if owned:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        store = os.path.join(tempfile.mkdtemp(prefix="bench_obs_"), "store")
        dist.init_process_group(backend, store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        live = obs_mod.make_obs(ring=4096)
        obs_mod.set_default(live)
        learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                                  meta_lr=1e-3, method="sama", unroll_steps=UNROLL,
                                  mesh=make_data_mesh(device=device), schedule="single_sync",
                                  obs=live)
        learner.init(theta, lam)
        with obs_mod.activate(obs_mod.Tracer(obs=live)):
            census = learner.verify_census(base_b, meta_b)
        return census, dist.get_backend()
    finally:
        obs_mod.set_default(None)
        if owned:
            dist.destroy_process_group()


@contextlib.contextmanager
def _reproducible(device):
    """One CPU thread for a CPU run (see the module docstring)."""
    import torch

    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run(*, fast: bool = True, device="cuda", pairs=None, steps=None) -> Bench:
    with _reproducible(device):
        return _run(fast, device, pairs, steps)


def _run(fast, device, pairs, steps) -> Bench:
    import torch

    from repro_torch import data, obs as obs_mod, optim, perf
    from repro_torch import tree as tu
    from repro_torch.core import EngineConfig, init_state, make_meta_step, problems
    from repro_torch.core.engine import run_loop
    from repro_torch.perf import obs_cost

    pairs = pairs or (5 if fast else 10)
    n_steps = steps or (10 if fast else 25)
    ccfg, train, meta, _ = wrench_task(seed=7, n_test=0)
    model = mini_bert(num_labels=ccfg.num_classes, d_model=128, device=device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    lam = problems.init_data_optimization_lam(1, reweight=True, device=model.device)
    theta = model.init(0)
    it = data.BatchIterator(train, meta, batch_size=BATCH, meta_batch_size=BATCH,
                            unroll=UNROLL, seed=0, device=model.device)
    base_b, meta_b = next(it)
    base_opt, meta_opt = optim.adam(1e-3), optim.adam(1e-3)
    cfg = EngineConfig(method="sama", unroll_steps=UNROLL)
    state = init_state(theta, lam, base_opt, meta_opt, scale=cfg.scale)
    step = make_meta_step(spec, base_opt, meta_opt, cfg)
    bench = Bench("obs")

    def live():
        return obs_mod.Obs(sink=obs_mod.RingSink(8192), monitor=True)

    def drive(obs):
        """One arm: ``run_loop`` over ``n_steps`` steps at the ``LOG_EVERY``
        cadence; with ``obs``, under an activated tracer of it and with it
        the default pipeline (the kernels' routing mirrored)."""
        obs_mod.set_default(obs)
        try:
            with obs_mod.activate(obs_mod.Tracer(obs=obs)) if obs else contextlib.nullcontext():
                st, history = run_loop(step, state, iter([(base_b, meta_b)] * n_steps), n_steps,
                                       log_every=LOG_EVERY, obs=obs)
        finally:
            obs_mod.set_default(None)
        return tu.tree_leaves(st.theta), history, obs

    ref = drive(None)  # warm both paths (kernel builds, library handles)
    drive(live())
    walls, meters, results = obs_cost.paired_arms(
        {"off": lambda: drive(None), "on": lambda: drive(live())}, pairs, sync=perf.synchronize)
    for out in results:
        for arm, (leaves, history, _) in out.items():
            if not all(torch.equal(x, y) for x, y in zip(leaves, ref[0])):
                raise AssertionError(f"obs {arm}: final theta differs from the plain run")
            if history != ref[1]:
                raise AssertionError(f"obs {arm}: metrics differ from the plain run")
    arm_obs = results[-1]["on"][2]

    timing = {arm: perf.TimingStats.from_samples(s, 1) for arm, s in walls.items()}
    for arm, name in (("off", "obs_off_loop"), ("on", "obs_on_loop")):
        t = timing[arm]
        bench.emit_record(perf.PerfRecord(
            name=name, us_per_step=t.as_dict(),
            samples_per_s=BATCH * UNROLL * n_steps / (t.median_us / 1e6),
            extra={"method": "sama", "batch": BATCH, "unroll": UNROLL,
                   "loop_steps": n_steps, "log_every": LOG_EVERY, "obs": arm == "on",
                   "pairs": pairs, "collections": meters[arm].as_dict()}))
        bench.emit(name, t.median_us, f"loop_steps={n_steps};obs={arm}")
    # what obs costs, counted (perf/obs_cost.py): the last obs arm's calls
    # replayed on a fresh pipeline; the arms' walls spread too far on a
    # shared host to resolve 3%, and their ratio is recorded beside it
    cost = obs_cost.train_cost(arm_obs, arm_obs.sink.events(), live,
                               timing["off"].median_us / 1e6, spans_under_tracer=True)
    ratio = cost["ratio"]
    wall_ratio = timing["on"].median_us / timing["off"].median_us
    bench.emit("obs_overhead_ratio", 0.0,
               f"ratio={ratio:.4f};wall_ratio={wall_ratio:.4f};limit={obs_cost.LIMIT}")
    bench.notes["counted"] = cost
    bench.claim("obs_within_3pct", ratio <= obs_cost.LIMIT)
    if torch.device(device).type == "cuda" and ratio > obs_cost.LIMIT:
        raise AssertionError(
            f"obs costs {100 * (ratio - 1):.2f}% of the plain loop's wall, over 3% "
            f"({cost['cost_ms']:.3f} ms of {cost['wall_ms']:.1f} ms)")

    census, backend = _census(spec, theta, lam, base_b, meta_b, device, obs_mod)
    if not census["single_sync_ok"]:
        raise AssertionError(
            f"single-sync broken with obs on: {census.get('all-reduce_count', 0)} all-reduces, "
            f"expected {census['expected_all_reduces']}")
    bench.emit_record(perf.PerfRecord(
        name="obs_census", collectives=census,
        extra={"schedule": "single_sync", "unroll_steps": UNROLL, "devices": 1,
               "backend": backend, "obs": True}))
    bench.emit("obs_census", 0.0, f"count={census.get('all-reduce_count', 0)};"
                                  f"single_sync_ok={census['single_sync_ok']}")
    bench.notes.update({
        "census": "a process group of one (the JAX bench: 8 forced host devices); the "
                  "count is per step and does not depend on the group's size",
        "asserts": ["final theta and metrics bitwise equal with obs on and off",
                    "obs's counted cost <= 3% of the obs-off median wall "
                    "(perf/obs_cost.py; on the card)",
                    "census exactly unroll + 1 all-reduces with obs on"]})
    return bench


def main(argv=None):
    return cli("obs", run, argv)


if __name__ == "__main__":
    main()
