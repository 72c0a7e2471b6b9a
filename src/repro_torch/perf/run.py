"""The runner over the fourteen bench twins, the port's counterpart of
``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.perf.run [--only NAME[,NAME]] \
        [--json-dir DIR] [--strict] [--full] [--device cpu]

Runs each twin (``repro_torch.perf.bench_<name>``) at the JAX bench's
``fast`` sizes (``--full``: its full sizes) on the card unless ``--device
cpu`` is given, prints their ``name,us_per_call,derived`` rows, and writes
each twin's ``BENCH_torch_<name>.json`` into ``--json-dir`` (default
``build/bench``), atomically (``perf.write_bench``), plus
``BENCH_torch_dataopt.json``, the aggregate of the data-optimization twins
(wrench, data_pruning). ``--only`` keeps the twins whose names contain one
of its comma-separated words. A twin that fails is reported and the rest
run; ``--strict`` stops at the first failure with a non-zero exit.

Four twins have entry points of their own, which the runner adapts: the
distributed bench spawns two gloo ranks (its reduced sizes unless
``--full``), and the scale and Table 2 benches run their smoke configs on
the CPU and their full ones on the card.
"""

from __future__ import annotations

import argparse
import importlib
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

BENCHES = [
    "bench_biased_regression",  # Appendix E / Fig 5
    "bench_wrench",  # Table 1
    "bench_throughput_memory",  # Table 2 + Fig 1 left
    "bench_memory_vs_modelsize",  # Fig 1 right
    "bench_cont_pretrain",  # Table 3
    "bench_data_pruning",  # Fig 3
    "bench_ablation",  # Tables 8/9
    "bench_distributed",  # Fig 2 / Table 2 multi-GPU structure
    "bench_kernels",  # the kernels against the naive chains
    "bench_scale",  # scale/: memory against microbatch M
    "bench_serve",  # serve/: continuous batching against serial, the paged cache
    "bench_obs",  # obs/: the instrumented loop's cost, the census with obs on
    "bench_attribution",  # obs.profile: per-phase coverage and the top sink
    "bench_attention",  # the attention kernels: parity gates and per-route timing
]

#: twins whose rows come from the data-optimization subsystem
DATAOPT_BENCHES = ("bench_wrench", "bench_data_pruning")

OUT_DIR = os.path.join("build", "bench")


def _payload(name: str, fast: bool, device: str, scratch: str) -> Dict[str, Any]:
    """Run one twin; its bench payload."""
    from repro_torch import configs, perf

    mod = importlib.import_module(f"repro_torch.perf.{name}")
    t0 = time.perf_counter()
    if name == "bench_distributed":
        path = mod.run(2, "gloo", device, smoke=fast, out_dir=scratch)
        return perf.load_bench(path)
    if name in ("bench_scale", "bench_throughput_memory"):
        on_cpu = device == "cpu"
        if name == "bench_scale":
            cfg = configs.get_smoke_config("gemma3-1b") if on_cpu else None
            records = mod.run(cfg, device=device, **(mod.SMOKE_SIZES if on_cpu else {}))
        else:
            cfg = configs.get_smoke_config("bert-base") if on_cpu else None
            kw = dict(batch=4, seq=16, repeats=1) if on_cpu else {}
            records = mod.run(cfg, device=device, **kw)
        path = mod.write(scratch, records, time.perf_counter() - t0)
        return perf.load_bench(path)
    bench = mod.run(fast=fast, device=device)
    return bench.payload(fast=fast, elapsed_s=time.perf_counter() - t0)


def _bench_file(payload: Dict[str, Any]) -> str:
    return f"BENCH_{payload['bench']}.json"


def main(argv=None) -> None:
    import tempfile

    from repro_torch import perf

    ap = argparse.ArgumentParser(prog="python -m repro_torch.perf.run")
    ap.add_argument("--full", action="store_true", help="the JAX benches' full sizes")
    ap.add_argument("--only", default=None,
                    help="substring filter; comma-separated alternatives (--only kernels,serve)")
    ap.add_argument("--json-dir", default=OUT_DIR, help="where BENCH_torch_*.json land")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero at the first twin that fails")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.json_dir, exist_ok=True)
    only = [t for t in (args.only or "").split(",") if t]
    print("name,us_per_call,derived", flush=True)
    failures: List[str] = []
    dataopt: List[Tuple[list, list]] = []
    for name in BENCHES:
        if only and not any(tok in name for tok in only):
            continue
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as scratch:
                payload = _payload(name, not args.full, args.device, scratch)
            path = os.path.join(args.json_dir, _bench_file(payload))
            perf.write_bench(path, payload)
            print(f"# {name} done in {time.perf_counter() - t0:.1f}s; wrote {path}", flush=True)
            if name in DATAOPT_BENCHES:
                dataopt.append((payload["rows"], payload["records"]))
        except Exception:
            failures.append(name)
            if args.strict:
                traceback.print_exc()
                raise SystemExit(f"benchmark {name} failed (--strict)")
            print(f"# {name} FAILED:\n# " + traceback.format_exc().replace("\n", "\n# "),
                  flush=True)
    if dataopt:
        rows = [r for rs, _ in dataopt for r in rs]
        records = [r for _, rs in dataopt for r in rs]
        path = os.path.join(args.json_dir, "BENCH_torch_dataopt.json")
        perf.write_bench(path, perf.bench_payload("torch_dataopt", fast=not args.full,
                                                  elapsed_s=0.0, rows=rows, records=records))
        print(f"# wrote {path}", flush=True)
    if failures:
        raise SystemExit(f"benchmarks failed: {failures}")


if __name__ == "__main__":
    main()
