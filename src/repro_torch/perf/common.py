"""What the paper-bench twins share, after ``benchmarks/common.py``: the
WRENCH-analog synthetic task, the mini-BERT classifier and the bench's
rows and records.

Every twin emits ``name,us_per_call,derived`` rows (one per paper-table
cell it reproduces) through :class:`Bench`, which prints the CSV row and
keeps it, with ``derived`` parsed as the JAX package parses it; measured
probes add validated ``PerfRecord`` objects, and the paper's claims are
recorded as booleans (a claim that does not hold fails nothing). ``write``
puts ``BENCH_torch_<name>.json`` beside the JAX baselines' format through
``perf.write_bench``.

Each twin runs on the card unless given ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.perf.bench_<name> [--device cpu] \
        [--full] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import perf


def parse_derived(derived: str) -> Any:
    """Parse "k1=v1;k2=v2" derived strings into a dict of floats/strings;
    anything else passes through verbatim (``benchmarks/common.py``
    ``_parse_derived``)."""

    if not derived or not re.fullmatch(r"[^=;]+=[^;]*(;[^=;]+=[^;]*)*", derived):
        return derived
    out: Dict[str, Any] = {}
    for item in derived.split(";"):
        k, v = item.split("=", 1)
        try:
            out[k] = float(v)
        except ValueError:
            out[k] = v
    return out


class Bench:
    """The rows, records, claims and notes of one twin's run."""

    def __init__(self, name: str):
        self.name = name
        self.rows: List[Dict[str, Any]] = []
        self.records: List[perf.PerfRecord] = []
        self.claims: Dict[str, Optional[bool]] = {}
        self.notes: Dict[str, Any] = {}

    def emit(self, name: str, us_per_call: float, derived: str) -> None:
        print(f"{name},{us_per_call:.1f},{derived}", flush=True)
        self.rows.append({"name": name, "us_per_call": round(float(us_per_call), 1),
                          "derived": parse_derived(derived)})

    def emit_record(self, record: perf.PerfRecord) -> None:
        errors = perf.validate_record(record.as_dict())
        if errors:
            raise ValueError(f"invalid PerfRecord {record.name!r}: " + "; ".join(errors))
        self.records.append(record)

    def claim(self, key: str, held: Optional[bool]) -> None:
        """Record whether one of the paper's claims held in this run (None:
        not measured, as a memory claim on the CPU)."""
        self.claims[key] = None if held is None else bool(held)
        verdict = "not measured" if held is None else ("held" if held else "not held")
        print(f"# claim {key}: {verdict}", flush=True)

    def derived(self, row: str) -> Dict[str, Any]:
        return next(r["derived"] for r in self.rows if r["name"] == row)

    def payload(self, *, fast: bool, elapsed_s: float) -> Dict[str, Any]:
        out = perf.bench_payload(f"torch_{self.name}", fast=fast, elapsed_s=elapsed_s,
                                 rows=self.rows, records=self.records)
        out.update({"claims": self.claims, "notes": self.notes})
        return out

    def write(self, out_dir: str, *, fast: bool, elapsed_s: float) -> str:
        path = os.path.join(out_dir, f"BENCH_torch_{self.name}.json")
        perf.write_bench(path, self.payload(fast=fast, elapsed_s=elapsed_s))
        return path


#: the peak memory the twins record: ``torch.cuda.max_memory_allocated``
#: after a reset around one meta step, less what the process held before
#: the twin began. The JAX rows hold XLA's compiled argument + output +
#: temp bytes, which is not the same quantity.
MEMORY_SOURCE = "cuda_max_allocated"
MEMORY_NOTE = ("peak_mb is torch.cuda.max_memory_allocated over one meta step after a reset, "
               "less the bytes allocated before the bench began (the step's live state and "
               "batches included); the JAX baseline's peak_mb is XLA's compiled argument + "
               "output + temp bytes, not the same quantity")


def live_bytes(device: torch.device) -> int:
    """Bytes the process holds on the card (0 on the CPU): a twin's memory
    baseline, taken before it allocates anything."""
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def peak_mb(device: torch.device, since: int) -> Optional[float]:
    """The card's ``max_memory_allocated`` since the last reset, less
    ``since`` bytes, in MiB; None on the CPU (not measured)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - since) / 2**20


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def cli(name: str, run, argv=None) -> str:
    """The twins' command line: ``--device`` (default ``cuda``), ``--full``
    (the JAX bench's larger sizes) and ``--out`` (default
    ``build/paper_benches``). Runs ``run(fast=, device=)`` and writes its
    bench file; returns the path."""

    ap = argparse.ArgumentParser(prog=f"python -m repro_torch.perf.bench_{name}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="the JAX bench's full sizes")
    ap.add_argument("--out", default=os.path.join("build", "paper_benches"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    bench = run(fast=not args.full, device=args.device)
    path = bench.write(args.out, fast=not args.full, elapsed_s=time.perf_counter() - t0)
    print(f"# wrote {path}", flush=True)
    return path


# ---------------------------------------------------------------------------
# WRENCH-analog task: weakly-labeled text classification with a mini-BERT
# ---------------------------------------------------------------------------


def wrench_task(seed: int = 0, n_train: int = 512, n_meta: int = 128, n_test: int = 512,
                lf_accuracy: float = 0.5, *, num_classes: int = 4, vocab_size: int = 512,
                seq_len: int = 32):
    """Synthetic WRENCH (``benchmarks/common.py`` ``wrench_task``, the same
    numpy draws): majority-vote weak labels on train (the paper's App. B.1
    setup), a clean meta split and a clean test split (None at
    ``n_test=0``). The keywords set the classes, vocabulary and sequence
    length (Table 2 draws at bert-base's vocabulary)."""
    from repro_torch import data

    ccfg = data.ClassificationConfig(num_classes=num_classes, vocab_size=vocab_size,
                                     seq_len=seq_len, seed=seed)
    train = data.make_classification_dataset(ccfg, n_train, noise=0.0, seed=seed)
    train["y"] = data.weak_labels(train["y_true"], num_classes, num_lfs=5,
                                  lf_accuracy=lf_accuracy, seed=seed + 1)
    meta = data.make_classification_dataset(ccfg, n_meta, noise=0.0, seed=seed + 2)
    test = (data.make_classification_dataset(ccfg, n_test, noise=0.0, seed=seed + 3)
            if n_test else None)
    return ccfg, train, meta, test


def mini_bert(num_labels: int = 4, d_model: int = 128, layers: int = 2, *, device="cuda"):
    """The bert-base smoke encoder with ``benchmarks/common.py``'s
    replacements (``mini_bert``), remat off, on ``device``."""
    from repro_torch import configs
    from repro_torch.models import Model

    cfg = configs.get_smoke_config("bert-base").replace(
        d_model=d_model, num_layers=layers, num_labels=num_labels,
        num_heads=max(d_model // 64, 2), num_kv_heads=max(d_model // 64, 2),
        head_dim=64, d_ff=d_model * 2, remat=False,
    )
    return Model(cfg, device=device)
