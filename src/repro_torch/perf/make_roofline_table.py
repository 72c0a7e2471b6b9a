"""Render the dry run's JSON files (``launch/dryrun.py``) as a markdown
roofline table, after ``benchmarks/make_roofline_table.py``.

    PYTHONPATH=src python -m repro_torch.perf.make_roofline_table \
        [--dir build/dryrun] [--mesh pod16x16] [--out DIR] [--arch A,B]

Writes ``roofline_<mesh>.md`` into ``--out`` (default: the input directory)
and prints it. Every number is an analytic count against the H100's
data-sheet peaks (``roofline.analysis``) or the meta trace's count, never
a measurement.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "gemma3-1b", "gemma3-27b", "gemma2-9b", "minicpm3-4b", "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b", "zamba2-7b", "rwkv6-1.6b", "whisper-small",
    "llama-3.2-vision-90b",
]


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1.0:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.1f}{unit}"
    return f"{x:.0f}B"


def load(directory: str, mesh: str):
    rows = {}
    for path in glob.glob(os.path.join(directory, f"*_{mesh}.json")):
        with open(path) as f:
            r = json.load(f)
        base = os.path.basename(path)[: -len(f"_{mesh}.json")]
        for s in SHAPE_ORDER:
            if base.endswith("_" + s):
                rows[(base[: -len(s) - 1], s)] = r
    return rows


def render(rows, mesh: str, archs=ARCH_ORDER) -> str:
    ranks = 512 if "pod2" in mesh else 256
    out = [f"### Dry-run roofline, {mesh} ({ranks} H100 ranks): analytic counts against "
           "data-sheet peaks, not measurements\n",
           "| arch | shape | compute | memory | collective | dominant | useful | "
           "traced/analytic FLOPs | coll. bytes/rank | state bytes/rank | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in archs:
        for shape in SHAPE_ORDER:
            r = rows.get((arch, shape))
            if r is None:
                out.append(f"| {arch} | {shape} | - | - | - | MISSING | - | - | - | - | - |")
                continue
            if r["status"] == "skipped":
                out.append(f"| {arch} | {shape} | - | - | - | skipped (full attention; "
                           "DESIGN §4) | - | - | - | - | - |")
                continue
            if r["status"] == "error":
                out.append(f"| {arch} | {shape} | - | - | - | ERROR: {r['error'][:60]} | - | "
                           "- | - | - | - |")
                continue
            ratio = (r["traced_flops"] / r["flops_global"]
                     if r.get("traced_flops") and r["flops_global"] else None)
            out.append(
                f"| {arch} | {shape} | {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
                f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | {r['useful_ratio']:.2f} | "
                f"{'-' if ratio is None else f'{ratio:.3f}'} | "
                f"{fmt_b(r['collective_bytes_per_device'])} | "
                f"{fmt_b(r['per_rank_bytes'].get('total'))} | "
                f"{'yes' if r.get('fits_hbm') else 'no'} |")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.perf.make_roofline_table")
    ap.add_argument("--dir", default=os.path.join("build", "dryrun"))
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default=None, help="output directory (default: --dir)")
    ap.add_argument("--arch", default=None, help="comma-separated archs (default: all)")
    args = ap.parse_args(argv)
    archs = args.arch.split(",") if args.arch else ARCH_ORDER
    text = render(load(args.dir, args.mesh), args.mesh, archs)
    out_dir = args.out or args.dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"roofline_{args.mesh}.md")
    with open(path, "w") as f:
        f.write(text)
    print(text)
    print(f"# wrote {path}")


if __name__ == "__main__":
    main()
