"""The dry run of every (architecture x input shape) on the production
mesh, after ``src/repro/launch/dryrun.py``: build the whole full-size
state and batches on ``device="meta"``, trace the step once under the
attribution's counting mode (``obs.profile.attribute``: no storage, no
card, no ranks) and record the H100 roofline terms beside the traced
counts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Writes one JSON per job under ``build/dryrun/`` (``--out-dir``);
``python -m repro_torch.perf.make_roofline_table`` renders them. Every
term is an analytic count against the H100's data-sheet peaks
(``roofline.analysis``), not a measurement. The mesh is the reference's
production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) read as
ranks, one card each: the compute and memory terms divide the global count
by the rank count, per-rank bytes come from the partition rules
(``launch/specs.per_rank_bytes``), and the collective term from the port's
layout (``roofline.analysis.collective_bytes``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import PRODUCTION
from repro_torch.obs import profile
from repro_torch.roofline import analyze
from repro_torch.roofline.analysis import HBM_BYTES

OUT_DIR = os.path.join("build", "dryrun")

#: the reference's reason for a refused long-context job, word for word
LONG_CONTEXT_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §4)"


def production_mesh_shape(multi_pod: bool = False):
    extents, axes = PRODUCTION[multi_pod]
    return dict(zip(axes, extents))


def run_job(arch: str, shape_name: str, *, multi_pod: bool = False, save: bool = True,
            out_dir: str = OUT_DIR):
    """One job's record: ``status`` "ok" (the roofline record), "skipped"
    (the reference's long-context rule) or "error" (the exception, as a
    finding)."""
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_shape = production_mesh_shape(multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ranks = math.prod(mesh_shape.values())

    try:
        job = specs_mod.make_job(cfg, shape, mesh_shape)
        if job is None:
            result = {"name": f"{arch}:{shape_name}", "mesh": mesh_name, "status": "skipped",
                      "reason": LONG_CONTEXT_REASON}
            _emit(result, save, arch, shape_name, mesh_name, out_dir)
            return result
        t0 = time.perf_counter()
        attr = profile.attribute(job.step_fn, *job.args, n_devices=ranks)
        trace_s = time.perf_counter() - t0
        per_rank = specs_mod.per_rank_bytes(job, mesh_shape)
        lam_bytes = (specs_mod._whole_bytes(job.state.lam) if job.state is not None else 0.0)
        roof = analyze(job.name, job.cfg, shape, job.kind, job.params, n_devices=ranks,
                       mesh_shape=mesh_shape, cache_shapes=job.cache,
                       per_rank_bytes=per_rank, traced=attr, lam_bytes=lam_bytes)
        result = roof.as_dict()
        result.update({
            "mesh": mesh_name, "ranks": ranks, "status": "ok", "trace_s": round(trace_s, 2),
            "fits_hbm": per_rank["total"] <= HBM_BYTES,
            "traced_phases": {ph: b["flops"] for ph, b in attr["phases"].items()},
            "traced_kernels": attr["kernels"],
            "traced_coverage": attr["coverage"],
        })
    except Exception as e:  # noqa: BLE001: a dry-run failure is a finding
        result = {"name": f"{arch}:{shape_name}", "mesh": mesh_name, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
    _emit(result, save, arch, shape_name, mesh_name, out_dir)
    return result


def _emit(result, save, arch, shape_name, mesh_name, out_dir):
    line = {k: v for k, v in result.items()
            if k not in ("collectives", "traceback", "traced_kernels", "traced_phases")}
    print(json.dumps(line, default=str), flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true", help="the 2 x 16 x 16 mesh")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        archs, shapes = list(configs.ASSIGNED_ARCHS), list(INPUT_SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        archs, shapes = [args.arch], [args.shape]
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            r = run_job(arch, shape_name, multi_pod=args.multi_pod, out_dir=args.out_dir)
            failures += r["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} dry-run jobs failed")


if __name__ == "__main__":
    main()
