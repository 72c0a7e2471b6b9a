"""The cross-entropy kernels (``kernels.weighted_ce``) at every row
alignment and at the LM losses' shapes: each kernel held against its plain
version, and its device time beside the bound, the plain version and the
library call.

    PYTHONPATH=src python -m repro_torch.perf.ce_time [--skip-check] [--kernels-only]
        [--out FILE] [--label NAME]

Runs on a CUDA card only. :func:`check_alignments` feeds both kernels
logits whose rows start at every phase of a 16-byte line, in f32, bf16 and
f16 (``ALIGN_V``: V at each residue modulo the elements a 16-byte vector
holds, and V below one vector, through the LM loss's ``logits[:, :-1]``
view, at storage offsets 0 and 3), holds them to the plain versions at
``chip_smoke.py``'s tolerances and holds a second launch bitwise equal to
the first. :func:`time_shape` times them at one of ``SHAPES`` (the LM
losses' (B, S - 1, V) views, as ``chip_smoke.py``'s ``CE_SHAPES``) by
CUDA-graph replay: the kernel twice, and unless ``kernels_only`` the plain
versions and ``F.cross_entropy`` (forward; its eager autograd backward);
the bound is the bytes each pass must move at 3.35 TB/s. Prints one JSON
line per shape and dtype.

The module reaches the package only through ``weighted_ce``'s kernel
wrappers (``_fwd_cuda``, ``_bwd_cuda``) and plain versions and
``perf.timers``, so it times another checkout's kernels as well: run it by
path with that checkout's ``src`` first on ``PYTHONPATH``
(``PYTHONPATH=../old/src python src/repro_torch/perf/ce_time.py
--skip-check --kernels-only``), which builds that checkout's kernels into
its own ``build/kernels``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.perf.timers import HBM_BYTES_PER_S, graph_ms

#: (name, B, S, V): the LM losses' logits, read through their (B, S - 1, V)
#: view: gemma3-1b, qwen2-moe-a2.7b, minicpm3-4b, rwkv6-1.6b, zamba2-7b and
#: whisper-small (V odd: every row but the first off a 16-byte boundary)
SHAPES = [("gemma3-1b", 4, 1024, 262_144), ("qwen2-moe-a2.7b", 4, 1024, 151_936),
          ("minicpm3-4b", 4, 1024, 73_448), ("rwkv6-1.6b", 4, 1024, 65_536),
          ("zamba2-7b", 4, 1024, 32_000), ("whisper-small", 8, 448, 51_865)]
#: V at every residue modulo 4 (f32) and 8 (bf16, f16) elements, and below
#: one 16-byte vector
ALIGN_V = (1, 3, 7, 4097, 4098, 4099, 8193, 8194, 8195, 8196, 8197, 8198, 8199)
#: (B, S) of the alignment checks' logits, read as the (B, S - 1, V) view
ALIGN_BS = (2, 9)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def dlogits_tolerance(dtype):
    """(rtol, atol) of dlogits stored in ``dtype`` against the plain version
    in f32: 1e-5 relative for the arithmetic; for 16-bit stores, half an
    ulp relative for the rounding, and the spacing of the dtype's
    subnormals absolute (round-to-nearest is within half of it)."""
    if dtype == torch.float32:
        return 1e-5, 1e-6
    fi = torch.finfo(dtype)
    return 1e-5 + fi.eps / 2, fi.tiny * fi.eps


def _excess(got, ref, atol, rtol):
    """Worst |got - ref| over its allowance atol + rtol |ref| (fails above 1)."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def hold(wce, x, t, g, what):
    """Both kernels on (x, t, g) against the plain versions in f32 on the
    same values: ce and lse within 1e-5 (1 + |ref|), dlogits within
    ``dlogits_tolerance``; a second launch of each bitwise equal to the
    first. Returns the worst errors; raises on a miss."""
    v = x.shape[-1]
    ce, lse = wce._fwd_cuda(x, t)
    d = wce._bwd_cuda(x, t, lse, g)
    ce2, lse2 = wce._fwd_cuda(x, t)
    d2 = wce._bwd_cuda(x, t, lse, g)
    torch.cuda.synchronize()
    if not (torch.equal(ce, ce2) and torch.equal(lse, lse2) and torch.equal(d, d2)):
        raise AssertionError(f"weighted_ce at {what}: two launches differ")
    x32 = x.float().reshape(-1, v)
    ce_ref, lse_ref = wce.cross_entropy_fwd_plain(x32, t)
    for name, a, r in (("ce", ce, ce_ref), ("lse", lse, lse_ref)):
        excess = _excess(a, r, 1e-5, 1e-5)
        if not excess <= 1.0:
            raise AssertionError(f"weighted_ce {name} vs plain at {what}: {excess:.3f} of "
                                 "1e-5 (1 + |ref|)")
    if d.dtype != x.dtype or d.shape != x.shape:
        raise AssertionError(f"weighted_ce backward returned {d.dtype} {tuple(d.shape)} at {what}")
    d_ref = wce.cross_entropy_bwd_plain(x32, t, lse_ref, g)
    rtol, atol = dlogits_tolerance(x.dtype)
    share = _excess(d.reshape(-1, v), d_ref, atol, rtol)
    if not share <= 1.0:
        raise AssertionError(f"weighted_ce dlogits vs plain in f32 at {what}: {share:.3f} of "
                             f"{atol:.3g} + {rtol:.3g} |ref|")
    return {"fwd": max((ce - ce_ref).abs().max().item(), (lse - lse_ref).abs().max().item()),
            "bwd": (d.reshape(-1, v).float() - d_ref).abs().max().item(), "bwd_share": share}


def check_alignments(dev, seed=0):
    """Both kernels at every (dtype, V in ALIGN_V, storage offset 0 or 3)
    of the (B, S - 1, V) view of ALIGN_BS logits (``hold``). Returns the
    count of cases and the worst errors by dtype."""
    from repro_torch.kernels import weighted_ce as wce

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, s = ALIGN_BS
    worst, cases = {}, 0
    for dtype in DTYPES:
        key = str(dtype).replace("torch.", "")
        for v in ALIGN_V:
            for offset in (0, 3):
                n = b * s * v
                buf = (torch.randn(n + offset, generator=gen, device=dev) * 3).to(dtype)
                x = buf[offset:].view(b, s, v)[:, :-1]
                rows = b * (s - 1)
                t = torch.randint(0, v, (rows,), generator=gen, device=dev, dtype=torch.int32)
                g = torch.randn(rows, generator=gen, device=dev)
                got = hold(wce, x, t, g, f"V={v} {key} offset {offset}")
                w = worst.setdefault(key, {"fwd": 0.0, "bwd": 0.0, "bwd_share": 0.0})
                for k in w:
                    w[k] = max(w[k], got[k])
                cases += 1
    return cases, worst


def ce_inputs(gen, dev, b, s, v, dtype, sliced=True):
    """Logits as the LM loss hands them to weighted_ce, ~ 3 N(0, 1) in
    ``dtype``: the (B, S - 1, V) view of (B, S, V) logits, or with
    ``sliced`` false all B S rows; int32 targets (R,) and an f32 cotangent
    (R,); drawn on ``gen``'s card (a billion normal draws take the host
    ~10 s)."""
    full = (torch.randn((b, s, v), generator=gen, device=dev) * 3).to(dtype)
    x = full[:, :-1] if sliced else full.reshape(b * s, v)
    rows = x.numel() // v
    t = torch.randint(0, v, (rows,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn(rows, generator=gen, device=dev)
    return x, t, g


def bounds_ms(rows, v, item):
    """The least ms of each pass at 3.35 TB/s: the forward reads the logits
    and targets and writes ce and lse; the backward reads the logits,
    targets, lse and g and writes dlogits (4 + 4 + 4 bytes a row besides)."""
    logits = rows * v * item
    return ((logits + rows * 12) / HBM_BYTES_PER_S * 1e3,
            (2 * logits + rows * 12) / HBM_BYTES_PER_S * 1e3)


def time_shape(dev, shape, dtype, seed=0, kernels_only=False):
    """One shape's times (ms): ``fwd_ms``, ``bwd_ms`` and their repeats by
    CUDA-graph replay, the bounds, and unless ``kernels_only`` the plain
    versions (CUDA events, 10 calls), the library calls:
    ``F.cross_entropy(reduction="none")`` on a contiguous copy (graph) and
    its autograd backward (eager, 10 calls), and ``copy_ms``, a copy of
    the logits' bytes (graph): the backward's traffic at the rate the card
    reaches for it."""
    import torch.nn.functional as F

    from repro_torch.kernels import weighted_ce as wce

    name, b, s, v = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, t, g = ce_inputs(gen, dev, b, s, v, dtype)
    rows = t.numel()
    _, lse = wce._fwd_cuda(x, t)
    out = {"name": name, "R": rows, "V": v, "dtype": str(dtype).replace("torch.", ""),
           "layout": f"({b}, {s - 1}, {v}) view"}
    out["fwd_ms"] = graph_ms(lambda: wce._fwd_cuda(x, t))
    out["bwd_ms"] = graph_ms(lambda: wce._bwd_cuda(x, t, lse, g))
    out["fwd_bound_ms"], out["bwd_bound_ms"] = bounds_ms(rows, v, x.element_size())
    if not kernels_only:
        out["fwd_plain_ms"] = _events_ms(lambda: wce.cross_entropy_fwd_plain(x.reshape(-1, v), t))
        out["bwd_plain_ms"] = _events_ms(
            lambda: wce.cross_entropy_bwd_plain(x.reshape(-1, v), t, lse, g))
        x2, t64 = x.reshape(rows, v), t.long()
        out["fwd_library_ms"] = graph_ms(lambda: F.cross_entropy(x2, t64, reduction="none"))
        leaf = x2.detach().requires_grad_(True)
        lib_out = F.cross_entropy(leaf, t64, reduction="none")
        out["bwd_library_ms"] = _events_ms(
            lambda: torch.autograd.grad(lib_out, leaf, g.to(lib_out.dtype), retain_graph=True))
        del leaf, lib_out
        # the card's own rate at the backward's traffic: a device-to-device
        # copy of the logits' bytes (read once, written once)
        dst = torch.empty_like(x2)
        out["copy_ms"] = graph_ms(lambda: dst.copy_(x2))
        del x2, dst
    out["fwd_ms_repeat"] = graph_ms(lambda: wce._fwd_cuda(x, t))
    out["bwd_ms_repeat"] = graph_ms(lambda: wce._bwd_cuda(x, t, lse, g))
    for p in ("fwd", "bwd"):
        out[f"{p}_share_of_bound"] = out[f"{p}_bound_ms"] / out[f"{p}_ms"]
    del x, t, g, lse
    torch.cuda.empty_cache()
    return out


def _events_ms(fn, iters=10):
    """Mean device ms of ``fn()`` over ``iters`` eager calls after two."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-check", action="store_true", help="time only")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels alone, not the plain versions and library calls")
    ap.add_argument("--shapes", default="", help="comma-separated names of SHAPES (all)")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--label", default="", help="a name carried in every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_time: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    rows = []

    def emit(row):
        row = {"label": args.label, "card": smi, **row}
        print(json.dumps(row), flush=True)
        rows.append(row)

    if not args.skip_check:
        cases, worst = check_alignments(dev)
        emit({"check": "alignments", "cases": cases, "max_abs_err": worst})
    names = set(filter(None, args.shapes.split(",")))
    for shape in SHAPES:
        if names and shape[0] not in names:
            continue
        dtypes = DTYPES if shape[0] == "gemma3-1b" else (torch.float32,)
        for dtype in dtypes:
            emit(time_shape(dev, shape, dtype, kernels_only=args.kernels_only))
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
