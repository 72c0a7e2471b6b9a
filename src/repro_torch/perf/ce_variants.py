"""Where the cross-entropy kernels' time goes against their byte bound: the
forward and backward of ``kernels/csrc/weighted_ce.cu`` timed beside
copies of the source with one thing changed, and beside a device-to-device
copy of the same bytes.

    PYTHONPATH=src python -m repro_torch.perf.ce_variants [--out FILE]

Runs on a CUDA card only. Each variant copies ``weighted_ce.cu`` into
``build/ce_variants/<variant>/`` with one edit (``VARIANTS``), builds it
with the flags of ``kernels/build.py`` (all at once, one ``nvcc`` each)
and times its C entry points by CUDA-graph replay at gemma3-1b's f32 LM
loss (the (4, 1023, 262,144) view, rows in phase) and whisper-small's (the
(8, 447, 51,865) view, rows out of phase): the base first and last, so
the two base times show the drift within the run. ``no_exp`` computes a
wrong result on purpose (its exponentials taken out): it says what the
arithmetic costs. ``copy_ms`` is ``Tensor.copy_`` of the logits' bytes
(read once, written once): the rate the card reaches for the backward's
traffic, beside the 3.35 TB/s of the bound. An edit that no longer
matches the source stops the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.perf.timers import HBM_BYTES_PER_S, graph_ms

OUT_DIR = build.ROOT / "build" / "ce_variants"

#: name -> [(old, new)]: each ``old`` must occur in the source
VARIANTS = {
    "base": [],
    # twice the 16-byte loads in flight per thread
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    # 256 threads a row's block (the base takes 512)
    "threads256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
    # loads marked streaming (evict first) instead of through the read-only path
    "ldcs": [("return __ldg(reinterpret_cast<const uint4*>(p));",
              "return __ldcs(reinterpret_cast<const uint4*>(p));")],
    # dlogits by ordinary write-back stores instead of streaming ones
    "wb_store": [("__stcs(reinterpret_cast<uint4*>(p), v);",
                  "*reinterpret_cast<uint4*>(p) = v;")],
    # exponentials that flush subnormal results to zero
    "ftz": [('asm("ex2.approx.f32 %0, %1;"', 'asm("ex2.approx.ftz.f32 %0, %1;"')],
    # the exponentials taken out (a wrong result: its time alone is read)
    "no_exp": [("{ return ex2((x - m) * kLog2e); }", "{ return (x - m) * kLog2e; }")],
}
#: (name, B, S, V) of the timed LM losses (f32 logits, the (B, S - 1, V) view)
SHAPES = [("gemma3-1b", 4, 1024, 262_144), ("whisper-small", 8, 448, 51_865)]


def build_variants(names):
    """One library per variant, all nvcc processes at once. Returns
    {name: ctypes library}."""
    src = build.SOURCES["weighted_ce"].read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"ce_variants: {name}: {old!r} is not in weighted_ce.cu")
            text = text.replace(old, new)
        d = OUT_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "weighted_ce.cu").write_text(text)
        lib = d / "libweighted_ce.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "weighted_ce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ce_variants: {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn, n_ptr in (("weighted_ce_fwd_launch", 4), ("weighted_ce_bwd_launch", 5)):
            f = getattr(libs[name], fn)
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * 5
                          + [ctypes.c_int, ctypes.c_void_p])
            f.restype = ctypes.c_int
    return libs


def time_variant(lib, x, t, g, lse, ce, lse_out, dlogits, layout):
    """(forward ms, backward ms) of one library by graph replay."""
    rows, v, inner_n, s_outer, s_inner = layout
    dims = (rows, v, inner_n, s_outer, s_inner, 0)

    def stream():  # read at each launch: graph_ms captures on its own stream
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        err = lib.weighted_ce_fwd_launch(x.data_ptr(), t.data_ptr(), ce.data_ptr(),
                                         lse_out.data_ptr(), *dims, stream())
        assert err == 0, err

    def bwd():
        err = lib.weighted_ce_bwd_launch(x.data_ptr(), t.data_ptr(), lse.data_ptr(),
                                         g.data_ptr(), dlogits.data_ptr(), *dims, stream())
        assert err == 0, err

    return graph_ms(fwd), graph_ms(bwd)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ce_variants: needs a CUDA card")
    from repro_torch.kernels import weighted_ce as wce

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    libs = build_variants(list(VARIANTS))
    order = ["base"] + [n for n in VARIANTS if n != "base"] + ["base"]
    rows_out = []
    for name, b, s, v in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        full = torch.randn((b, s, v), generator=gen, device=dev) * 3
        x = full[:, :-1]
        r = b * (s - 1)
        t = torch.randint(0, v, (r,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn(r, generator=gen, device=dev)
        _, lse = wce._fwd_cuda(x, t)
        layout = wce.row_layout(x)[:1] + (v,) + wce.row_layout(x)[1:]
        ce, lse_out = torch.empty_like(lse), torch.empty_like(lse)
        dlogits = torch.empty(x.shape, dtype=x.dtype, device=dev)
        nbytes = r * v * 4
        x2 = x.reshape(r, v)
        dst = torch.empty_like(x2)
        row = {"card": smi, "name": name, "R": r, "V": v, "dtype": "float32",
               "fwd_bound_ms": (nbytes + 12 * r) / HBM_BYTES_PER_S * 1e3,
               "bwd_bound_ms": (2 * nbytes + 12 * r) / HBM_BYTES_PER_S * 1e3,
               "copy_ms": graph_ms(lambda: dst.copy_(x2)), "variants": []}
        del x2, dst
        for variant in order:
            f_ms, b_ms = time_variant(libs[variant], x, t, g, lse, ce, lse_out, dlogits, layout)
            row["variants"].append({"variant": variant, "fwd_ms": f_ms, "bwd_ms": b_ms})
        print(json.dumps(row), flush=True)
        rows_out.append(row)
        del full, x, t, g, lse, ce, lse_out, dlogits
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows_out)


if __name__ == "__main__":
    main()
