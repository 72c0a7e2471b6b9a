"""Where the bf16 training attention kernels spend their time: the
tensor-core forward, dq and dk/dv, each timed beside copies of itself with
one piece of work taken out.

    PYTHONPATH=src python -m repro_torch.perf.attn_ablation [--out FILE] [--kernels dkv ...]

Runs on a CUDA card only. Each variant copies ``kernels/csrc`` into
``build/ablation/<kernel>-<variant>/`` with one edit, builds it with the
flags of ``kernels/build.py`` (all variants at once, one ``nvcc`` each)
and times its C entry point, captured in a CUDA graph over one pass of
layers, each with its own inputs: bert-base's 12 layers (B 48, S = T 128,
H 12, Dh 64, non-causal) and gemma3-1b's 4 global and 22 local layers (B
4, S = T 1024, H 4 over KV 1, Dh 256, causal, window 512 on the local
ones), all bf16. The order is base, every variant, base again, so the two
base times show the drift within the run. A variant computes a wrong
result on purpose: only its time is read. Taking out a product also takes
out the fragment loads that fed it, and the compiler then allocates
registers anew, so a variant can come out slower than the base; such a
time says that the piece's cost is not additive. An edit that no longer
matches the source stops the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build, flash_attn
from repro_torch.perf.timers import graph_ms

OUT_DIR = build.ROOT / "build" / "ablation"

#: per kernel: its source, C entry, and the variants as (file, anchor, old,
#: new): the first ``old`` after ``anchor`` in ``file`` becomes ``new``
_FWD_WGMMA_QK = (
    "      W::ss(sc_flat, hopper::desc_b128(q_addr + p * F::kRows * 128 + kk * 32, 16, 1024),\n"
    "            hopper::desc_b128(kb + p * kBK * 128 + kk * 32, 16, 1024), p + kk > 0);\n")
_FWD_WGMMA_PV = (
    "      W::rs(o_flat, a[kk][s], hopper::desc_b128(vb + kk * 16 * 128, kBK * 128, 1024), 1);\n")
_DQ_MMA_QK = ("        M::mma(sc[2 * np], aq, bk[0], bk[1]);\n"
              "        M::mma(sc[2 * np + 1], aq, bk[2], bk[3]);\n")
_DQ_MMA_DP = ("        M::mma(dp[2 * np], ao, bv[0], bv[1]);\n"
              "        M::mma(dp[2 * np + 1], ao, bv[2], bv[3]);\n")
_DQ_MMA_DSK = ("          M::mma(acc[2 * np], a[s], bb[0], bb[1]);\n"
               "          M::mma(acc[2 * np + 1], a[s], bb[2], bb[3]);\n")
_DKV_MMA_KQ = ("      M::mma(st[2 * np], ak, bq4[0], bq4[1]);\n"
               "      M::mma(st[2 * np + 1], ak, bq4[2], bq4[3]);\n")
_DKV_MMA_VDO = ("      M::mma(dpt[2 * np], av, bo4[0], bo4[1]);\n"
                "      M::mma(dpt[2 * np + 1], av, bo4[2], bo4[3]);\n")
_DKV_MMA_PDO = ("        M::mma(acc_v[2 * np], ap[s], bo4[0], bo4[1]);\n"
                "        M::mma(acc_v[2 * np + 1], ap[s], bo4[2], bo4[3]);\n")
_DKV_MMA_DSQ = ("        M::mma(acc_k[2 * np], ad[s], bq4[0], bq4[1]);\n"
                "        M::mma(acc_k[2 * np + 1], ad[s], bq4[2], bq4[3]);\n")
_NO_SKIP = ("attn_mma.cuh", "struct KeyTiles",
            "tile_state(q, serial_span<kBK>(kv_pos, jt * kBK, t_len), causal, window)",
            "kPartial")

KERNELS = {
    "fwd": ("flash_attn_fwd", "flash_attn_fwd_launch", {
        "no_qk": ("flash_attn_fwd.cu", "void fwd_tile(", _FWD_WGMMA_QK, ""),
        "no_pv": ("flash_attn_fwd.cu", "void fwd_tile(", _FWD_WGMMA_PV, ""),
        "p_1_term": ("flash_attn_fwd.cu", "struct FwdTc",
                     "std::is_same<T, __nv_bfloat16>::value ? 3 : 2;", "1;"),
        "no_exp": ("flash_attn_fwd.cu", "void fwd_tile(", "exp2_approx(sc[n][e] - r.m[u])",
                   "(sc[n][e] - r.m[u])"),
        "no_mask": ("flash_attn_fwd.cu", "fwd_tc_kernel(", "      if (info & 1) {\n",
                    "      if (true) {\n"),
        "no_skip": _NO_SKIP,
        "one_stage": ("flash_attn_fwd.cu", "struct FwdTc", "kStages = 4;", "kStages = 1;"),
    }),
    "dq": ("flash_attn_bwd", "flash_attn_dq_launch", {
        "no_qk": ("flash_attn_bwd.cu", "dq_tc_kernel(", _DQ_MMA_QK, ""),
        "no_dp": ("flash_attn_bwd.cu", "dq_tc_kernel(", _DQ_MMA_DP, ""),
        "no_dsk": ("flash_attn_bwd.cu", "dq_tc_kernel(", _DQ_MMA_DSK, ""),
        "ds_1_term": ("flash_attn_bwd.cu", "constexpr int kSplitDq", "kSplitDq = 2;",
                      "kSplitDq = 1;"),
        "no_exp": ("flash_attn_bwd.cu", "dq_tc_kernel(", "expf(x - lse_r[u])", "(x - lse_r[u])"),
        "no_mask": ("flash_attn_bwd.cu", "dq_tc_kernel(", "    const int t0 = j * kBK;\n",
                    "    const int t0 = j * kBK;\n    full = true;\n"),
        "no_skip": _NO_SKIP,
    }),
    "dkv": ("flash_attn_bwd", "flash_attn_dkv_launch", {
        "no_kq": ("flash_attn_bwd.cu", "void dkv_tile(", _DKV_MMA_KQ, ""),
        "no_vdo": ("flash_attn_bwd.cu", "void dkv_tile(", _DKV_MMA_VDO, ""),
        "no_pdo": ("flash_attn_bwd.cu", "void dkv_tile(", _DKV_MMA_PDO, ""),
        "no_dsq": ("flash_attn_bwd.cu", "void dkv_tile(", _DKV_MMA_DSQ, ""),
        "terms_1": ("flash_attn_bwd.cu", "constexpr int kSplitDkv", "kSplitDkv = 2;",
                    "kSplitDkv = 1;"),
        "no_exp": ("flash_attn_bwd.cu", "void dkv_tile(", "expf(x - lse_r)", "(x - lse_r)"),
        "no_mask": ("flash_attn_bwd.cu", "dkv_tc_kernel(", "    if (full) {\n",
                    "    if (true) {\n"),
        "no_skip": ("attn_mma.cuh", "struct QueryTiles",
                    "tile_state(row_span(q_pos, s0, min(bq, s_len - s0)), k, causal, window)",
                    "kPartial"),
    }),
}

#: pointer arguments of each kernel's C entry
_N_PTR = {"fwd": 7, "dq": 9, "dkv": 10}


def variant_source(kernel, variant, root=OUT_DIR):
    """Write the sources of ``kernel``'s ``variant`` (None: the base) into
    ``root``/<kernel>-<variant>/; returns the path of its .cu file."""
    source, _, variants = KERNELS[kernel]
    where = root / f"{kernel}-{variant or 'base'}"
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(build.CSRC, where)
    if variant is not None:
        name, anchor, old, new = variants[variant]
        path = where / name
        text = path.read_text()
        start = text.find(anchor)
        at = text.find(old, start) if start >= 0 else -1
        if at < 0:
            raise RuntimeError(f"{kernel} {variant}: {old.strip()!r} not found after "
                               f"{anchor!r} in {name}: the edit no longer matches the source")
        path.write_text(text[:at] + new + text[at + len(old):])
    return where / f"{source}.cu"


def _build(plan):
    """{(kernel, variant): loaded entry point}, one nvcc per variant, all at
    once."""
    procs = {}
    for kernel, variant in plan:
        src = variant_source(kernel, variant)
        lib = src.with_name("lib.so")
        procs[kernel, variant] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc exit {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), KERNELS[key[0]][1])
        fn.argtypes = ([ctypes.c_void_p] * _N_PTR[key[0]] + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def _layers(rng, dev, b, s, kv, g, dh, windows, causal):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    out = []
    for window in windows:
        q, cot = randn(b, s, kv * g, dh), randn(b, s, kv * g, dh)
        k, v = randn(b, s, kv, dh), randn(b, s, kv, dh)
        q_pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
        kv_pos = torch.arange(s, device=dev, dtype=torch.int32)
        kw = dict(softcap=0.0, window=window, causal=causal)
        o, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, **kw)
        delta = torch.sum(cot.float() * o.float(), dim=-1)
        out.append(dict(q=q, k=k, v=v, cot=cot, q_pos=q_pos, kv_pos=kv_pos, lse=lse,
                        delta=delta, kw=kw, o=torch.empty_like(q), lse_o=torch.empty_like(lse),
                        dk=torch.empty_like(k), dv=torch.empty_like(v),
                        dims=(b, s, s, kv, g, dh)))
    return out


def _pass(kernel, fn, layers):
    def run():
        stream = torch.cuda.current_stream().cuda_stream
        for x in layers:
            b, s, t, kv, g, dh = x["dims"]
            kw = x["kw"]
            tail = (b, s, t, kv, g, dh, int(kw["causal"]), kw["window"], kw["softcap"],
                    1.0 / math.sqrt(dh), 1, stream)
            if kernel == "fwd":
                args = (x["q"].data_ptr(), x["k"].data_ptr(), x["v"].data_ptr(),
                        x["q_pos"].data_ptr(), x["kv_pos"].data_ptr(), x["o"].data_ptr(),
                        x["lse_o"].data_ptr())
            else:
                args = (x["q"].data_ptr(), x["k"].data_ptr(), x["v"].data_ptr(),
                        x["cot"].data_ptr(), x["q_pos"].data_ptr(), x["kv_pos"].data_ptr(),
                        x["lse"].data_ptr(), x["delta"].data_ptr())
                args += ((x["o"].data_ptr(),) if kernel == "dq"
                         else (x["dk"].data_ptr(), x["dv"].data_ptr()))
            err = fn(*args, *tail)
            if err != 0:
                raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the times as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS), default=list(KERNELS),
                    help="the kernels to ablate (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("attn_ablation: needs a CUDA card\n")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    plan = [(kernel, v) for kernel in args.kernels for v in (None, *KERNELS[kernel][2])]
    fns = _build(plan)
    rng = np.random.default_rng(args.seed)
    shapes = {
        "bert-base": _layers(rng, dev, 48, 128, 12, 1, 64, [0] * 12, causal=False),
        "gemma3-1b global": _layers(rng, dev, 4, 1024, 1, 4, 256, [0] * 4, causal=True),
        "gemma3-1b local": _layers(rng, dev, 4, 1024, 1, 4, 256, [512] * 22, causal=True),
    }
    result = {"device": smi, "ms_per_layer": {}}
    for kernel in args.kernels:
        variants = KERNELS[kernel][2]
        for shape, layers in shapes.items():
            row = {}
            for i, v in enumerate((None, *variants, None)):
                name = "base" if v is None else v
                ms = graph_ms(_pass(kernel, fns[kernel, v], layers)) / len(layers)
                row[name if i == 0 or v is not None else "base_again"] = ms
            result["ms_per_layer"][f"{kernel} {shape}"] = row
            print(f"ablation: {kernel} {shape} ms per layer: "
                  + " ".join(f"{k}={ms:.4f}" for k, ms in row.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
