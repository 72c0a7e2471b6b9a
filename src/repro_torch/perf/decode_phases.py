"""Where one block of the decode kernel (``csrc/flash_decode.cu``) spends
its time: a copy of the kernel with clock reads put in, whose thread 0 of
block (0, 0) (cluster rank 0, lane 0) reads ``clock64()`` at each phase
boundary, run at gemma3-1b decode shapes.

    PYTHONPATH=src python -m repro_torch.perf.decode_phases [--out FILE]

Runs on a CUDA card only. Copies ``kernels/csrc`` into
``build/decode_phases/src/``, puts a ``PHASE(i)`` read at each place of
``MARKS`` and the clock store and its C entry ``flash_decode_phases`` in
(the shipped source holds none of it), builds the copy with the flags of
``kernels/build.py``, launches each case a few times and prints, per
phase, the SM cycles it took and those cycles at the SM clock
``nvidia-smi`` reads right after. The phases: position read and first
copies issued; first chunk landed; scores; softmax; P.V; the other
chunks; the first cluster barrier; the peers' maxima and sums and the
weights; the weighted output pushed to its owners and the second cluster
barrier; the block's slice summed and written. The profiler's execution
time (``perf/decode_time.py``) minus the block's span is what the launch
and the other blocks add. An edit that no longer matches the source
stops the run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess

import torch

from repro_torch.kernels import build

OUT_DIR = build.ROOT / "build" / "decode_phases"
PHASES = ("position_and_issue", "first_chunk_landed", "scores", "softmax", "pv",
          "other_chunks", "first_cluster_sync", "weights", "push_and_cluster_sync",
          "output_written")
#: (kind, bucket, cluster size) at B 4, bf16
CASES = (("global", 1024, 16), ("local", 1024, 8), ("global", 256, 4), ("global", 64, 1))

#: the clock store, put in before the kernel's namespace
_CLOCK = """\
__device__ long long decode_phase_clock[16];
#define PHASE(i)                                                                   \\
  do {                                                                             \\
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {                  \\
      long long c_;                                                                \\
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(c_)::"memory");                 \\
      decode_phase_clock[i] = c_;                                                  \\
    }                                                                              \\
  } while (0)
extern "C" int flash_decode_phases(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, decode_phase_clock, sizeof(decode_phase_clock)));
}

"""

#: where each clock read goes: PHASE(i) is put in just before the first
#: ``text`` after the previous mark's place in ``decode_kernel``, the phases
#: of the chunk loop at its first chunk only; PHASE(10) goes after its text
MARKS = (
    "  cg::cluster_group cluster = cg::this_cluster();\n",
    "  if (tid < kMaxGroup) {\n",
    "    // 1. the chunk's scores",
    "    // 2. per head",
    "    // 3. O = alpha O + P V",
    "    if (c + 2 < n_chunks) {\n",
    "  // The merge.",
    "  {\n    // thread g * 16 + r",
    "  // Each block pushes",
    "  // block r sums its slice",
    "    out[(long long)bh * width + e] = from_f32<T>(acc_e);\n  }\n",
)


def phase_source(root=OUT_DIR):
    """Write the sources with the clock reads into ``root``/src/; returns
    the path of the edited flash_decode.cu."""
    where = root / "src"
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(build.CSRC, where)
    path = where / "flash_decode.cu"
    text = path.read_text()
    at = text.find("__global__ void __launch_bounds__(kThreads)\ndecode_kernel(")
    if at < 0:
        raise RuntimeError("decode_phases: decode_kernel not found in flash_decode.cu")
    for i, mark in enumerate(MARKS):
        at = text.find(mark, at)
        if at < 0:
            raise RuntimeError(f"decode_phases: {mark.strip()!r} (phase {i}) not found in "
                               "flash_decode.cu: the edit no longer matches the source")
        in_loop = 2 <= i <= 5
        indent = "    " if in_loop else "  "
        read = f"{indent}{'if (c == 0) ' if in_loop else ''}PHASE({i});\n"
        if i == len(MARKS) - 1:
            at += len(mark)
        text = text[:at] + read + text[at:]
        at += len(read) + (0 if i == len(MARKS) - 1 else len(mark))
    ns = text.find("namespace {\n")
    path.write_text(text[:ns] + _CLOCK + text[ns:])
    return path


def _build():
    src = phase_source()
    lib = OUT_DIR / "libflash_decode_phases.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.flash_decode_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    so.flash_decode_launch.restype = ctypes.c_int
    so.flash_decode_shares.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    so.flash_decode_shares.restype = ctypes.c_int
    so.flash_decode_phases.argtypes = [ctypes.c_void_p]
    so.flash_decode_phases.restype = ctypes.c_int
    return so


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_phases: needs a CUDA card")
    import numpy as np

    from repro_torch import configs
    from repro_torch.perf import decode_time

    so = _build()
    dev = torch.device("cuda", 0)
    cfg = configs.get_config("gemma3-1b")
    rows = []
    for kind, t, cluster in CASES:
        rng = np.random.default_rng(0)
        layers, pos_np, pos = decode_time.layer_inputs(cfg, dev, rng, 4, t, torch.bfloat16, n=1)
        q, k, v = layers[0]
        out = torch.empty_like(q)
        b, _, h, dh = q.shape
        kv = k.shape[2]
        window = cfg.sliding_window if kind == "local" else 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(5):
            err = so.flash_decode_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                                         out.data_ptr(), b, t, kv, h // kv, dh, cluster, window,
                                         float(cfg.attn_logit_softcap or 0.0),
                                         1.0 / math.sqrt(dh), 1, stream)
            if err != 0:
                raise RuntimeError(f"decode_phases: launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        clocks = (ctypes.c_longlong * 16)()
        if so.flash_decode_phases(clocks) != 0:
            raise RuntimeError("decode_phases: reading the phase clocks failed")
        shares = (ctypes.c_int * (2 * cluster))()  # lane 0's; block rank 0 is timed
        so.flash_decode_shares(int(pos_np[0]), t, window, cluster, shares)
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True, timeout=60).stdout.split()[0])
        cycles = {name: clocks[i + 1] - clocks[i] for i, name in enumerate(PHASES)}
        row = {"kind": kind, "T": t, "cluster": cluster, "sm_mhz": mhz,
               "block_rows": [shares[0], shares[1]],
               "cycles": cycles, "us": {n: c / mhz for n, c in cycles.items()},
               "block_span_us": (clocks[len(PHASES)] - clocks[0]) / mhz}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
