"""Per-layer device time of the bf16 training attention forward
(``flash_attn._fwd_cuda``) at every layer PERF.md times, beside its bound
and, with ``--library``, ``scaled_dot_product_attention``'s forward on the
same inputs.

    PYTHONPATH=src python -m repro_torch.perf.fwd_time [--library] [--tag NAME] [--out FILE]

Runs on a CUDA card only. Each layer set is a pass over layers of their
own inputs (drawn with numpy from a seed of the layer's shape, so two
runs draw the same):
bert-base (B 48, S = T 128, H 12, Dh 64, non-causal; 12 layers),
gemma3-1b's global and local layers (B 4, S = T 1024, H 4 over KV 1, Dh
256, causal, window 512 on the local ones; 4 and 8), qwen2-moe-a2.7b (B 4,
S 1024, H 16, G 1, Dh 128; 2), zamba2-7b's shared block (B 4, S 1024, H
32, G 1, Dh 112; 2), whisper-small's encoder (B 8, S = T 1,500, H 12, Dh
64, non-causal; 1) and decoder (B 8, S 448, causal; 2) and
llama-3.2-vision-90b's self layer (B 4, S 1024, H 64 over KV 8, Dh 128; 1).
The pass is timed twice by CUDA-graph replay and divided by its layers.
The bound is the larger of the bytes the layer must move (q, k, v read
once, out and the f32 lse written once, the positions) at 3.35 TB/s and
its operations (two products over the valid (query, key) pairs) at 989
TFLOP/s. SDPA's forward is timed eagerly (the median of five timings of
ten passes, by CUDA events) under each backend that takes the layer, K
and V expanded to the query heads outside the timed region; the fastest
is reported.

The module reaches the package only through ``flash_attn._fwd_cuda``'s
calling convention and ``perf.timers``, so it times another checkout's
forward as well: run it by path with that checkout's ``src`` first on
``PYTHONPATH`` (``PYTHONPATH=../old/src python
src/repro_torch/perf/fwd_time.py --tag old``); that checkout builds its
own kernel into its own ``build/kernels``. Prints the card's name and
power limit, then one JSON line per layer set.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.perf.timers import HBM_BYTES_PER_S, PEAK_OPS_PER_S, graph_ms

#: (label, B, S, KV, G, Dh, causal, window, layers)
LAYERS = [("bert-base", 48, 128, 12, 1, 64, False, 0, 12),
          ("gemma3-1b global", 4, 1024, 1, 4, 256, True, 0, 4),
          ("gemma3-1b local", 4, 1024, 1, 4, 256, True, 512, 8),
          ("qwen2-moe-a2.7b", 4, 1024, 16, 1, 128, True, 0, 2),
          ("zamba2-7b", 4, 1024, 32, 1, 112, True, 0, 2),
          ("whisper-small encoder", 8, 1500, 12, 1, 64, False, 0, 1),
          ("whisper-small decoder", 8, 448, 12, 1, 64, True, 0, 2),
          ("llama-3.2-vision-90b", 4, 1024, 8, 8, 128, True, 0, 1)]


def layer_inputs(rng, dev, b, s, kv, g, dh, n):
    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    q_pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    kv_pos = torch.arange(s, device=dev, dtype=torch.int32)
    return [(mk(b, s, kv * g, dh), mk(b, s, kv, dh), mk(b, s, kv, dh), q_pos, kv_pos)
            for _ in range(n)]


def bound_ms(b, s, kv, g, dh, causal, window):
    """(ms, "bytes" or "operations") of one layer."""
    qp = torch.arange(s)[:, None]
    kp = torch.arange(s)[None, :]
    valid = torch.ones(s, s, dtype=torch.bool)
    if causal:
        valid &= kp <= qp
    if window:
        valid &= (qp - kp) < window
    pairs = b * kv * g * int(valid.sum())
    nbytes = 2 * (2 * b * s * kv * g * dh + 2 * b * s * kv * dh) + 4 * b * s * kv * g \
        + 4 * (b * s + s)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * pairs * dh / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def sdpa_ms(xs, g, causal, window):
    """{backend: median ms per call} of SDPA's forward over the layers."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    lib = []
    for q, k, v, q_pos, kv_pos in xs:
        kt, vt = (x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous() for x in (k, v))
        mask = None
        if window:
            qp, kp = q_pos[0][:, None], kv_pos[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        lib.append((q.transpose(1, 2).contiguous(), kt, vt, mask))

    def call(qt, kt, vt, mask):
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        with sdpa_kernel([backend]), torch.no_grad():
            try:
                for x in lib:
                    call(*x)
                torch.cuda.synchronize()
            except RuntimeError:  # this backend does not take the layer
                continue
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    for x in lib:
                        call(*x)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 10 / len(lib))
            out[name] = sorted(times)[2]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label carried on every line")
    ap.add_argument("--library", action="store_true",
                    help="also time scaled_dot_product_attention's forward")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("fwd_time: needs a CUDA card\n")
        return 2
    from repro_torch.kernels import flash_attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    lines = []
    for label, b, s, kv, g, dh, causal, window, n in LAYERS:
        rng = np.random.default_rng([b, s, kv, g, dh, window])
        xs = layer_inputs(rng, dev, b, s, kv, g, dh, n)
        kw = dict(softcap=0.0, window=window, causal=causal)

        def run():
            for x in xs:
                flash_attn._fwd_cuda(*x, **kw)

        ms = [graph_ms(run) / n for _ in range(2)]
        bound, bound_by = bound_ms(b, s, kv, g, dh, causal, window)
        line = {"tag": args.tag, "layer": label, "B": b, "S": s, "KV": kv, "G": g, "Dh": dh,
                "causal": causal, "window": window, "layers": n, "ms": ms[0],
                "ms_repeat": ms[1], "bound_ms": bound, "bound_by": bound_by, "device": smi}
        if args.library:
            lib = sdpa_ms(xs, g, causal, window)
            best = min(lib, key=lib.get)
            line.update(library_ms=lib[best], library_backend=best, library_ms_by_backend=lib)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del xs
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
