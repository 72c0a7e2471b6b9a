"""Per-layer device time of the decode attention kernel (``flash_attn.
flash_decode``) at gemma3-1b's decode shapes, beside its plain version,
``scaled_dot_product_attention`` on the same inputs and the bound.

    PYTHONPATH=src python -m repro_torch.perf.decode_time [--out FILE] [--label NAME]

Runs on a CUDA card only. For each case (layer kind: local, window 512,
or global; bucket T: 64, where launch and latency are all there is, and
256 to 1024; dtype) it makes 26 layers of their own caches (26 x 4 MB at
T 1024 in bf16, past the 50 MB L2), B 4 lanes at positions drawn from
[T/2, T), and times one pass over them by CUDA-graph replay, divided by
26: the kernel twice, its plain version, SDPA (the fastest backend that
takes a boolean mask and the group). The bound is the larger of the bytes
the layer must move (the K/V rows the lanes see, q and the output, each
once) at 3.35 TB/s and its operations at the dtype's peak. The profiler
gives the kernels' own execution time in one eager pass, apart from the
gaps between launches. Then the kernel at the 1024 bucket under several
split counts.

The module reaches the package only through ``flash_attn.flash_decode``'s
calling convention, ``configs.get_config`` and ``perf.timers``, so it
times another checkout's kernel as well (one whose ``perf.timers`` has
``graph_ms``): run it by path with that checkout's ``src`` first on
``PYTHONPATH`` (``PYTHONPATH=../old/src python
src/repro_torch/perf/decode_time.py``); that checkout builds its own
kernel into its own ``build/kernels``. Prints one JSON line per case.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.perf.timers import HBM_BYTES_PER_S, PEAK_OPS_PER_S, graph_ms

#: (kind, bucket, dtype) cases
CASES = [("global", 64, torch.bfloat16),  # 32-63 rows a lane: the launch and latency floor
         ("local", 256, torch.bfloat16), ("global", 256, torch.bfloat16),
         ("local", 512, torch.bfloat16), ("global", 512, torch.bfloat16),
         ("local", 1024, torch.bfloat16), ("global", 1024, torch.bfloat16),
         ("local", 1024, torch.float32), ("global", 1024, torch.float32)]
#: split counts (cluster sizes) swept at the 1024 bucket in bf16
SPLITS = (1, 4, 8, 16)
LAYERS = 26


def layer_inputs(cfg, dev, rng, slots, t, dtype, n=LAYERS):
    """``n`` layers' (q, k, v) at the decode shape, and the lanes' (B, 1)
    int32 positions, drawn from [t // 2, t)."""
    kv, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim

    def mk(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    layers = [(mk((slots, 1, kv * g, dh)), mk((slots, t, kv, dh)), mk((slots, t, kv, dh)))
              for _ in range(n)]
    pos_np = rng.integers(t // 2, t, size=slots).astype(np.int32)
    return layers, pos_np, torch.from_numpy(pos_np).to(dev)[:, None]


def bound_ms(cfg, pos_np, t, dtype, local):
    """(ms, "bytes" or "operations") for one layer: the K/V rows the lanes
    see, q and the output and the positions, each moved once; 4 G Dh
    operations per row (q.k and p.v, a multiply and an add each)."""
    kv, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    item = torch.finfo(dtype).bits // 8
    rows = sum(min(int(p) + 1, t, cfg.sliding_window) if local else min(int(p) + 1, t)
               for p in pos_np)
    nbytes = rows * kv * dh * item * 2 + 2 * len(pos_np) * kv * g * dh * item + 4 * len(pos_np)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = rows * kv * g * dh * 4 / PEAK_OPS_PER_S[dtype] * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


#: names of the decode kernels: this one's, and the split and merge
#: kernels of the two-launch design it replaced
KERNEL_NAMES = ("decode_kernel", "decode_split_kernel", "merge_kernel")


def kernel_us(fn, names=KERNEL_NAMES):
    """Device time (us) of the kernels whose name holds one of ``names`` in
    one eager run of ``fn()``, by the profiler: their execution alone, without
    the gaps between launches that a graph replay's time includes. Also
    their count of launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if any(n in e.key for n in names) and not e.key.startswith("aten::") and dev_us > 0:
            us += dev_us
            n += e.count
    return us, n


def time_case(flash_attn, cfg, dev, kinds, t, dtype, *, slots=4, seed=0, splits=()):
    """One case's per-layer times (ms). ``kinds`` is one layer kind
    ("local" or "global") for ``LAYERS`` layers, or a sequence of them, one
    per layer (the model's own ``cfg.layer_kinds``). Gives ``ms`` and
    ``ms_repeat`` (the kernel at its default split count), ``ms_eager``
    (the kernel as the model calls it, the host's launches included),
    ``plain_ms``, ``library_ms`` (SDPA) and ``bound_ms``; ``exec_ms``, the
    kernels' own execution per layer by the profiler, and
    ``launches_per_layer``; and ``ms_by_splits`` for each of ``splits``."""
    import torch.nn.functional as F

    kinds = [kinds] * LAYERS if isinstance(kinds, str) else list(kinds)
    flags = [k == "local" for k in kinds]
    rng = np.random.default_rng(seed)
    layers, pos_np, pos = layer_inputs(cfg, dev, rng, slots, t, dtype, n=len(kinds))
    kw = dict(softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)

    def run(backend=None, n_splits=None):
        for (q, k, v), local in zip(layers, flags):
            flash_attn.flash_decode(q, k, v, pos, local, backend=backend, n_splits=n_splits, **kw)

    kpos = torch.arange(t, device=dev)
    masks = {}
    for local in set(flags):
        m = kpos[None, :] <= pos
        if local:
            m = m & (pos - kpos[None, :] < cfg.sliding_window)
        masks[local] = m[:, None, None, :]  # (B, 1, 1, T)
    lib_in = [(q.transpose(1, 2), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
               masks[local]) for (q, k, v), local in zip(layers, flags)]

    def run_library():
        for q, k, v, m in lib_in:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True)

    n = len(layers)
    out = {"kind": kinds[0] if len(set(kinds)) == 1 else "model", "T": t, "B": slots,
           "dtype": str(dtype).replace("torch.", ""), "positions": pos_np.tolist(), "layers": n}
    out["ms"] = graph_ms(run) / n
    out["plain_ms"] = graph_ms(lambda: run("plain")) / n
    out["library_ms"] = graph_ms(run_library) / n
    out["ms_repeat"] = graph_ms(run) / n
    out["ms_eager"] = eager_ms(run) / n
    us, launches = kernel_us(run)
    out["exec_ms"], out["launches_per_layer"] = us / 1e3 / n, launches / n
    bounds = [bound_ms(cfg, pos_np, t, dtype, local) for local in flags]
    out["bound_ms"] = sum(ms for ms, _ in bounds) / n
    out["bound_by"] = "bytes" if all(by == "bytes" for _, by in bounds) else "operations"
    out["ms_by_splits"] = {str(s): graph_ms(lambda s=s: run(n_splits=s)) / n for s in splits}
    return out


def eager_ms(fn, iters=20):
    """Device ms of ``fn()`` called eagerly, as a model calls it (CUDA events
    over ``iters`` calls after three)."""
    for _ in range(3):
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
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--label", default="", help="a name carried in every line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_time: needs a CUDA card")
    from repro_torch import configs
    from repro_torch.kernels import flash_attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = configs.get_config("gemma3-1b")
    rows = []
    for kind, t, dtype in CASES:
        splits = SPLITS if (t == 1024 and dtype == torch.bfloat16) else ()
        row = {"label": args.label, "card": smi,
               **time_case(flash_attn, cfg, dev, kind, t, dtype, splits=splits)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)


if __name__ == "__main__":
    main()
