#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Phases, in order; any failure exits non-zero:

1. device: requires a CUDA card and prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles the port's CUDA kernel from ``src/repro_torch/kernels/
   csrc/flash_decode.cu`` and prints the time.
3. kernel: ``flash_decode`` against its plain PyTorch version on the card
   at gemma3-1b shapes (B in {1, 4, 8}, KV=1, G=4, Dh=256, T in {16, 128,
   1024, 2048}, window on and off, softcap 0 and 50, split counts 1, 3, 7
   and the heuristic's), f32 within 1e-5 and bf16 within 2e-2 abs, and
   the 2-byte dtypes within half an ulp (+1e-5) of the plain version in
   f32 on the same inputs; then
   the kernel, plain and library (``scaled_dot_product_attention``) times
   over one pass of 26 layers at the serving shape.
4. serve f32: gemma3-1b at full width and depth in f32, random weights
   from a seed, 8 requests of 300-900 prompt tokens through the
   continuous-batching executor; every status ``ok`` and the tokens equal
   to the serial ``greedy_generate``, request by request.
5. serve bf16: the config's own dtype, 16 requests of 256-960 tokens;
   qps, TTFT/TPOT, memory, and ``flash_decode`` launches = 26 x decode
   steps; a ``torch.profiler`` trace of one decode step goes to DIR.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. The weights are random; nothing is downloaded.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM (NVIDIA data sheet): HBM rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SEED = 0


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time of ``fn()``: its launches captured once in a CUDA graph
    and replayed, so the host's launch overhead drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; this "
                         "script runs only on a CUDA card\n")
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path, nvcc_out = build.build()
    secs = time.perf_counter() - t0
    log(f"build: flash_decode -> {os.path.relpath(path, HERE)}")
    for line in nvcc_out.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build_seconds: {secs:.2f}")
    return secs


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def _decode_inputs(rng, b, t, dtype, dev, kv=1, g=4, dh=256):
    def mk(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    return mk((b, 1, kv * g, dh)), mk((b, t, kv, dh)), mk((b, t, kv, dh))


def _positions(rng, b, t):
    """Per-lane positions < T, covering pos < 512 and pos >= 512 where T
    allows both."""
    if t <= 512:
        return rng.integers(0, t, size=b)
    if b == 1:
        return np.array([t - 1])
    lo = rng.integers(0, 512, size=b)
    hi = rng.integers(512, t, size=b)
    return np.where(np.arange(b) % 2 == 0, lo, hi)


def _vs_f32(flash_attn, got, q, k, v, pos, local, kw, where):
    """A 2-byte kernel output against the plain version in f32 on the same
    inputs. The kernel works in f32 and rounds once when it stores, so
    each element is within half an ulp of its dtype (eps/2 relative) of
    the f32 result, plus the f32 tolerance. Returns the worst element's
    share of that bound (the check fails above 1)."""
    ref = flash_attn.flash_decode(q.float(), k.float(), v.float(), pos, local,
                                  backend="plain", **kw)
    bound = torch.finfo(got.dtype).eps / 2 * ref.abs() + TOL[torch.float32]
    share = ((got.float() - ref).abs() / bound).max().item()
    if not share <= 1.0:
        raise AssertionError(f"flash_decode {got.dtype} vs plain in f32: {share:.3f} of "
                             f"the half-ulp bound at {where}")
    return share


def phase_kernel_check(dev):
    from repro_torch.kernels import flash_attn

    rng = np.random.default_rng(SEED)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_vs_f32 = 0.0  # share of the half-ulp bound, 2-byte dtypes
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4, 8):
            for t in (16, 128, 1024, 2048):
                q, k, v = _decode_inputs(rng, b, t, dtype, dev)
                pos = torch.from_numpy(_positions(rng, b, t).astype(np.int32)).to(dev)[:, None]
                for local in (True, False):
                    for softcap in (0.0, 50.0):
                        kw = dict(softcap=softcap, window=512)
                        plain = flash_attn.flash_decode(q, k, v, pos, local, backend="plain", **kw)
                        for n_splits in (1, 3, 7, None):
                            got = flash_attn.flash_decode(q, k, v, pos, local,
                                                          n_splits=n_splits, **kw)
                            torch.cuda.synchronize()
                            if got.dtype != dtype or got.shape != q.shape:
                                raise AssertionError(f"flash_decode returned {got.dtype} "
                                                     f"{tuple(got.shape)}")
                            err = (got.float() - plain.float()).abs().max().item()
                            if not math.isfinite(err) or err > TOL[dtype]:
                                raise AssertionError(
                                    f"flash_decode vs plain: err {err:.3e} > {TOL[dtype]} at "
                                    f"dtype={dtype} B={b} T={t} local={local} "
                                    f"softcap={softcap} n_splits={n_splits}")
                            worst[dtype] = max(worst[dtype], err)
                            if dtype != torch.float32:
                                worst_vs_f32 = max(worst_vs_f32, _vs_f32(
                                    flash_attn, got, q, k, v, pos, local, kw,
                                    f"B={b} T={t} local={local} softcap={softcap} "
                                    f"n_splits={n_splits}"))
                            n += 1
    # the kernel's other group sizes, head dims and f16, beyond gemma3-1b
    for kv, g, dh, dtype in [(2, 1, 64, torch.float32), (2, 2, 128, torch.float32),
                             (1, 3, 64, torch.float32), (2, 8, 256, torch.float32),
                             (2, 2, 128, torch.float16), (1, 8, 64, torch.bfloat16)]:
        q, k, v = _decode_inputs(rng, 3, 300, dtype, dev, kv, g, dh)
        pos = torch.tensor([[299], [100], [0]], dtype=torch.int32, device=dev)
        kw = dict(window=64, softcap=30.0)
        plain = flash_attn.flash_decode(q, k, v, pos, True, backend="plain", **kw)
        got = flash_attn.flash_decode(q, k, v, pos, True, **kw)
        err = (got.float() - plain.float()).abs().max().item()
        if not err <= TOL.get(dtype, 2e-2):
            raise AssertionError(f"flash_decode vs plain: err {err:.3e} at KV={kv} G={g} "
                                 f"Dh={dh} {dtype}")
        if dtype != torch.float32:
            worst_vs_f32 = max(worst_vs_f32, _vs_f32(flash_attn, got, q, k, v, pos, True,
                                                     kw, f"KV={kv} G={g} Dh={dh}"))
        n += 1
    log(f"kernel_check: flash_decode vs plain, {n} cases, max_err_f32="
        f"{worst[torch.float32]:.3e} (tol 1e-5), max_err_bf16="
        f"{worst[torch.bfloat16]:.3e} (tol 2e-2); 2-byte dtypes vs plain in f32 "
        f"within {worst_vs_f32:.3f} of the eps/2 relative + 1e-5 bound")
    return worst, worst_vs_f32


def phase_kernel_time(dev, cfg, slots, t):
    """One pass over the model's layers (5:1 local:global, each layer its
    own cache, 26 x 4 MB > the 50 MB L2) at the serving shape."""

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    rng = np.random.default_rng(SEED + 1)
    dtype = torch.bfloat16
    kv, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    flags = [k == "local" for k in cfg.layer_kinds]
    pos_np = rng.integers(512, t, size=slots).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)[:, None]
    layers = [_decode_inputs(rng, slots, t, dtype, dev, kv, g, dh) for _ in flags]
    kw = dict(softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)

    def run(backend):
        for (q, k, v), local in zip(layers, flags):
            flash_attn.flash_decode(q, k, v, pos, local, backend=backend, **kw)

    # library yardstick: one scaled_dot_product_attention call with the same mask
    kpos = torch.arange(t, device=dev)
    masks = {}
    for local in (True, False):
        m = kpos[None, :] <= pos
        if local:
            m = m & (pos - kpos[None, :] < cfg.sliding_window)
        masks[local] = m[:, None, None, :]  # (B, 1, 1, T)
    lib_in = [(q.transpose(1, 2), k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous(), masks[local])
              for (q, k, v), local in zip(layers, flags)]

    def run_library():
        for q, k, v, m in lib_in:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m, enable_gqa=True)

    n = len(flags)
    # device times (graph replay), kernel twice for the spread; and the
    # kernel's time as the model calls it, host launch overhead included
    kernel_ms = graph_ms(lambda: run(None)) / n
    plain_ms = graph_ms(lambda: run("plain")) / n
    library_ms = graph_ms(run_library) / n
    kernel_ms_2 = graph_ms(lambda: run(None)) / n
    eager_ms = time_ms(lambda: run(None)) / n

    # least time for the same work: each input byte read once, each output
    # written once, K/V counted for the rows this data needs
    item = torch.finfo(dtype).bits // 8
    rows = 0
    for local in flags:
        for p in pos_np:
            seen = min(int(p) + 1, t)
            rows += min(seen, cfg.sliding_window) if local else seen
    kv_bytes = rows * kv * dh * item * 2
    qo_bytes = n * 2 * slots * kv * g * dh * item + n * slots * 4
    ops = rows * kv * g * dh * 4  # q.k and p.v, a multiply and an add each
    bytes_ms = (kv_bytes + qo_bytes) / HBM_BYTES_PER_S * 1e3 / n
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3 / n
    out = {
        "ms": kernel_ms, "ms_repeat": kernel_ms_2, "ms_eager": eager_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "shape": {"B": slots, "T": t, "KV": kv, "G": g, "Dh": dh, "dtype": "bfloat16",
                  "positions": pos_np.tolist(), "layers": n},
    }
    log(f"kernel_time: flash_decode per layer at B={slots} T={t} bf16: kernel_ms="
        f"{kernel_ms:.4f} (repeat {kernel_ms_2:.4f}, eager {eager_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={out['bound_ms']:.5f} ({out['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


def _requests(cfg, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=(int(L),)).astype(np.int64) for L in lens]


def _serve(model, params, prompts, gen, scfg):
    from repro_torch import serve
    from repro_torch.kernels import dispatch

    ex = serve.ServeExecutor(model, params, scfg)
    ids = [ex.submit(p, max_new_tokens=gen) for p in prompts]
    torch.cuda.synchronize()
    dispatch.reset_launches()  # counts of the main path's run only
    t0 = time.perf_counter()
    stats = ex.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launches("flash_decode")
    statuses = [ex.results[i].status for i in ids]
    if statuses != [serve.STATUS_OK] * len(ids):
        raise AssertionError(f"serve statuses {statuses}: every request must be 'ok'")
    for i in ids:
        toks = ex.results[i].tokens
        if len(toks) != gen or not all(0 <= x < model.cfg.vocab_size for x in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, expected {gen} in vocab")
    if launches < 1:
        raise AssertionError("the serve run launched no flash_decode kernel")
    return ex, ids, stats, launches, wall


def phase_serve_f32(base_cfg, params, dev):
    from repro_torch import serve
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    gen, max_len = 16, 1024
    prompts = _requests(cfg, 8, 300, 900, SEED + 2)
    scfg = serve.ServeConfig(slots=4, page_size=16, max_len=max_len, max_new_tokens=gen)
    ex, ids, stats, launches, wall = _serve(model, params, prompts, gen, scfg)
    for i, p in zip(ids, prompts):
        ref = serve.greedy_generate(model, params, torch.as_tensor(p)[None], gen, max_len)
        ref = [int(x) for x in ref[0].cpu()]
        if ex.results[i].tokens != ref:
            raise AssertionError(f"f32 request {i}: continuous {ex.results[i].tokens} "
                                 f"!= serial {ref}")
    log(f"serve_f32: {len(ids)} requests ok, tokens equal to serial greedy_generate "
        f"for all; decode_steps={stats.steps} flash_decode_launches={launches} "
        f"wall_s={wall:.3f}")


def phase_serve_bf16(cfg, params, dev, out_dir):
    from repro_torch import serve
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    gen = 32
    prompts = _requests(cfg, 16, 256, 960, SEED + 3)
    scfg = serve.ServeConfig(slots=4, page_size=16, max_len=1024, max_new_tokens=gen)
    torch.cuda.reset_peak_memory_stats()
    ex, ids, stats, launches, wall = _serve(model, params, prompts, gen, scfg)
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers * stats.steps:
        raise AssertionError(f"flash_decode launches {launches} != {cfg.num_layers} x "
                             f"{stats.steps} decode steps")
    result = {
        "requests": len(ids), "qps": stats.qps, "wall_s": wall,
        "ttft_p50_ms": stats.ttft.p50_us / 1e3, "ttft_p99_ms": stats.ttft.p99_us / 1e3,
        "tpot_p50_ms": stats.tpot.p50_us / 1e3, "tpot_p99_ms": stats.tpot.p99_us / 1e3,
        "decode_steps": stats.steps, "flash_decode_launches": launches,
        "max_memory_allocated": peak,
    }
    log("serve_bf16: " + json.dumps(result))
    result["step_profile"] = profile_step(model, params, scfg, prompts[:4], out_dir)
    return result, launches


def profile_step(model, params, scfg, prompts, out_dir):
    """A torch.profiler trace of one fused decode step with four live lanes
    (launches here are outside the counted run)."""

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ContinuousBatcher, Request

    b = ContinuousBatcher(model, params, scfg)
    for i, p in enumerate(prompts):
        b.admit(Request(id=i, payload={"prompt": p, "max_new_tokens": 64}, submit_t=0.0), 0.0)
    for _ in range(3):  # warm
        b.harvest(b.dispatch())
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):  # the step as the executor runs it, profiler off
        t0 = time.perf_counter()
        b.harvest(b.dispatch())
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        b.harvest(b.dispatch())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "decode_step_trace.json"))
    rows = []  # device kernels (aten:: rows repeat their kernels' time)
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and not e.key.startswith("aten::"):
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    total_dev_ms = sum(r[1] for r in rows) / 1e3
    with open(os.path.join(out_dir, "decode_step_kernels.txt"), "w") as f:
        for key, us, count in rows:
            f.write(f"{us:12.1f} us  {count:5d}x  {key}\n")
    top = [{"name": k[:80], "us": round(us, 1), "count": c} for k, us, c in rows[:12]]
    step_ms = float(np.median(walls))
    prof_out = {"step_wall_ms": step_ms, "step_wall_ms_all": walls,
                "profiled_wall_ms": wall_ms, "device_ms": total_dev_ms,
                "device_busy_share": total_dev_ms / step_ms,
                "kernel_launches": sum(c for _, _, c in rows), "top": top}
    log("step_profile: " + json.dumps(prof_out))
    return prof_out


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the profiler trace of one decode step")
    args = ap.parse_args()

    phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.common import tree_flatten

    dev = torch.device("cuda", 0)
    cfg = configs.get_config("gemma3-1b")
    entry = {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_attn.py:490"}
    entry["build_seconds"] = phase_build()
    worst, worst_vs_f32 = phase_kernel_check(dev)
    timing = phase_kernel_time(dev, cfg, slots=4, t=1024)
    # "max_abs_err" and "ms" are the keys every kernels line carries; they
    # are the bf16 error and the kernel time, which the serving path's own
    # names max_err_bf16 and kernel_ms repeat
    entry.update({"max_abs_err": worst[torch.bfloat16], "max_err_f32": worst[torch.float32],
                  "max_err_bf16": worst[torch.bfloat16],
                  "bf16_vs_f32_share_of_bound": worst_vs_f32,
                  "kernel_ms": timing["ms"], **timing})
    t0 = time.perf_counter()
    params = Model(cfg, device=dev).init(SEED)
    torch.cuda.synchronize()
    log(f"init: gemma3-1b {sum(x.numel() for x in tree_flatten(params)[0])} params f32 "
        f"in {time.perf_counter() - t0:.2f}s")
    phase_serve_f32(cfg, params, dev)
    serve_out, launches = phase_serve_bf16(cfg, params, dev, args.out)
    entry["launches"] = launches
    entry["serve_bf16"] = serve_out
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
