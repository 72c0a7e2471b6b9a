#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Phases, in order, each printing its seconds; any failure exits non-zero:

1. device: requires a CUDA card and prints the
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles every kernel source under ``src/repro_torch/kernels/
   csrc/`` (``flash_decode``, ``flash_attn_fwd``, ``flash_attn_bwd``,
   ``adam_adapt``, ``weighted_ce``, ``lion_adapt``, ``adafactor_adapt``),
   one nvcc per source, all at once; prints each build's seconds and the
   ``-Xptxas -v`` register, spill and shared-memory lines.
3. decode kernel: ``flash_decode`` against its plain PyTorch version on
   the card at gemma3-1b shapes (B in {1, 4, 8}, KV=1, G=4, Dh=256, T in
   {16, 128, 1024, 2048}, window on and off, softcap 0 and 50, split
   counts 1, 3, 7 and the heuristic's), f32 within 1e-5 and bf16 within
   2e-2 abs, and the 2-byte dtypes within half an ulp (+1e-5) of the plain
   version in f32 on the same inputs; then the kernel, plain and library
   (``scaled_dot_product_attention``) times over one pass of 26 layers at
   the serving shape.
4. training kernels: the flash-attention forward and its dq and dk/dv
   backward kernels through autograd, at bert-base's shape and at a
   gemma-like one (G 4, KV 1, Dh 256, window, softcap, causal, ragged S
   and T), f32 (1e-5 forward, 5e-5 + 1e-4 relative gradients) and bf16
   (2e-2 + 2e-2 relative), the bf16 results also within half an ulp (plus
   the f32 tolerance) of the plain version in f32 on the same inputs;
   ``adam_adapt`` at the embedding's 23,440,896 elements, the stacked MLP
   weights' 28,311,552 and a ragged size (rtol 1e-5, sum of squares 1e-4);
   ``weighted_ce`` forward and backward at gemma3-1b's LM loss (the (4,
   1023, 262144) logits view, R 4,092) and at R 37, V 5,000, f32 and bf16
   logits (ce and lse within 1e-5 (1 + |ref|); dlogits within 1e-6 +
   1e-5 |ref| of the plain version in f32, plus half an ulp for bf16);
   ``lion_adapt`` and ``adafactor_adapt`` at bert-base's embedding,
   gemma3-1b's embedding (301,989,888) and a ragged size (as
   ``adam_adapt``); then each kernel's time (per bert-base layer at B 48,
   S 128, bf16; the CE at gemma3-1b's shape in f32; the adaptation
   products at 23.4 M elements) beside its plain version's, the library
   call's and the bound.
5. serve f32: gemma3-1b at full width and depth in f32, random weights
   from a seed, 8 requests of 300-900 prompt tokens through the
   continuous-batching executor; every status ``ok`` and the tokens equal
   to the serial ``greedy_generate``, request by request.
6. serve bf16: the config's own dtype, 16 requests of 256-960 tokens;
   qps, TTFT/TPOT, memory, and ``flash_decode`` launches = 26 x decode
   steps; a ``torch.profiler`` trace of one decode step goes to DIR.
7. train f32: bert-base at full width and depth in f32, three SAMA meta
   steps, each from one state through the kernels and again with every
   kernel forced to its plain version (``dispatch.plain_everywhere``, a
   context the model never enters), base Adam eps 1e-3 (see
   ``phase_train_f32``): losses within 1e-5, eps and hypergrad_norm within
   2e-3 relative, theta and lam per leaf within 1e-6 + 5% of the step's
   largest update (the tolerances of tests/test_torch_sama.py, where the
   port is held against JAX); one step at the paper's eps 1e-8 reported.
8. train bf16: bert-base in its own dtype, batch 48, seq 128, unroll 2, 10
   meta steps through ``MetaLearner.fit`` on WRENCH-analog data: step wall
   time, samples/s, peak memory, each kernel's launches against L(K+3) +
   L(K+1) forwards, L(K+1) dq and dk/dv and one adam_adapt per theta leaf
   per step, and a profiled step's device time by phase and by kernel.
9. train gemma f32: gemma3-1b at full width and depth in f32, the
   per-sequence LM loss through ``weighted_ce``, batch 2, seq 1024, unroll
   2: phase 7's three held step pairs, with K + 3 CE forwards and K + 1
   backwards per kernel step, and one step at eps 1e-8 reported.
10. train gemma bf16: two steps of ``python -m repro_torch.launch.train``'s
   ``main`` at its default arch (gemma3-1b), then 10 meta steps at batch 4,
   seq 1024, unroll 2, meta batch 2 as phase 8 times bert-base, with the
   CE launches (5 forward, 3 backward per step) held as well.
11. Lion and Adafactor: bert-base in f32 with each at the base level,
   phase 7's three held step pairs each, one ``lion_adapt`` or
   ``adafactor_adapt`` launch per theta leaf per kernel step.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. The weights and data are random, from seeds; nothing is downloaded.
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
    results = build.build_all()
    secs = time.perf_counter() - t0
    per = {}
    for name, path, nvcc_out, done in results:
        per[name] = done
        log(f"build: {name} -> {os.path.relpath(path, HERE)} ({done:.2f}s)")
        kernel = ""
        for line in nvcc_out.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:90] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {kernel}: {line.strip()}")
    log(f"build_seconds: {secs:.2f} (all sources at once)")
    return per


# ---------------------------------------------------------------------------
# phase 3: the decode kernel
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
# phases 5-6: serving
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
# phase 4: the training kernels
# ---------------------------------------------------------------------------

#: (name, B, S, T, KV, G, Dh, causal, window, softcap): bert-base's layer
#: and a gemma-like training shape with ragged S and T
TRAIN_SHAPES = [
    ("bert-base", 48, 128, 128, 12, 1, 64, False, 0, 0.0),
    ("gemma-like", 2, 300, 333, 1, 4, 256, True, 128, 50.0),
]
#: (atol, rtol) per dtype: forward, gradients (tests/test_flash_attention.py)
ATTN_TOL = {torch.float32: ((1e-5, 0.0), (5e-5, 1e-4)),
            torch.bfloat16: ((2e-2, 2e-2), (2e-2, 2e-2))}
ADAM_SIZES = (23_440_896, 28_311_552, 1_000_003)  # embed, stacked MLP leaf, ragged


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _attn_inputs(rng, dev, dtype, b, s, t, kv, g, dh):
    q, cot = (_randn(rng, (b, s, kv * g, dh), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (b, t, kv, dh), dtype, dev) for _ in range(2))
    q_pos = (torch.arange(s, device=dev, dtype=torch.int32) + (t - s))[None].expand(b, s)
    return q, k, v, cot, q_pos.contiguous(), torch.arange(t, device=dev, dtype=torch.int32)


def _excess(got, ref, atol, rtol):
    """Worst |got - ref| over its allowance atol + rtol |ref| (fails above 1)."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def phase_train_kernel_check(dev):
    from repro_torch.kernels import adam_adapt, dispatch, flash_attn

    rng = np.random.default_rng(SEED + 10)
    names = (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV)
    worst = {n: {torch.float32: 0.0, torch.bfloat16: 0.0} for n in names}
    share_vs_f32 = {n: 0.0 for n in names}
    for name, b, s, t, kv, g, dh, causal, window, softcap in TRAIN_SHAPES:
        kw = dict(softcap=softcap, window=window, causal=causal)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, cot, q_pos, kv_pos = _attn_inputs(rng, dev, dtype, b, s, t, kv, g, dh)

            def run(backend):
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = flash_attn.flash_attention(*leaves, q_pos, kv_pos, True, backend=backend,
                                                 **kw)
                (out.float() * cot.float()).sum().backward()
                return [out.detach()] + [x.grad for x in leaves]

            got, plain = run(None), run("plain")
            torch.cuda.synchronize()
            for i, (a, p) in enumerate(zip(got, plain)):
                kname = names[min(i, 2)]
                atol, rtol = ATTN_TOL[dtype][0 if i == 0 else 1]
                if a.dtype != dtype or a.shape != p.shape:
                    raise AssertionError(f"{kname}: {a.dtype} {tuple(a.shape)} at {name}")
                excess = _excess(a, p, atol, rtol)
                if not excess <= 1.0:
                    raise AssertionError(f"{kname} vs plain at {name} {dtype}: {excess:.3f} of "
                                         f"the tolerance (atol {atol}, rtol {rtol})")
                worst[kname][dtype] = max(worst[kname][dtype],
                                          (a.float() - p.float()).abs().max().item())
            if dtype == torch.bfloat16:
                # the bf16 kernels against the plain version in f32 on the
                # same inputs: each result rounded once from f32
                out, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, **kw)
                delta = torch.sum(cot.float() * out.float(), dim=-1)
                grads = flash_attn._bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, cot, **kw)
                ref_out, _ = flash_attn.flash_attention_fwd_plain(
                    q.float(), k.float(), v.float(), q_pos, kv_pos, **kw)
                ref_grads = flash_attn.flash_attention_bwd_plain(
                    q.float(), k.float(), v.float(), q_pos, kv_pos, lse, delta, cot.float(),
                    **kw)
                half_ulp = torch.finfo(torch.bfloat16).eps / 2
                for i, (a, r) in enumerate(zip([out, *grads], [ref_out, *ref_grads])):
                    kname = names[min(i, 2)]
                    atol, rtol = ATTN_TOL[torch.float32][0 if i == 0 else 1]
                    share = _excess(a, r, atol, rtol + half_ulp)
                    if not share <= 1.0:
                        raise AssertionError(f"{kname} bf16 vs plain in f32 at {name}: "
                                             f"{share:.3f} of the half-ulp bound")
                    share_vs_f32[kname] = max(share_vs_f32[kname], share)
    for kname in names:
        log(f"kernel_check: {kname} vs plain, max_err_f32={worst[kname][torch.float32]:.3e} "
            f"max_err_bf16={worst[kname][torch.bfloat16]:.3e}; bf16 vs plain in f32 within "
            f"{share_vs_f32[kname]:.3f} of the half-ulp bound")

    adam_worst = 0.0
    for n in ADAM_SIZES:
        for t in (1, 7):
            g, gm, m = (_randn(rng, (n,), torch.float32, dev) * 1e-2 for _ in range(3))
            v = _randn(rng, (n,), torch.float32, dev).square() * 1e-4
            step = torch.tensor(t, dtype=torch.int32, device=dev)
            lr = torch.tensor(1e-3, device=dev)
            out, ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr)
            ref, ref_ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr, backend="plain")
            excess = _excess(out, ref, 1e-7, 1e-5)
            ss_rel = abs(ss.item() - ref_ss.item()) / abs(ref_ss.item())
            if not (excess <= 1.0 and ss_rel <= 1e-4):
                raise AssertionError(f"adam_adapt vs plain at N={n} t={t}: out {excess:.3f} of "
                                     f"the tolerance, sum of squares {ss_rel:.2e} relative")
            adam_worst = max(adam_worst, (out - ref).abs().max().item())
            del g, gm, m, v, out, ref
    log(f"kernel_check: adam_adapt vs plain at N in {ADAM_SIZES}, t in (1, 7): "
        f"max_abs_err={adam_worst:.3e} (rtol 1e-5, atol 1e-7; sum of squares rtol 1e-4)")
    dispatch.reset_launches()
    return worst, share_vs_f32, adam_worst


def _bound(nbytes, ops, dtype):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_train_kernel_time(dev, cfg, batch, seq):
    """Per bert-base layer (one pass over cfg.num_layers layers' own inputs,
    so the 50 MB L2 does not hold them), bf16: the forward, dq and dk/dv
    kernels beside the plain versions and scaled_dot_product_attention;
    and adam_adapt at the embedding's size."""

    import torch.nn.functional as F

    from repro_torch.kernels import adam_adapt, flash_attn

    rng = np.random.default_rng(SEED + 11)
    dtype = torch.bfloat16
    b, s, h, dh = batch, seq, cfg.num_heads, cfg.head_dim
    kv, g, n = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.num_layers
    kw = dict(softcap=0.0, window=0, causal=False)
    layers = []
    for _ in range(n):
        q, k, v, cot, q_pos, kv_pos = _attn_inputs(rng, dev, dtype, b, s, s, kv, g, dh)
        out, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, **kw)
        delta = torch.sum(cot.float() * out.float(), dim=-1)
        layers.append(dict(q=q, k=k, v=v, cot=cot, q_pos=q_pos, kv_pos=kv_pos, lse=lse,
                           delta=delta, dq=torch.empty_like(q), dk=torch.empty_like(k),
                           dv=torch.empty_like(v)))
    dq_fn = flash_attn._train_fn("flash_attn_bwd", "flash_attn_dq_launch")
    dkv_fn = flash_attn._train_fn("flash_attn_bwd", "flash_attn_dkv_launch")

    def c_args(x):
        return (x["q"].data_ptr(), x["k"].data_ptr(), x["v"].data_ptr(), x["cot"].data_ptr(),
                x["q_pos"].data_ptr(), x["kv_pos"].data_ptr(), x["lse"].data_ptr(),
                x["delta"].data_ptr())

    def common():  # the stream is read at each call: under capture it is the graph's
        return (b, s, s, kv, g, dh, 0, 0, 0.0, 1.0 / math.sqrt(dh), 1,
                torch.cuda.current_stream(dev).cuda_stream)

    def checked(err, what):
        if err != 0:
            raise RuntimeError(f"{what} launch failed with CUDA error {err}")

    def run_fwd():
        for x in layers:
            flash_attn._fwd_cuda(x["q"], x["k"], x["v"], x["q_pos"], x["kv_pos"], **kw)

    def run_dq():
        for x in layers:
            checked(dq_fn(*c_args(x), x["dq"].data_ptr(), *common()), "dq")

    def run_dkv():
        for x in layers:
            checked(dkv_fn(*c_args(x), x["dk"].data_ptr(), x["dv"].data_ptr(), *common()), "dkv")

    def run_plain_fwd():
        for x in layers:
            flash_attn.flash_attention_fwd_plain(x["q"], x["k"], x["v"], x["q_pos"],
                                                 x["kv_pos"], **kw)

    def run_plain_bwd():
        for x in layers:
            flash_attn.flash_attention_bwd_plain(x["q"], x["k"], x["v"], x["q_pos"],
                                                 x["kv_pos"], x["lse"], x["delta"], x["cot"],
                                                 **kw)

    lib = []
    for x in layers:
        qt, kt, vt = (x[name].transpose(1, 2).contiguous().requires_grad_(True)
                      for name in ("q", "k", "v"))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        lib.append((qt, kt, vt, out, x["cot"].transpose(1, 2).contiguous()))

    def run_lib_fwd():
        with torch.no_grad():
            for qt, kt, vt, _, _ in lib:
                F.scaled_dot_product_attention(qt, kt, vt)

    def run_lib_bwd():
        for qt, kt, vt, out, ct in lib:
            torch.autograd.grad(out, (qt, kt, vt), ct, retain_graph=True)

    t = {key: graph_ms(fn) / n for key, fn in (
        ("fwd", run_fwd), ("dq", run_dq), ("dkv", run_dkv), ("plain_fwd", run_plain_fwd),
        ("plain_bwd", run_plain_bwd), ("lib_fwd", run_lib_fwd), ("fwd_repeat", run_fwd))}
    # autograd's backward does not capture into a CUDA graph here (it runs on
    # the engine's own thread), so the library backward is timed eagerly, by
    # CUDA events: its host cost (a few us per layer) stays in its time
    t["lib_bwd"] = time_ms(run_lib_bwd) / n
    item = 2
    act = b * s * h * dh * item           # q, out, dO, dq: (B, S, H, Dh)
    kvb = b * s * kv * dh * item          # k, v, dk, dv: (B, T, KV, Dh)
    rows = b * s * h * 4                  # lse or delta, f32
    pos = b * s * 4 + s * 4
    pairs = b * h * s * s                 # every (query, key) pair is valid (non-causal)
    bounds = {
        "fwd": _bound(act * 2 + kvb * 2 + rows + pos, 4 * pairs * dh, dtype),
        "dq": _bound(act * 3 + kvb * 2 + rows * 2 + pos, 6 * pairs * dh, dtype),
        "dkv": _bound(act * 2 + kvb * 4 + rows * 2 + pos, 8 * pairs * dh, dtype),
    }
    shape = {"B": b, "S": s, "T": s, "H": h, "KV": kv, "Dh": dh, "dtype": "bfloat16",
             "causal": False, "layers": n}
    out = {
        flash_attn.FWD: {"ms": t["fwd"], "ms_repeat": t["fwd_repeat"], "plain_ms": t["plain_fwd"],
                         "library_ms": t["lib_fwd"], "shape": shape},
        flash_attn.DQ: {"ms": t["dq"], "plain_ms": t["plain_bwd"], "library_ms": t["lib_bwd"],
                        "shape": shape},
        flash_attn.DKV: {"ms": t["dkv"], "plain_ms": t["plain_bwd"], "library_ms": t["lib_bwd"],
                         "shape": shape},
    }
    for key, name in (("fwd", flash_attn.FWD), ("dq", flash_attn.DQ), ("dkv", flash_attn.DKV)):
        out[name]["bound_ms"], out[name]["bound_by"] = bounds[key]
    # the plain backward and the library backward each compute dq, dk and
    # dv together: their time stands beside both backward kernels
    out[flash_attn.DQ]["plain_and_library_cover"] = "dq, dk, dv"
    out[flash_attn.DKV]["plain_and_library_cover"] = "dq, dk, dv"
    for name in (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV):
        e = out[name]
        log(f"kernel_time: {name} per bert-base layer (B={b} S={s} bf16): ms={e['ms']:.4f} "
            f"plain_ms={e['plain_ms']:.4f} library_ms={e['library_ms']:.4f} "
            f"bound_ms={e['bound_ms']:.5f} ({e['bound_by']})")
    del layers, lib

    n_el = ADAM_SIZES[0]
    g, m, v, gm = (_randn(rng, (n_el,), torch.float32, dev) for _ in range(4))
    v = v.abs()
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    adam_ms = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr))
    adam_plain = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr,
                                                        backend="plain"))
    adam_ms_2 = graph_ms(lambda: adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr))
    bound_ms, bound_by = _bound(20 * n_el, 20 * n_el, torch.float32)
    out["adam_adapt"] = {"ms": adam_ms, "ms_repeat": adam_ms_2, "plain_ms": adam_plain,
                         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                         "shape": {"N": n_el, "dtype": "float32"}}
    log(f"kernel_time: adam_adapt at N={n_el}: ms={adam_ms:.4f} (repeat {adam_ms_2:.4f}) "
        f"plain_ms={adam_plain:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return out


#: (name, B, S, V, sliced): gemma3-1b's LM loss, logits (4, 1024, V) read
#: through the logits[:, :-1] view (R = 4,092), and a ragged shape
CE_SHAPES = [("gemma3-1b", 4, 1024, 262_144, True), ("ragged", 1, 37, 5_000, False)]
#: bert-base's embedding, gemma3-1b's embedding, a ragged size
ADAPT_SIZES = (23_440_896, 301_989_888, 1_000_003)


def _ce_inputs(rng, dev, b, s, v, sliced, dtype):
    """Logits as the LM loss hands them to weighted_ce (the (B, S - 1, V)
    view when ``sliced``), int32 targets (R,) and an f32 cotangent (R,)."""
    full = (_randn(rng, (b, s, v), torch.float32, dev) * 3).to(dtype)
    x = full[:, :-1] if sliced else full.reshape(b * s, v)
    rows = x.numel() // v
    t = torch.from_numpy(rng.integers(0, v, rows).astype(np.int32)).to(dev)
    g = _randn(rng, (rows,), torch.float32, dev)
    return x, t, g


def phase_ce_kernel_check(dev):
    """weighted_ce forward and backward against the plain versions: ce and
    lse within 1e-5 (1 + |ref|), f32 dlogits within 1e-6 + 1e-5 |ref|, and
    bf16 dlogits within half an ulp (+ the f32 tolerance) of the plain
    version in f32 on the same inputs."""
    from repro_torch.kernels import dispatch, weighted_ce as wce

    rng = np.random.default_rng(SEED + 12)
    worst = {"fwd": {}, "bwd": {}}
    for name, b, s, v, sliced in CE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, t, g = _ce_inputs(rng, dev, b, s, v, sliced, dtype)
            ce, lse = wce._fwd_cuda(x, t)
            d = wce._bwd_cuda(x, t, lse, g)
            torch.cuda.synchronize()
            x32 = x.float().reshape(-1, v)  # the same values, in f32
            ce_ref, lse_ref = wce.cross_entropy_fwd_plain(x32, t)
            for what, a, r in (("ce", ce, ce_ref), ("lse", lse, lse_ref)):
                excess = _excess(a, r, 1e-5, 1e-5)
                if not excess <= 1.0:
                    raise AssertionError(f"weighted_ce {what} vs plain at {name} {dtype}: "
                                         f"{excess:.3f} of 1e-5 (1 + |ref|)")
            key = str(dtype).replace("torch.", "")
            worst["fwd"][key] = max(worst["fwd"].get(key, 0.0),
                                    (ce - ce_ref).abs().max().item(),
                                    (lse - lse_ref).abs().max().item())
            del ce, x32
            d_ref = wce.cross_entropy_bwd_plain(x.float().reshape(-1, v), t, lse_ref, g)
            if d.dtype != dtype or d.shape != x.shape:
                raise AssertionError(f"weighted_ce backward returned {d.dtype} {tuple(d.shape)}")
            rtol = 1e-5 + (torch.finfo(dtype).eps / 2 if dtype != torch.float32 else 0.0)
            share = _excess(d.reshape(-1, v), d_ref, 1e-6, rtol)
            if not share <= 1.0:
                raise AssertionError(f"weighted_ce dlogits vs plain in f32 at {name} {dtype}: "
                                     f"{share:.3f} of 1e-6 + {rtol:.3g} |ref|")
            worst["bwd"][key] = max(worst["bwd"].get(key, 0.0),
                                    (d.reshape(-1, v).float() - d_ref).abs().max().item())
            worst["bwd"][key + "_share_of_bound"] = max(
                worst["bwd"].get(key + "_share_of_bound", 0.0), share)
            del x, d, d_ref
            torch.cuda.empty_cache()
    log(f"kernel_check: weighted_ce at {[c[:4] for c in CE_SHAPES]} f32 and bf16 logits: "
        f"forward max_abs_err {worst['fwd']}, backward {worst['bwd']}")
    dispatch.reset_launches()
    return worst


def _dev_randn(gen, n, dev):
    return torch.randn(n, generator=gen, device=dev, dtype=torch.float32)


def phase_adapt_kernel_check(dev):
    """lion_adapt and adafactor_adapt against their plain versions at
    ADAPT_SIZES: out rtol 1e-5 / atol 1e-7, sum of squares rtol 1e-4."""
    from repro_torch.kernels import adafactor_adapt, dispatch, lion_adapt

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    worst = {"lion_adapt": 0.0, "adafactor_adapt": 0.0}
    for n in ADAPT_SIZES:
        g, m, gm = (_dev_randn(gen, n, dev) * 1e-2 for _ in range(3))
        vhat = _dev_randn(gen, n, dev).square_() * 1e-4
        lr = torch.tensor(1e-3, device=dev)
        for name, fn, args, kw in (
                ("lion_adapt", lion_adapt.lion_adapt, (g, m, gm), dict(lr=lr, b1=0.9,
                                                                      delta=1e-3)),
                ("adafactor_adapt", adafactor_adapt.adafactor_adapt, (vhat, gm),
                 dict(lr=lr, eps=1e-8))):
            out, ss = fn(*args, **kw)
            ref, ref_ss = fn(*args, backend="plain", **kw)
            excess = _excess(out, ref, 1e-7, 1e-5)
            ss_rel = abs(ss.item() - ref_ss.item()) / abs(ref_ss.item())
            if not (excess <= 1.0 and ss_rel <= 1e-4):
                raise AssertionError(f"{name} vs plain at N={n}: out {excess:.3f} of the "
                                     f"tolerance, sum of squares {ss_rel:.2e} relative")
            worst[name] = max(worst[name], (out - ref).abs().max().item())
            del out, ref
        del g, m, gm, vhat
        torch.cuda.empty_cache()
    log(f"kernel_check: lion_adapt, adafactor_adapt vs plain at N in {ADAPT_SIZES}: "
        f"max_abs_err {worst} (rtol 1e-5, atol 1e-7; sum of squares rtol 1e-4)")
    dispatch.reset_launches()
    return worst


def phase_new_kernel_time(dev):
    """weighted_ce forward and backward at gemma3-1b's LM loss shape in
    the main path's dtype (f32 logits, the (4, 1023, V) view), beside the
    plain versions and ``F.cross_entropy(reduction="none")`` (forward; its
    autograd backward, timed eagerly); lion_adapt and adafactor_adapt at
    bert-base's embedding beside their plain versions (no library call)."""
    import torch.nn.functional as F

    from repro_torch.kernels import adafactor_adapt, lion_adapt, weighted_ce as wce

    rng = np.random.default_rng(SEED + 14)
    _, b, s, v, _ = CE_SHAPES[0]
    x, t, g = _ce_inputs(rng, dev, b, s, v, True, torch.float32)
    rows = t.numel()
    _, lse = wce._fwd_cuda(x, t)
    x2 = x.reshape(rows, v)  # a contiguous copy for the library call
    t64 = t.long()
    out = {}
    fwd_ms = graph_ms(lambda: wce._fwd_cuda(x, t))
    bwd_ms = graph_ms(lambda: wce._bwd_cuda(x, t, lse, g))
    plain_fwd = time_ms(lambda: wce.cross_entropy_fwd_plain(x.reshape(-1, v), t), iters=10)
    plain_bwd = time_ms(lambda: wce.cross_entropy_bwd_plain(x.reshape(-1, v), t, lse, g),
                        iters=10)
    lib_fwd = graph_ms(lambda: F.cross_entropy(x2, t64, reduction="none"))
    leaf = x2.detach().requires_grad_(True)
    lib_out = F.cross_entropy(leaf, t64, reduction="none")
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaf, g, retain_graph=True),
                      iters=10)
    del leaf, lib_out
    fwd_ms_2 = graph_ms(lambda: wce._fwd_cuda(x, t))
    bwd_ms_2 = graph_ms(lambda: wce._bwd_cuda(x, t, lse, g))
    logits_b = rows * v * 4
    shape = {"R": rows, "V": v, "dtype": "float32", "layout": f"({b}, {s - 1}, {v}) view"}
    # one exp and about three more operations per logit, in f32
    for name, ms, ms2, plain, lib, nbytes in (
            ("weighted_ce_fwd", fwd_ms, fwd_ms_2, plain_fwd, lib_fwd, logits_b + rows * 12),
            ("weighted_ce_bwd", bwd_ms, bwd_ms_2, plain_bwd, lib_bwd, 2 * logits_b + rows * 12)):
        bound_ms, bound_by = _bound(nbytes, 4 * rows * v, torch.float32)
        out[name] = {"ms": ms, "ms_repeat": ms2, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape}
        log(f"kernel_time: {name} at R={rows} V={v} f32: ms={ms:.4f} (repeat {ms2:.4f}) "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    out["weighted_ce_bwd"]["library_call"] = "autograd backward of F.cross_entropy, eager"
    del x, x2, t, t64, g, lse
    torch.cuda.empty_cache()

    n = ADAPT_SIZES[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    gg, m, gm = (_dev_randn(gen, n, dev) for _ in range(3))
    vhat = _dev_randn(gen, n, dev).square_()
    lr = torch.tensor(1e-3, device=dev)
    for name, fn, args, kw, per_el in (
            ("lion_adapt", lion_adapt.lion_adapt, (gg, m, gm), dict(lr=lr), (16, 10)),
            ("adafactor_adapt", adafactor_adapt.adafactor_adapt, (vhat, gm), dict(lr=lr),
             (12, 4))):
        ms = graph_ms(lambda: fn(*args, **kw))
        plain = graph_ms(lambda: fn(*args, backend="plain", **kw))
        ms2 = graph_ms(lambda: fn(*args, **kw))
        bound_ms, bound_by = _bound(per_el[0] * n, per_el[1] * n, torch.float32)
        out[name] = {"ms": ms, "ms_repeat": ms2, "plain_ms": plain, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "shape": {"N": n, "dtype": "float32"}}
        log(f"kernel_time: {name} at N={n}: ms={ms:.4f} (repeat {ms2:.4f}) "
            f"plain_ms={plain:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return out


# ---------------------------------------------------------------------------
# phases 7-8: training
# ---------------------------------------------------------------------------


def _wrench(cfg, seq, n_train, n_meta, seed):
    """WRENCH-analog data at the model's vocabulary (benchmarks/common.py
    wrench_task): majority-vote weak labels on train, clean meta labels."""
    from repro_torch import data

    ccfg = data.ClassificationConfig(num_classes=cfg.num_labels, vocab_size=cfg.vocab_size,
                                     seq_len=seq, seed=seed)
    train = data.make_classification_dataset(ccfg, n_train, seed=seed)
    train["y"] = data.weak_labels(train["y_true"], cfg.num_labels, num_lfs=5, lf_accuracy=0.5,
                                  seed=seed + 1)
    meta = data.make_classification_dataset(ccfg, n_meta, seed=seed + 2)
    return train, meta


def _warm_batches(train, dev, batch, unroll, seed):
    """(base_batches, meta_batch) for comparing hypergradients: the K base
    batches are row permutations of one set of sequences (noisy labels)
    and the meta batch is the same sequences with their clean labels, so
    every parameter row the meta gradient touches has warm Adam moments at
    the state the adaptation is taken at. On a row first seen in the last
    base batch the exact Adam diagonal is lr a eps / (sqrt(b) |g| + eps)^2,
    ~1/g^2: v and eps then follow the smallest such gradients, whose
    rounding differs between any two implementations (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def batches(i):
        idx = rng.integers(0, len(train["y"]), size=batch)
        perms = np.stack([idx[rng.permutation(batch)] for _ in range(unroll)])
        base = {"tokens": put(train["tokens"][perms]), "y": put(train["y"][perms])}
        meta = {"tokens": put(train["tokens"][idx]), "y": put(train["y_true"][idx])}
        return base, meta

    return batches


def _learner(model, dev, unroll, base_opt):
    """MetaWeightNet reweighting of the model's per-example loss (the
    classifier's for an encoder, the per-sequence LM loss otherwise),
    ``base_opt`` at the base level, Adam at the meta level."""
    from repro_torch import api
    from repro_torch.core import problems

    per_example = (model.classifier_per_example if model.cfg.family == "encoder"
                   else model.per_example)
    spec = problems.make_data_optimization_spec(per_example, reweight=True)
    learner = api.MetaLearner(spec, base_opt=base_opt, meta_opt="adam", meta_lr=1e-3,
                              method="sama", unroll_steps=unroll)
    learner.init(model.init(SEED), problems.init_data_optimization_lam(SEED + 1, device=dev))
    return learner


def _lm_warm_batches(cfg, dev, batch, seq, unroll, seed):
    """(base_batches, meta_batch) of LM token sequences for comparing
    hypergradients: the K base batches are row permutations of one set of
    sequences and the meta batch is that set (see _warm_batches)."""
    from repro_torch import data

    rng = np.random.default_rng(seed)
    lm_cfg = data.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq)

    def batches(i):
        toks = data.lm_batch(lm_cfg, rng, batch)["tokens"]
        perms = np.stack([rng.permutation(batch) for _ in range(unroll)])
        return ({"tokens": torch.from_numpy(toks[perms]).to(dev)},
                {"tokens": torch.from_numpy(toks).to(dev)})

    return batches


F32_TOL = {"base_loss": 1e-5, "meta_loss": 1e-5, "eps": 2e-3, "hypergrad_norm": 2e-3}


def _step_pair(learner, state, base, meta, counted=(), sign_lr=None):
    """One meta step from ``state`` through the kernels and with every
    kernel plain. Returns the plain state; per metric, (kernels, plain,
    relative difference); per theta/lam leaf set, the largest difference,
    its share of 1e-6 + 5% of the largest update, and [how many
    coordinates lie beyond that bound, how many there are, how many of
    those beyond are not a sign flip]: with ``sign_lr`` (Lion's rate) a
    flip is a difference within the bound of 2 lr (opposite signs) or lr
    (one sign 0); without it, none is. Also the kernel step's launches of
    the ``counted`` kernels and the two steps' seconds. Only theta and lam
    of the kernel step are kept while the plain step runs."""
    from repro_torch import tree
    from repro_torch.core.engine import packed_read
    from repro_torch.kernels import dispatch

    dispatch.reset_launches()
    t0 = time.perf_counter()
    got_s, got = learner.step_fn(state, base, meta)
    got = packed_read(got)
    t1 = time.perf_counter()
    launches = {n: dispatch.launches(n) for n in counted}
    got_s = {"theta": got_s.theta, "lam": got_s.lam}
    with dispatch.plain_everywhere():
        ref_s, ref = learner.step_fn(state, base, meta)
        ref = packed_read(ref)
    t2 = time.perf_counter()
    diff = {k: (got[k], ref[k], abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)) for k in F32_TOL}
    for field in ("theta", "lam"):
        d_max, share, beyond, not_flips, total = 0.0, 0.0, 0, 0, 0
        for x, y, y0 in zip(tree.tree_leaves(got_s[field]), tree.tree_leaves(getattr(ref_s, field)),
                            tree.tree_leaves(getattr(state, field))):
            d = (x - y).abs()
            bound = 1e-6 + 0.05 * (y - y0).abs().max().item()
            d_max = max(d_max, d.max().item())
            share = max(share, d.max().item() / bound)
            over = d > bound
            beyond += int(over.sum().item())
            if sign_lr is not None:
                over &= ((d - 2 * sign_lr).abs() > bound) & ((d - sign_lr).abs() > bound)
            not_flips += int(over.sum().item())
            total += x.numel()
        diff[f"{field}_max_abs_diff"], diff[f"{field}_share_of_bound"] = d_max, share
        diff[f"{field}_beyond_bound"] = [beyond, total, not_flips]
    return ref_s, diff, launches, (t1 - t0, t2 - t1)


def _held_steps(tag, learner, batches, steps, want=None, sign_lr=None):
    """``steps`` meta steps, each from one state through the kernels and
    with every kernel plain (dispatch.plain_everywhere, a context the model
    never enters); the run goes on from the plain step's state (run
    freely, two f32 trajectories part within a few meta steps: ROADMAP
    queue 3). Held: the metrics within F32_TOL; theta and lam per leaf
    within 1e-6 + 5% of the step's largest update; the kernel step's
    launches equal to ``want``. ``sign_lr`` (Lion) admits theta coordinates
    beyond the bound only where the two steps took opposite signs of a
    momentum vote c that rounding decides: each 2 lr (or lr, a sign of 0)
    apart within the bound, and at most 1e-5 of the coordinates."""
    state, rows, secs = learner.state, [], [0.0, 0.0]
    for i in range(steps):
        state, diff, launches, (tk, tp) = _step_pair(learner, state, *batches(i),
                                                     tuple(want or ()), sign_lr)
        secs[0] += tk
        secs[1] += tp
        rows.append(diff)
        if want is not None and launches != want:
            raise AssertionError(f"{tag} step {i}: launches {launches} != {want}")
        for key, rtol in F32_TOL.items():
            got, ref, _ = diff[key]
            if not abs(got - ref) <= rtol * abs(ref) + 1e-7:
                raise AssertionError(f"{tag} step {i} {key}: kernels {got!r} vs plain {ref!r}")
        for field in ("theta", "lam"):
            if diff[f"{field}_share_of_bound"] <= 1.0:
                continue
            beyond, total, not_flips = diff[f"{field}_beyond_bound"]
            flips_ok = (sign_lr is not None and field == "theta" and not_flips == 0
                        and beyond <= 1e-5 * total)
            if not flips_ok:
                raise AssertionError(
                    f"{tag} step {i} {field}: {diff[f'{field}_max_abs_diff']:.3e} is "
                    f"{diff[f'{field}_share_of_bound']:.2f} of the bound; {beyond} of {total} "
                    f"coordinates beyond it, {not_flips} of them no sign flip")
    worst = {k: max(r[k][2] for r in rows) for k in F32_TOL}
    for field in ("theta", "lam"):
        for k in (f"{field}_max_abs_diff", f"{field}_share_of_bound"):
            worst[k] = max(r[k] for r in rows)
        worst[f"{field}_beyond_bound"] = max(r[f"{field}_beyond_bound"][0] for r in rows)
    return state, {"steps": steps, "kernels_s": secs[0], "plain_s": secs[1], "per_step": rows,
                   "worst": worst}


def phase_train_f32(base_cfg, dev, batch=16, seq=128, unroll=2, steps=3):
    """bert-base in f32: _held_steps on WRENCH-analog data with warm rows.

    The checked run's base Adam takes eps = 1e-3, which bounds the
    adaptation diagonal by lr / eps. With the paper's 1e-8, the coordinates
    whose gradient is at rounding level (diagonal ~1e5) make up v, so eps,
    the hypergradient and the nudged theta follow rounding in any two
    implementations; one more step at 1e-8 is measured and reported here,
    not held to a tolerance."""
    from repro_torch import optim
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 20)
    batches = _warm_batches(train, dev, batch, unroll, SEED + 21)
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    _, out = _held_steps("train f32", learner, batches, steps)
    del learner
    learner_8 = _learner(model, dev, unroll, optim.adam(1e-3))
    _, diff_8, _, _ = _step_pair(learner_8, learner_8.state, *batches(0))
    out.update({"batch": batch, "seq": seq, "unroll": unroll, "base_adam_eps": 1e-3,
                "base_adam_eps_1e-8_one_step_not_held": diff_8})
    log("train_f32: " + json.dumps(out))
    return out


def phase_train_gemma_f32(base_cfg, dev, batch=2, seq=1024, unroll=2, steps=3):
    """gemma3-1b at full width and depth in f32, the per-sequence LM loss
    (weighted_ce over 262,144 tokens), batch 2, seq 1024 (the 512-token
    window masks): _held_steps with base Adam eps 1e-3 on warm rows, and one
    step at eps 1e-8 reported, not held (as phase_train_f32)."""
    from repro_torch import optim, tree
    from repro_torch.kernels import flash_attn, weighted_ce as wce
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    batches = _lm_warm_batches(cfg, dev, batch, seq, unroll, SEED + 40)
    learner = _learner(model, dev, unroll, optim.adam(1e-3, eps=1e-3))
    L, K = cfg.num_layers, unroll
    want = {wce.FWD: K + 3, wce.BWD: K + 1, flash_attn.FWD: L * (K + 3) + L * (K + 1),
            flash_attn.DQ: L * (K + 1), flash_attn.DKV: L * (K + 1),
            "adam_adapt": len(tree.tree_leaves(learner.state.theta))}
    _, out = _held_steps("train gemma f32", learner, batches, steps, want)
    del learner
    torch.cuda.empty_cache()
    learner_8 = _learner(model, dev, unroll, optim.adam(1e-3))
    _, diff_8, _, _ = _step_pair(learner_8, learner_8.state, *batches(0))
    del learner_8
    torch.cuda.empty_cache()
    out.update({"batch": batch, "seq": seq, "unroll": unroll, "base_adam_eps": 1e-3,
                "launches_per_step": want, "base_adam_eps_1e-8_one_step_not_held": diff_8})
    log("train_gemma_f32: " + json.dumps(out))
    return out


def phase_train_lion_adafactor(base_cfg, dev, batch=16, seq=128, unroll=2, steps=3):
    """bert-base in f32 with Lion (lr 1e-4) and Adafactor (lr 1e-3, eps
    1e-3: its diagonal lr / (sqrt(vhat) + eps) has Adam's rounding-level
    coordinates at 1e-8) at the base level: _held_steps, each kernel step
    launching one lion_adapt or adafactor_adapt per theta leaf."""
    from repro_torch import optim, tree
    from repro_torch.kernels import flash_attn
    from repro_torch.models import Model

    cfg = base_cfg.replace(dtype="float32")
    model = Model(cfg, device=dev)
    train, _ = _wrench(cfg, seq, 256, 16, SEED + 50)
    out = {}
    L, K = cfg.num_layers, unroll
    for name, opt, sign_lr in (("lion", optim.lion(1e-4), 1e-4),
                               ("adafactor", optim.adafactor(1e-3, eps=1e-3), None)):
        batches = _warm_batches(train, dev, batch, unroll, SEED + 51)
        learner = _learner(model, dev, unroll, opt)
        leaves = len(tree.tree_leaves(learner.state.theta))
        want = {f"{name}_adapt": leaves, flash_attn.FWD: L * (K + 3) + L * (K + 1),
                flash_attn.DQ: L * (K + 1), flash_attn.DKV: L * (K + 1)}
        _, res = _held_steps(f"train {name}", learner, batches, steps, want, sign_lr)
        res["launches_per_step"] = want
        out[name] = res
        del learner
        torch.cuda.empty_cache()
    log("train_lion_adafactor: " + json.dumps(out))
    return out


PHASES = ("base_unroll", "local_terms", "meta_pass", "cd_passes", "finalize", "meta_update")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_time_by_phase(trace_path):
    """Device time of a profiled step from its chrome trace: each kernel,
    copy or fill is charged to the innermost engine phase (a
    record_function range on the host) that holds the host call that
    launched it, matched by the trace's correlation ids. Returns (ms by
    phase, [(kernel name, (us, count))] by time, total device ms)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") in PHASES]
    by_phase = {name: 0.0 for name in PHASES + ("outside the phases",)}
    by_kernel = {}
    total = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        total += e["dur"]
        us, count = by_kernel.get(e["name"], (0.0, 0))
        by_kernel[e["name"]] = (us + e["dur"], count + 1)
        ts = launched.get(e.get("args", {}).get("correlation"))
        inner = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "outside the phases"
        by_phase[name] += e["dur"]
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    return {k: v / 1e3 for k, v in by_phase.items()}, kernels, total / 1e3


def _timed_fit(tag, learner, it, steps, want_per_step, out_dir, trace_name, per_step):
    """One warm step, then ``steps`` meta steps through ``MetaLearner.fit``
    (metrics read every step: a sync each) with the launches of the
    kernels in ``want_per_step`` counted from 0 and held to steps x the
    count; step wall times, ``per_step`` units (samples, tokens) per
    second, peak memory; then one more step under torch.profiler (its
    launches outside the count): device time by phase and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import packed_read
    from repro_torch.kernels import dispatch

    packed_read(learner.step(*next(it)))  # warm: cuBLAS handles, kernel libraries
    stamps = []

    def timed():
        while True:
            stamps.append(time.perf_counter())
            yield next(it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()  # counts of the main path's run only
    history = learner.fit(timed(), steps=steps, log_every=1)
    stamps.append(time.perf_counter())
    launches = {n: dispatch.launches(n) for n in want_per_step}
    peak = torch.cuda.max_memory_allocated()
    walls = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    want = {n: steps * w for n, w in want_per_step.items()}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches} != {want}")
    for row in history:
        if not all(math.isfinite(row[k]) for k in ("base_loss", "meta_loss", "hypergrad_norm")):
            raise AssertionError(f"{tag}: non-finite metrics {row}")
    step_ms = float(np.median(walls))
    result = {"steps": steps, "step_ms_median": step_ms, "step_ms_min": min(walls),
              "step_ms_max": max(walls), "step_ms_all": walls,
              **{f"{unit}_per_s": n / step_ms * 1e3 for unit, n in per_step.items()},
              "max_memory_allocated": peak, "launches": launches,
              "launches_per_step": want_per_step,
              "first_and_last_metrics": [history[0], history[-1]]}
    log(f"{tag}: " + json.dumps(result))

    base_b, meta_b = next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        packed_read(learner.step(base_b, meta_b))
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"{trace_name}_trace.json")
    prof.export_chrome_trace(trace_path)
    phases, kernels, device_ms = _device_time_by_phase(trace_path)
    with open(os.path.join(out_dir, f"{trace_name}_kernels.txt"), "w") as f:
        for key, (us, count) in kernels:
            f.write(f"{us:12.1f} us  {count:5d}x  {key}\n")
    prof_out = {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / step_ms,
                "device_busy_share_of_profiled_step": device_ms / wall_ms,
                "kernel_launches": sum(c for _, (_, c) in kernels),
                "device_ms_by_phase": phases,
                "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                        for k, (us, c) in kernels[:15]]}
    log(f"{tag}_step_profile: " + json.dumps(prof_out))
    result["step_profile"] = prof_out
    return result


def _train_launches(cfg, unroll, leaves):
    """Per meta step: L(K+3) flash forwards + L(K+1) remat recomputes, L(K+1)
    dq and dk/dv, one adam_adapt per theta leaf."""
    from repro_torch.kernels import flash_attn

    L, K = cfg.num_layers, unroll
    return {flash_attn.FWD: L * (K + 3) + L * (K + 1), flash_attn.DQ: L * (K + 1),
            flash_attn.DKV: L * (K + 1), "adam_adapt": leaves}


def phase_train_bf16(cfg, dev, out_dir, batch=48, seq=128, unroll=2, steps=10):
    """bert-base in its own dtype on WRENCH-analog data."""
    from repro_torch import data, optim, tree
    from repro_torch.models import Model

    model = Model(cfg, device=dev)
    train, meta = _wrench(cfg, seq, 1024, 256, SEED + 30)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    it = data.BatchIterator(train, meta, batch_size=batch, meta_batch_size=batch,
                            unroll=unroll, seed=SEED + 31, device=dev)
    want = _train_launches(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))
    result = _timed_fit("train_bf16", learner, it, steps, want, out_dir, "train_step",
                        {"samples": batch * unroll})
    result.update({"batch": batch, "seq": seq, "unroll": unroll})
    return result


def phase_train_gemma_bf16(cfg, dev, out_dir, batch=4, seq=1024, unroll=2, steps=10):
    """gemma3-1b in its own dtypes (f32 parameters, bf16 activations): two
    steps of the train CLI at its default arch (its JSON lines finite),
    then ``steps`` meta steps at batch 4, seq 1024, unroll 2, meta batch 2
    (the CLI's batch // 2) on the CLI's LM stream. Tokens and samples per
    second count the base batches (K x B sequences of S tokens)."""
    import contextlib
    import io

    from repro_torch import optim, tree
    from repro_torch.kernels import weighted_ce as wce
    from repro_torch.launch import train
    from repro_torch.models import Model

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(["--steps", "2", "--log-every", "1"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    if [r.get("step") for r in rows] != [0, 1] or not all(
            math.isfinite(r[k]) for r in rows for k in ("base_loss", "meta_loss",
                                                        "hypergrad_norm", "eps")):
        raise AssertionError(f"train CLI (default arch): {rows}")
    log(f"train_cli: default arch {cfg.name}, {time.perf_counter() - t0:.1f}s: "
        + json.dumps(rows))
    torch.cuda.empty_cache()

    model = Model(cfg, device=dev)
    learner = _learner(model, dev, unroll, optim.adam(1e-3))
    make_batch = train.make_batch_fn(cfg, seq, dev, np.random.default_rng(SEED + 60))

    def it():
        while True:
            yield make_batch(batch, unroll), make_batch(max(batch // 2, 1))

    want = {wce.FWD: unroll + 3, wce.BWD: unroll + 1,
            **_train_launches(cfg, unroll, len(tree.tree_leaves(learner.state.theta)))}
    result = _timed_fit("train_gemma_bf16", learner, it(), steps, want, out_dir,
                        "train_gemma_step",
                        {"samples": batch * unroll, "tokens": batch * unroll * seq})
    result.update({"batch": batch, "seq": seq, "unroll": unroll,
                   "meta_batch": max(batch // 2, 1), "cli_rows": rows})
    return result


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the profiler traces of a decode and two training steps")
    args = ap.parse_args()

    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        secs[name] = time.perf_counter() - t0
        log(f"phase {name}: {secs[name]:.1f}s")
        return out

    phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import configs
    from repro_torch.kernels import flash_attn, weighted_ce as wce
    from repro_torch.models import Model
    from repro_torch.models.common import tree_flatten

    dev = torch.device("cuda", 0)
    cfg = configs.get_config("gemma3-1b")
    bert = configs.get_config("bert-base")
    build_s = timed("build", phase_build)

    # phase 3: the decode kernel
    entry = {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_attn.py:490",
             "build_seconds": build_s["flash_decode"]}
    worst, worst_vs_f32 = timed("decode_kernel_check", phase_kernel_check, dev)
    timing = timed("decode_kernel_time", phase_kernel_time, dev, cfg, slots=4, t=1024)
    # "max_abs_err" and "ms" are the keys every kernels line carries; they
    # are the bf16 error and the kernel time, which the serving path's own
    # names max_err_bf16 and kernel_ms repeat
    entry.update({"max_abs_err": worst[torch.bfloat16], "max_err_f32": worst[torch.float32],
                  "max_err_bf16": worst[torch.bfloat16],
                  "bf16_vs_f32_share_of_bound": worst_vs_f32,
                  "kernel_ms": timing["ms"], **timing})

    # phase 4: the training kernels
    t_worst, t_share, adam_worst = timed("train_kernel_check", phase_train_kernel_check, dev)
    ce_worst = timed("ce_kernel_check", phase_ce_kernel_check, dev)
    adapt_worst = timed("adapt_kernel_check", phase_adapt_kernel_check, dev)
    t_time = timed("train_kernel_time", phase_train_kernel_time, dev, bert, batch=48, seq=128)
    t_time.update(timed("new_kernel_time", phase_new_kernel_time, dev))
    train_entries = []
    for name, source, replaces in (
            (flash_attn.FWD, "flash_attn_fwd", "src/repro/kernels/flash_attn.py:118"),
            (flash_attn.DQ, "flash_attn_bwd", "src/repro/kernels/flash_attn.py:253"),
            (flash_attn.DKV, "flash_attn_bwd", "src/repro/kernels/flash_attn.py:282"),
            ("adam_adapt", "adam_adapt", "src/repro/kernels/adam_adapt.py:30"),
            (wce.FWD, "weighted_ce", "src/repro/kernels/weighted_ce.py:28"),
            (wce.BWD, "weighted_ce", "src/repro/kernels/weighted_ce.py:60"),
            ("lion_adapt", "lion_adapt", "src/repro/kernels/lion_adapt.py:28"),
            ("adafactor_adapt", "adafactor_adapt", "src/repro/kernels/adafactor_adapt.py:26")):
        e = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{source}.cu", "replaces": replaces,
             "build_seconds": build_s[source]}
        if name == "adam_adapt":
            e["max_abs_err"] = adam_worst
        elif name in adapt_worst:
            e["max_abs_err"] = adapt_worst[name]
        elif name in (wce.FWD, wce.BWD):
            w = ce_worst["fwd" if name == wce.FWD else "bwd"]
            e.update({"max_abs_err": max(w["float32"], w["bfloat16"]),
                      "max_err_f32": w["float32"], "max_err_bf16_logits": w["bfloat16"]})
            if name == wce.BWD:
                e["bf16_vs_f32_share_of_bound"] = w["bfloat16_share_of_bound"]
        else:
            e.update({"max_abs_err": t_worst[name][torch.bfloat16],
                      "max_err_f32": t_worst[name][torch.float32],
                      "max_err_bf16": t_worst[name][torch.bfloat16],
                      "bf16_vs_f32_share_of_bound": t_share[name]})
        e.update(t_time[name])
        train_entries.append(e)
    by_name = {e["name"]: e for e in train_entries}

    # phases 5-6: serving
    t0 = time.perf_counter()
    params = Model(cfg, device=dev).init(SEED)
    torch.cuda.synchronize()
    log(f"init: gemma3-1b {sum(x.numel() for x in tree_flatten(params)[0])} params f32 "
        f"in {time.perf_counter() - t0:.2f}s")
    timed("serve_f32", phase_serve_f32, cfg, params, dev)
    serve_out, launches = timed("serve_bf16", phase_serve_bf16, cfg, params, dev, args.out)
    entry["launches"] = launches
    entry["serve_bf16"] = serve_out
    del params
    torch.cuda.empty_cache()

    # phases 7-8: training bert-base
    timed("train_f32", phase_train_f32, bert, dev)
    torch.cuda.empty_cache()
    bert_out = timed("train_bf16", phase_train_bf16, bert, dev, args.out)
    torch.cuda.empty_cache()

    # phases 9-11: training gemma3-1b, and Lion and Adafactor bases
    timed("train_gemma_f32", phase_train_gemma_f32, cfg, dev)
    torch.cuda.empty_cache()
    gemma_out = timed("train_gemma_bf16", phase_train_gemma_bf16, cfg, dev, args.out)
    torch.cuda.empty_cache()
    la_out = timed("train_lion_adafactor", phase_train_lion_adafactor, bert, dev)

    # launches: each kernel's count from this slice's main path (the gemma3-1b
    # bf16 run) where it runs there, else from the run that drives it (the
    # Lion and Adafactor kernel steps); the bert-base run's counts beside them
    for name, e in by_name.items():
        if name in gemma_out["launches"]:
            e["launches"] = gemma_out["launches"][name]
            e["launches_path"] = "train_gemma_bf16 (10 meta steps)"
        else:
            base = name.replace("_adapt", "")
            e["launches"] = la_out[base]["launches_per_step"][name] * la_out[base]["steps"]
            e["launches_path"] = f"train_lion_adafactor {base} (kernel steps)"
        if name in bert_out["launches"]:
            e["launches_train_bf16_bert"] = bert_out["launches"][name]
        if not e["launches"] >= 1:
            raise AssertionError(f"{name}: no launch on its path")
    log(f"phase_seconds: {json.dumps(secs)} total {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": [entry] + train_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
