"""Serving CLI of the port, a thin layer over ``repro_torch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        [--device cuda] [--serial] [--smoke]

Submits a mixed-length request set to the continuous-batching executor
and prints one JSON line with per-request latency (p50/p99), TTFT, TPOT,
sustained QPS, statuses and paged-cache memory: the keys of
``repro.launch.serve``'s payload. ``--serial`` runs the same requests
through the serial dense-cache ``greedy_generate`` reference loop. The
weights and the prompts are random, from ``--seed``. It runs on the card
unless ``--device cpu`` is given. As in the reference, serving reads no
audio or image: a whisper or llama-3.2-vision request cross-attends to the
cache's zero ``cross_kv``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs, serve
from repro_torch.models import Model
from repro_torch.perf import LatencyStats


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int = 0):
    """Mixed-length prompts around ``prompt_len``."""

    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, prompt_len // 2), prompt_len + 1, size=n)
    return [rng.integers(0, cfg.vocab_size, size=(int(L),)).astype(np.int64)
            for L in lens], [gen] * n


def run_continuous(model, params, prompts, gens, scfg: serve.ServeConfig):
    ex = serve.ServeExecutor(model, params, scfg)
    ids = [ex.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    stats = ex.run()
    return ex, ids, stats


def run_serial(model, params, prompts, gens, max_len: int):
    """The requests one at a time through ``greedy_generate``; returns the
    tokens and the per-request wall times (each ends in a device sync)."""

    outs, lat = [], []
    for p, g in zip(prompts, gens):
        t0 = time.perf_counter()
        toks = serve.greedy_generate(model, params, torch.as_tensor(p)[None], g, max_len)
        outs.append([int(t) for t in toks[0].cpu()])
        lat.append(time.perf_counter() - t0)
    return outs, lat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request token cap (0 = prompt+gen rounded to a "
                         "page multiple)")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline (shed on miss)")
    ap.add_argument("--serial", action="store_true",
                    help="serial dense-cache reference loop instead of "
                         "continuous batching")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    prompts, gens = make_requests(cfg, args.requests, args.prompt_len,
                                  args.gen, args.seed)
    pg = args.page_size
    max_len = args.max_len or pg * ((args.prompt_len + args.gen + pg - 1) // pg)

    if args.serial:
        t0 = time.perf_counter()
        outs, lat = run_serial(model, params, prompts, gens, max_len)
        elapsed = time.perf_counter() - t0
        payload = {
            "mode": "serial", "arch": cfg.name, "requests": args.requests,
            "qps": round(args.requests / elapsed, 2),
            "latency_us": LatencyStats.from_samples(lat).as_dict(),
            "sample": outs[0],
        }
    else:
        scfg = serve.ServeConfig(
            slots=args.slots, page_size=pg, max_len=max_len,
            max_new_tokens=args.gen, default_timeout_s=args.timeout_s)
        ex, ids, stats = run_continuous(model, params, prompts, gens, scfg)
        payload = {
            "mode": "continuous", "arch": cfg.name, "requests": args.requests,
            "statuses": {s: sum(ex.results[i].status == s for i in ids)
                         for s in set(ex.results[i].status for i in ids)},
            "qps": round(stats.qps, 2),
            "latency_us": stats.latency.as_dict(),
            "ttft_us": stats.ttft.as_dict(),
            "tpot_us": stats.tpot.as_dict(),
            "queue_wait_us": stats.queue_wait.as_dict(),
            "lanes": stats.lanes,
            "decode_steps": stats.steps,
            "memory": stats.memory,
            "sample": ex.results[ids[0]].tokens,
        }
    payload["device"] = str(model.device)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
