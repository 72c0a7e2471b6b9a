"""The kernel layer against the naive chains it replaces, the port's twin
of ``benchmarks/bench_kernels.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_kernels [--device cpu] \
        [--full] [--out DIR]

Two probes, each a measured PerfRecord per route (``perf.profile_step``:
one warm-up call, three timed, as the JAX bench), after the fused result
is held against the naive one:

* ``adam_adapt``: the fused SAMA adaptation product and its sum of
  squares (``kernels.ops.adam_adapt_product``) against the naive path: the
  adaptation diagonal as its own chain of operations, a multiply, and a
  separate global-norm pass; n = 64 Ki (``--full``: 4 Mi);
* ``weighted_ce``: the CE forward and the gradient of its weighted sum
  through the registered kernel against a materialised log-softmax;
  (rows, vocab) = (32, 8,192) (``--full``: (256, 65,536)).

One record per route: ``plain`` everywhere (the plain version, through the
wrapper's ``backend="plain"``), ``cuda`` on the card (the registry, which
launches the kernel). Writes ``BENCH_torch_kernels.json``.
"""

from __future__ import annotations

import torch

from repro_torch.perf.common import Bench, cli

#: the fused result against the naive chain's (f32), before any record
ATOL, RTOL = 1e-5, 1e-5


def _routes(device: torch.device):
    return ("plain", "cuda") if device.type == "cuda" else ("plain",)


def _emit(bench: Bench, rec) -> None:
    bench.emit_record(rec)
    bench.emit(rec.name, rec.us_per_step["median_us"], f"samples_per_s={rec.samples_per_s:.1f}")


def _close(what: str, got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{what}: fused and naive differ by {err:.3e}")
    return err


def _bench_adam_adapt(bench: Bench, n: int, device: torch.device):
    from repro_torch import optim, perf
    from repro_torch.kernels import adam_adapt, ops

    gen = torch.Generator(device=device).manual_seed(0)
    opt = optim.adam(0.3)
    params = {"w": torch.zeros(n, device=device)}
    state = opt.init(params)
    _, state = opt.update({"w": torch.randn(n, generator=gen, device=device)}, state, params)
    g = torch.randn(n, generator=gen, device=device)
    gm = torch.randn(n, generator=gen, device=device)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.3

    def naive(g, gm, state):
        # the adaptation diagonal as its own chain of operations, the
        # product, and a separate global-norm pass
        t = (state.count + 1).to(g.dtype)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        m1 = b1 * state.mu["w"] + (1.0 - b1) * g
        v1 = b2 * state.nu["w"] + (1.0 - b2) * g * g
        mhat, vhat = m1 / bc1, v1 / bc2
        denom = torch.sqrt(vhat) + eps
        a, b = (1.0 - b1) / bc1, (1.0 - b2) / bc2
        safe = torch.clamp_min(torch.sqrt(vhat), 1e-15)
        diag = lr * (a / denom - mhat * b * g / (safe * denom * denom))
        v = diag * gm
        return v, torch.sqrt(torch.sum(v * v))

    def fused_fn(route):
        def fused(g, gm, state):
            kw = dict(t=state.count + 1, b1=b1, b2=b2, eps=eps, lr=lr)
            if route == "plain":
                out, sumsq = adam_adapt.adam_adapt(g, state.mu["w"], state.nu["w"], gm,
                                                   backend="plain", **kw)
            else:
                out, sumsq = ops.adam_adapt_product(g, state.mu["w"], state.nu["w"], gm, **kw)
            return out, torch.sqrt(sumsq)
        return fused

    want = naive(g, gm, state)
    for route in _routes(device):
        got = fused_fn(route)(g, gm, state)
        _close(f"adam_adapt {route} out", got[0], want[0])
        _close(f"adam_adapt {route} norm", got[1], want[1])
    _emit(bench, perf.profile_step(f"adam_adapt_naive_n{n}", naive, g, gm, state,
                                   samples_per_step=n, warmup=1, repeats=3,
                                   extra={"n": n, "variant": "naive"}))
    for route in _routes(device):
        _emit(bench, perf.profile_step(
            f"adam_adapt_fused_{route}_n{n}", fused_fn(route), g, gm, state,
            samples_per_step=n, warmup=1, repeats=3,
            extra={"n": n, "variant": "fused", "backend": route}))


def _bench_weighted_ce(bench: Bench, rows: int, vocab: int, device: torch.device):
    from repro_torch import perf
    from repro_torch.kernels import ops, weighted_ce

    gen = torch.Generator(device=device).manual_seed(0)
    logits = torch.randn(rows, vocab, generator=gen, device=device) * 2
    targets = torch.randint(0, vocab, (rows,), generator=gen, device=device)
    w = torch.rand(rows, generator=gen, device=device)

    def naive(logits, targets, w):
        x = logits.detach().requires_grad_(True)
        logp = torch.log_softmax(x, dim=-1)
        ce = -torch.gather(logp, -1, targets[:, None])[:, 0]
        (grad,) = torch.autograd.grad(torch.sum(ce * w), x)
        return grad, ce.detach()

    def fused_fn(route):
        def fused(logits, targets, w):
            x = logits.detach().requires_grad_(True)
            ce = (weighted_ce.cross_entropy(x, targets, backend="plain") if route == "plain"
                  else ops.cross_entropy(x, targets))
            (grad,) = torch.autograd.grad(torch.sum(ce * w), x)
            return grad, ce.detach()
        return fused

    want = naive(logits, targets, w)
    for route in _routes(device):
        got = fused_fn(route)(logits, targets, w)
        _close(f"weighted_ce {route} dlogits", got[0], want[0])
        _close(f"weighted_ce {route} ce", got[1], want[1])
    _emit(bench, perf.profile_step(f"weighted_ce_naive_r{rows}_v{vocab}", naive, logits,
                                   targets, w, samples_per_step=rows, warmup=1, repeats=3,
                                   extra={"rows": rows, "vocab": vocab, "variant": "naive"}))
    for route in _routes(device):
        _emit(bench, perf.profile_step(
            f"weighted_ce_fused_{route}_r{rows}_v{vocab}", fused_fn(route), logits, targets,
            w, samples_per_step=rows, warmup=1, repeats=3,
            extra={"rows": rows, "vocab": vocab, "variant": "fused", "backend": route}))


def run(*, fast: bool = True, device="cuda") -> Bench:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    bench = Bench("kernels")
    n = 64 * 1024 if fast else 4 * 1024 * 1024
    _bench_adam_adapt(bench, n, dev)
    rows, vocab = (32, 8192) if fast else (256, 65536)
    _bench_weighted_ce(bench, rows, vocab, dev)
    bench.notes.update({"routes": list(_routes(dev)),
                        "asserts": [f"fused vs naive within atol {ATOL}, rtol {RTOL} on every "
                                    "output, per route, before any record"]})
    return bench


def main(argv=None):
    return cli("kernels", run, argv)


if __name__ == "__main__":
    main()
