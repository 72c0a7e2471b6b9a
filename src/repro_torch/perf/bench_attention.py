"""The attention kernels' bench, the port's twin of
``benchmarks/bench_attention.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_attention [--device cpu] \
        [--full] [--out DIR]

Parity is asserted before any number is recorded, as in the reference:

1. the kernels against their plain versions on a GQA shape (B 2, S 13,
   H 4, KV 2, Dh 64, softcap 30, a window of 5, f32): the forward within
   1e-5 and the q, k, v cotangents within 5e-5 (max abs) of autograd
   through the plain forward. On the card that is the CUDA kernels; on the
   CPU, the plain versions of their two passes
   (``flash_attn.flash_attention_plain_vjp``: the recompute backward from
   the saved lse). The split-KV decode at T 37 over lanes at positions 36,
   10 and 0, with 1, 3 and 5 splits, within 1e-5 of the single-pass
   softmax (``flash_decode_plain``): on the card the decode kernel's
   cluster splits, on the CPU the same splits (``decode_shares``) merged by
   ``merge_partials``;
2. the dispatched SAMA step (mini-BERT, batch 16, unroll 2) against the
   same step under ``dispatch.plain_everywhere``: metrics within 1e-4,
   hypergrad_norm within 1e-2, the post-step state within 5e-3 (the
   reference's bounds for its interpreted kernels against ``ref``; both
   steps are the plain one on the CPU). The held pair's base Adam takes
   eps 1e-3, as ``chip_smoke.py``'s phase 7 holds its f32 steps: at the
   paper's 1e-8 the adaptation diagonal reaches lr / eps on coordinates
   whose gradient is at rounding level, those make up v, and eps, the
   hypergradient and the nudged theta follow rounding in any two
   implementations (the reference's interpreted kernel and ``ref`` share
   XLA's arithmetic). The pair at 1e-8, the reference's own problem, is
   measured and recorded beside, not held;
3. then the records, one per route (``plain`` everywhere, ``cuda`` on the
   card): the training forward and backward (B 8, S 128, H 4, KV 2, Dh 64,
   softcap 30) and the split-KV decode (B 16, T 512), one warm-up and three
   timed calls (``--full``: two and five), and the SAMA step's attribution
   (``obs.profile``) with attention.py's FLOP share.

Writes ``BENCH_torch_attention.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.perf.common import Bench, cli

BATCH, UNROLL = 16, 2
PARITY_TOL = 1e-5
GRAD_TOL = 5e-5
#: the step's bounds (benchmarks/bench_attention.py)
STEP_METRICS_TOL, STEP_HYPERGRAD_TOL, STEP_STATE_TOL = 1e-4, 1e-2, 5e-3


def _routes(device: torch.device):
    return ("plain", "cuda") if device.type == "cuda" else ("plain",)


def _t(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _split_decode_plain(q, k, v, pos, *, softcap, n_splits):
    """The split-KV decode in plain operations: each lane's visible rows
    split by ``decode_shares``, each split's normalised output and lse, the
    splits merged by ``merge_partials``: the decode kernel's algorithm."""
    from repro_torch.kernels import flash_attn

    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, kv, g, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) / dh ** 0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    outs, lses = [], []
    for rank in range(n_splits):
        keep = torch.zeros(b, t, dtype=torch.bool, device=q.device)
        for lane in range(b):
            beg, end = flash_attn.decode_shares(int(pos[lane, 0]), t, 0, n_splits)[rank]
            keep[lane, beg:end] = True
        s = torch.where(keep[:, None, None, :], scores, torch.full_like(scores, flash_attn.NEG))
        lse = torch.logsumexp(s, dim=-1)
        empty = ~keep.any(-1)
        p = torch.exp(s - lse[..., None]) * keep[:, None, None, :]
        o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
        lses.append(torch.where(empty[:, None, None], torch.full_like(lse, flash_attn.NEG), lse))
        outs.append(o)
    o = torch.stack(outs, dim=2)      # (b, kv, splits, g, dh)
    lse = torch.stack(lses, dim=2)    # (b, kv, splits, g)
    return flash_attn.merge_partials(o, lse).reshape(b, 1, h, dh).to(q.dtype)


def _assert_kernel_parity(device):
    from repro_torch.kernels import flash_attn

    B, S, H, KV, Dh = 2, 13, 4, 2, 64
    rng = np.random.default_rng(9)
    q = _t(rng.standard_normal((B, S, H, Dh)), device)
    k = _t(rng.standard_normal((B, S, KV, Dh)), device)
    v = _t(rng.standard_normal((B, S, KV, Dh)), device)
    q_pos = torch.arange(S, device=device, dtype=torch.int32)[None].expand(B, S).contiguous()
    kv_pos = torch.arange(S, device=device, dtype=torch.int32)
    kw = dict(softcap=30.0, window=5, causal=True)
    cot = _t(rng.standard_normal(q.shape), device)

    def vjp(backend):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = flash_attn.flash_attention(qq, kk, vv, q_pos, kv_pos, True, backend=backend, **kw)
        grads = torch.autograd.grad(torch.sum(out * cot), (qq, kk, vv))
        return out.detach(), grads

    ref_out, ref_grads = vjp("plain")
    if device.type == "cuda":
        got_out, got_grads = vjp(None)
    else:
        got_out, *got_grads = flash_attn.flash_attention_plain_vjp(
            q, k, v, q_pos, kv_pos, cot, softcap=30.0, window=5, causal=True)
    err = _max_err(got_out, ref_out)
    if err > PARITY_TOL:
        raise AssertionError(f"flash forward diverged from the plain version: {err:.2e}")
    gerr = max(_max_err(a, b) for a, b in zip(got_grads, ref_grads))
    if gerr > GRAD_TOL:
        raise AssertionError(f"flash backward diverged from the plain version: {gerr:.2e}")

    T = 37
    qd = _t(rng.standard_normal((3, 1, H, Dh)), device)
    kd = _t(rng.standard_normal((3, T, KV, Dh)), device)
    vd = _t(rng.standard_normal((3, T, KV, Dh)), device)
    pos = torch.tensor([[36], [10], [0]], dtype=torch.int32, device=device)
    dref = flash_attn.flash_decode_plain(qd, kd, vd, pos, softcap=30.0)
    derr = 0.0
    for ns in (1, 3, 5):
        if device.type == "cuda":
            dgot = flash_attn.flash_decode(qd, kd, vd, pos, softcap=30.0, n_splits=ns)
        else:
            dgot = _split_decode_plain(qd, kd, vd, pos, softcap=30.0, n_splits=ns)
        e = _max_err(dgot, dref)
        if e > PARITY_TOL:
            raise AssertionError(f"split-KV decode (n_splits={ns}) diverged: {e:.2e}")
        derr = max(derr, e)
    return err, gerr, derr


def _problem(device, base_eps=1e-8):
    from repro_torch import data, optim
    from repro_torch.core import EngineConfig, init_state, make_meta_step, problems
    from repro_torch.perf.common import mini_bert, wrench_task

    ccfg, train, meta, _ = wrench_task(seed=9)
    model = mini_bert(num_labels=ccfg.num_classes, d_model=128, device=device)
    spec = problems.make_data_optimization_spec(model.classifier_per_example, reweight=True)
    lam = problems.init_data_optimization_lam(1, reweight=True, device=device)
    it = data.BatchIterator(train, meta, batch_size=BATCH, meta_batch_size=BATCH,
                            unroll=UNROLL, seed=0, device=device)
    base_b, meta_b = next(it)
    base_opt, meta_opt = optim.adam(1e-3, eps=base_eps), optim.adam(1e-3)
    cfg = EngineConfig(method="sama", unroll_steps=UNROLL)
    state = init_state(model.init(0), lam, base_opt, meta_opt, scale=cfg.scale)
    return make_meta_step(spec, base_opt, meta_opt, cfg), state, base_b, meta_b


def _max_leaf_diff(a, b) -> float:
    from repro_torch import tree as tu

    diffs = [_max_err(x, y) for x, y in zip(tu.flatten_with_keys(a)[1],
                                            tu.flatten_with_keys(b)[1])
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    return max(diffs or [0.0])


def _step_diffs(step, state, bb, mb):
    """(metrics, hypergrad_norm, state) max abs differences of the
    dispatched step against the same step under ``plain_everywhere``."""
    from repro_torch.kernels import dispatch

    got_state, got = step(state, bb, mb)
    with dispatch.plain_everywhere():
        ref_state, ref = step(state, bb, mb)
    got, ref = dict(got), dict(ref)
    dh = _max_err(got.pop("hypergrad_norm"), ref.pop("hypergrad_norm"))
    dm = max(_max_err(got[k], ref[k]) for k in got)
    return dm, dh, _max_leaf_diff(got_state, ref_state)


def _assert_step_parity(device, step, state, bb, mb):
    dm, dh, ds = _step_diffs(*_problem(device, base_eps=1e-3))
    if dm > STEP_METRICS_TOL or dh > STEP_HYPERGRAD_TOL or ds > STEP_STATE_TOL:
        raise AssertionError(f"dispatched vs plain SAMA step diverged: metrics {dm:.2e}, "
                             f"hypergrad_norm {dh:.2e}, state {ds:.2e}")
    dm8, dh8, ds8 = _step_diffs(step, state, bb, mb)
    return {"dispatched_vs_plain_metrics": dm, "dispatched_vs_plain_hypergrad": dh,
            "dispatched_vs_plain_state": ds, "eps1e-8_metrics_not_held": dm8,
            "eps1e-8_hypergrad_not_held": dh8, "eps1e-8_state_not_held": ds8}


def _bench_train(bench, route, device, fast):
    from repro_torch import perf
    from repro_torch.kernels import dispatch, flash_attn

    B, S, H, KV, Dh = 8, 128, 4, 2, 64
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((B, S, H, Dh)), device)
    k = _t(rng.standard_normal((B, S, KV, Dh)), device)
    v = _t(rng.standard_normal((B, S, KV, Dh)), device)
    q_pos = torch.arange(S, device=device, dtype=torch.int32)[None].expand(B, S).contiguous()
    kv_pos = torch.arange(S, device=device, dtype=torch.int32)
    fn = (dispatch.get_kernel("flash_attention") if route == "cuda"
          else lambda *a, **kw: flash_attn.flash_attention(*a, backend="plain", **kw))

    def fwd_bwd(q, k, v):
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        loss = torch.sum(fn(qq, kk, vv, q_pos, kv_pos, softcap=30.0) ** 2)
        return loss.detach(), torch.autograd.grad(loss, (qq, kk, vv))

    warmup, repeats = (1, 3) if fast else (2, 5)
    rec = perf.profile_step(f"attention_train_{route}", fwd_bwd, q, k, v,
                            samples_per_step=B * S, warmup=warmup, repeats=repeats,
                            extra={"shape": f"B{B}xS{S}xH{H}/KV{KV}xDh{Dh}", "backend": route})
    bench.emit_record(rec)
    bench.emit(rec.name, rec.us_per_step["median_us"],
               f"backend={route};tokens_per_s={rec.samples_per_s:.1f}")


def _bench_decode(bench, route, device, fast):
    from repro_torch import perf
    from repro_torch.kernels import dispatch, flash_attn

    B, T, H, KV, Dh = 16, 512, 4, 2, 64
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((B, 1, H, Dh)), device)
    k = _t(rng.standard_normal((B, T, KV, Dh)), device)
    v = _t(rng.standard_normal((B, T, KV, Dh)), device)
    pos = torch.as_tensor(rng.integers(0, T, (B, 1)), dtype=torch.int32, device=device)
    fn = (dispatch.get_kernel("flash_decode") if route == "cuda"
          else lambda *a, **kw: flash_attn.flash_decode(*a, backend="plain", **kw))
    warmup, repeats = (1, 3) if fast else (2, 5)
    extra = {"shape": f"B{B}xT{T}xH{H}/KV{KV}xDh{Dh}", "backend": route}
    if route == "cuda":
        extra["n_splits"] = flash_attn.decode_cluster(
            T, B * KV, max_cluster=flash_attn.decode_max_cluster(Dh, q.dtype))
    rec = perf.profile_step(f"attention_decode_{route}",
                            lambda q, k, v, pos: fn(q, k, v, pos, softcap=30.0), q, k, v, pos,
                            samples_per_step=B, warmup=warmup, repeats=repeats, extra=extra)
    bench.emit_record(rec)
    bench.emit(rec.name, rec.us_per_step["median_us"],
               f"backend={route};lanes_per_s={rec.samples_per_s:.1f}")


def _attribution_share(bench, step, state, bb, mb, fast):
    from repro_torch import perf

    warmup, repeats = (1, 3) if fast else (2, 5)
    rec = perf.profile_step("attention_step_attribution", step, state, bb, mb,
                            samples_per_step=BATCH * UNROLL, warmup=warmup, repeats=repeats,
                            extra={"method": "sama", "batch": BATCH, "unroll": UNROLL},
                            attribution=True)
    attr = rec.attribution
    share = attr["modules"].get("attention.py", {}).get("flop_frac", 0.0)
    bench.emit_record(rec)
    bench.emit("attention_step_attribution", rec.us_per_step["median_us"],
               f"attention_flop_share={share:.4f};top_module={attr['top_module']}")
    return share


def run(*, fast: bool = True, device="cuda") -> Bench:
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    bench = Bench("attention")
    err, gerr, derr = _assert_kernel_parity(dev)
    step, state, bb, mb = _problem(dev)
    diffs = _assert_step_parity(dev, step, state, bb, mb)
    bench.emit("attention_parity", 0.0,
               f"fwd_err={err:.2e};grad_err={gerr:.2e};decode_err={derr:.2e};"
               + ";".join(f"{k}={v:.2e}" for k, v in diffs.items()))
    for route in _routes(dev):
        _bench_train(bench, route, dev, fast)
        _bench_decode(bench, route, dev, fast)
    _attribution_share(bench, step, state, bb, mb, fast)
    bench.notes.update({
        "routes": list(_routes(dev)),
        "asserts": [f"forward within {PARITY_TOL} and q/k/v cotangents within {GRAD_TOL} of "
                    "the plain version (f32)", f"split-KV decode within {PARITY_TOL} of the "
                    "single-pass softmax at 1, 3, 5 splits",
                    f"the dispatched SAMA step against plain_everywhere (base Adam eps "
                    f"1e-3): metrics {STEP_METRICS_TOL}, hypergrad_norm "
                    f"{STEP_HYPERGRAD_TOL}, state {STEP_STATE_TOL}"],
        "not_held": "the same pair at base Adam eps 1e-8 (eps1e-8_*_not_held): the "
                    "coordinates whose gradient is at rounding level make up v there"})
    return bench


def main(argv=None):
    return cli("attention", run, argv)


if __name__ == "__main__":
    main()
