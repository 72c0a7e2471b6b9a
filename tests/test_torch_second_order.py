"""Second derivatives through the port's ``flash_attention`` and
``cross_entropy`` against the JAX package's.

The JAX baselines (``src/repro/core/baselines.py``: ``hvp`` is
``jax.jvp(jax.grad(...))``, ``mixed_vjp`` grad of grad) differentiate
twice through the dispatched kernels, whose CPU implementation is the
``ref`` twin: plain jnp, differentiable to any order. The port's plain
route (CPU tensors) is its plain forward's ops under autograd and must
give the same Hessian-vector products; its CUDA route is first order only
and must raise on a second derivative, as the JAX Pallas path does, never
return a wrong value. Here the CUDA route's Functions run with their
kernels stubbed by the plain versions (the kernels have no CPU mode); the
``cuda``-marked test runs the real kernels.

Inputs from a numpy seed, f32. Tolerance: the f32 VJP's 5e-5 abs with
rtol 1e-4 (tests/test_flash_attention.py GRAD_TOL, as
tests/test_torch_flash_attention.py holds the first derivative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.kernels import dispatch, flash_attn, weighted_ce  # noqa: E402

GRAD_TOL = dict(atol=5e-5, rtol=1e-4)

# (B, S, T, H, KV, Dh, softcap, window, causal, chunk)
ATTN_CASES = {
    "causal": (2, 6, 6, 2, 1, 8, 0.0, 0, True, 0),
    "window": (1, 9, 9, 2, 2, 8, 0.0, 3, True, 0),
    "softcap": (1, 7, 7, 2, 1, 16, 5.0, 0, True, 0),
    "gqa_g2": (2, 5, 8, 4, 2, 8, 0.0, 0, True, 0),
    "chunked": (1, 10, 10, 4, 2, 8, 5.0, 4, True, 4),
    "encoder": (2, 6, 6, 2, 2, 8, 0.0, 0, False, 0),
}


def _attn_arrays(case, seed):
    B, S, T, H, KV, Dh = case[:6]
    rng = np.random.default_rng(seed)
    primals = [rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh))]
    tangents = [rng.standard_normal(x.shape).astype(np.float32) for x in primals]
    cot = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (B, S)).copy()
    kv_pos = np.arange(T, dtype=np.int32)
    return primals, tangents, cot, q_pos, kv_pos


def _attn_kw(case):
    softcap, window, causal, chunk = case[6:]
    return dict(softcap=softcap, window=window, causal=causal, chunk=chunk)


def _jax_attn_hvp(case, arrays):
    primals, tangents, cot, q_pos, kv_pos = arrays
    kw = _attn_kw(case)
    fn = jdispatch.get_kernel("flash_attention")
    lf = jnp.asarray(True) if kw["window"] else None

    def loss(q, k, v):
        out = fn(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), lf, **kw)
        return jnp.sum(out * jnp.asarray(cot))

    _, hvp = jax.jvp(jax.grad(loss, argnums=(0, 1, 2)),
                     tuple(jnp.asarray(x) for x in primals),
                     tuple(jnp.asarray(x) for x in tangents))
    return [np.asarray(h) for h in hvp]


def _torch_attn_loss(case, arrays):
    _, _, cot, q_pos, kv_pos = arrays
    kw = _attn_kw(case)
    lf = True if kw["window"] else None

    def loss(q, k, v):
        out = flash_attn.flash_attention(q, k, v, torch.from_numpy(q_pos),
                                         torch.from_numpy(kv_pos), lf, **kw)
        return torch.sum(out * torch.from_numpy(cot))
    return loss


def _double_backward_hvp(loss, primals, tangents):
    """H . t by reverse over reverse: grad of <grad loss, t>."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in primals]
    grads = torch.autograd.grad(loss(*xs), xs, create_graph=True)
    dot = sum(torch.sum(g * torch.from_numpy(t)) for g, t in zip(grads, tangents))
    return torch.autograd.grad(dot, xs)


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_hvp_matches_jax(name):
    case = ATTN_CASES[name]
    arrays = _attn_arrays(case, seed=len(name))
    want = _jax_attn_hvp(case, arrays)
    dispatch.clear_dispatch_log()
    got = _double_backward_hvp(_torch_attn_loss(case, arrays), arrays[0], arrays[1])
    assert dispatch.dispatch_log() == [("flash_attention", "plain", "cpu tensor")]
    for what, g, w in zip(("q", "k", "v"), got, want):
        assert np.abs(w).max() > 1e-3, what  # a Hessian term that is not trivially 0
        np.testing.assert_allclose(g.numpy(), w, err_msg=what, **GRAD_TOL)


def test_flash_attention_forward_over_reverse_with_torch_func():
    """The JAX hvp's own form, forward over reverse, through torch.func."""
    case = ATTN_CASES["chunked"]
    arrays = _attn_arrays(case, seed=3)
    want = _jax_attn_hvp(case, arrays)
    loss = _torch_attn_loss(case, arrays)
    _, got = torch.func.jvp(torch.func.grad(loss, argnums=(0, 1, 2)),
                            tuple(torch.from_numpy(x) for x in arrays[0]),
                            tuple(torch.from_numpy(x) for x in arrays[1]))
    for what, g, w in zip(("q", "k", "v"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=what, **GRAD_TOL)


def _ce_arrays(r, v, seed):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((r, v))).astype(np.float32)
    targets = rng.integers(0, v, r).astype(np.int32)
    w = rng.standard_normal(r).astype(np.float32)
    tangent = rng.standard_normal((r, v)).astype(np.float32)
    return logits, targets, w, tangent


def _jax_ce_hvp(logits, targets, w, tangent):
    fn = jdispatch.get_kernel("weighted_ce")

    def loss(x):
        return jnp.sum(fn(x, jnp.asarray(targets)) * jnp.asarray(w))

    return np.asarray(jax.jvp(jax.grad(loss), (jnp.asarray(logits),),
                              (jnp.asarray(tangent),))[1])


@pytest.mark.parametrize("r,v", [(5, 64), (3, 4096)])
def test_cross_entropy_hvp_matches_jax(r, v):
    logits, targets, w, tangent = _ce_arrays(r, v, seed=r + v)
    want = _jax_ce_hvp(logits, targets, w, tangent)

    def loss(x):
        return torch.sum(weighted_ce.cross_entropy(x, torch.from_numpy(targets))
                         * torch.from_numpy(w))

    dispatch.clear_dispatch_log()
    (got,) = _double_backward_hvp(loss, [logits], [tangent])
    assert dispatch.dispatch_log() == [("weighted_ce", "plain", "cpu tensor")]
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_cross_entropy_forward_over_reverse_with_torch_func():
    logits, targets, w, tangent = _ce_arrays(4, 4096, seed=11)
    want = _jax_ce_hvp(logits, targets, w, tangent)

    def loss(x):
        return torch.sum(weighted_ce.cross_entropy(x, torch.from_numpy(targets))
                         * torch.from_numpy(w))

    _, got = torch.func.jvp(torch.func.grad(loss), (torch.from_numpy(logits),),
                            (torch.from_numpy(tangent),))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_cross_entropy_plain_backward_leaves_saved_tensors_alone():
    """The plain backward (what the backward kernel is held against) runs
    under autograd without touching what autograd saved, and agrees with
    the plain route's own gradient."""
    logits, targets, w, _ = _ce_arrays(6, 300, seed=5)
    x = torch.from_numpy(logits).requires_grad_(True)
    t = torch.from_numpy(targets)
    ce, lse = weighted_ce.cross_entropy_fwd_plain(x, t)
    d = weighted_ce.cross_entropy_bwd_plain(x, t, lse, torch.from_numpy(w))
    (auto,) = torch.autograd.grad((ce * torch.from_numpy(w)).sum(), x, retain_graph=True)
    (d * d).sum().backward()  # would raise had the backward changed exp's output in place
    np.testing.assert_allclose(d.detach().numpy(), auto.numpy(), atol=1e-6, rtol=1e-5)


def _stub_cuda_route(monkeypatch):
    """Route every call to the CUDA Functions, with the kernels' wrappers
    replaced by their plain versions (same arithmetic, CPU tensors)."""

    def fa_bwd(q, k, v, q_pos, kv_pos, lse, delta, g_out, **kw):
        return flash_attn.flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, lse, delta, g_out,
                                                    **kw)

    def ce_fwd(logits, targets):
        return weighted_ce.cross_entropy_fwd_plain(logits.reshape(-1, logits.shape[-1]),
                                                   targets)

    def ce_bwd(logits, targets, lse, g):
        return weighted_ce.cross_entropy_bwd_plain(logits.reshape(-1, logits.shape[-1]),
                                                   targets, lse, g).reshape(logits.shape)

    monkeypatch.setattr(dispatch, "route", lambda name, x, backend=None: dispatch.CUDA)
    monkeypatch.setattr(flash_attn, "_fwd_cuda", flash_attn.flash_attention_fwd_plain)
    monkeypatch.setattr(flash_attn, "_bwd_cuda", fa_bwd)
    monkeypatch.setattr(weighted_ce, "_fwd_cuda", ce_fwd)
    monkeypatch.setattr(weighted_ce, "_bwd_cuda", ce_bwd)


@pytest.mark.parametrize("kernel", ["flash_attention", "weighted_ce"])
def test_cuda_route_is_first_order_and_raises_on_a_second(kernel, monkeypatch):
    """The CUDA route's first derivative equals the plain route's; a second
    derivative through it raises (the saved lse is a constant to
    autograd, so one would be wrong)."""
    if kernel == "flash_attention":
        case = ATTN_CASES["window"]
        arrays = _attn_arrays(case, seed=1)
        loss, primals = _torch_attn_loss(case, arrays), arrays[0]
    else:
        logits, targets, w, _ = _ce_arrays(4, 4096, seed=2)
        primals = [logits]

        def loss(x):
            return torch.sum(weighted_ce.cross_entropy(x, torch.from_numpy(targets))
                             * torch.from_numpy(w))

    xs = [torch.from_numpy(x).requires_grad_(True) for x in primals]
    want = torch.autograd.grad(loss(*xs), xs)
    _stub_cuda_route(monkeypatch)
    got = torch.autograd.grad(loss(*xs), xs)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, atol=5e-5, rtol=1e-4)
    grads = torch.autograd.grad(loss(*xs), xs, create_graph=True)
    with pytest.raises(RuntimeError, match=f"{kernel}: a second derivative through the "
                       "CUDA kernels is not supported"):
        dot = sum(g.sum() for g in grads)
        torch.autograd.grad(dot, xs)


@pytest.mark.cuda
def test_second_derivative_through_the_cuda_kernels_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
               .requires_grad_(True) for s in ((1, 64, 4, 64), (1, 64, 1, 64), (1, 64, 1, 64)))
    pos = torch.arange(64, dtype=torch.int32, device=dev)
    out = flash_attn.flash_attention(q, k, v, pos[None], pos)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v), create_graph=True)
    with pytest.raises(RuntimeError, match="flash_attention: a second derivative"):
        torch.autograd.grad(sum(g.square().sum() for g in grads), (q, k, v))
    x = torch.from_numpy(rng.standard_normal((8, 5000)).astype(np.float32)).to(dev)
    x.requires_grad_(True)
    t = torch.from_numpy(rng.integers(0, 5000, 8).astype(np.int32)).to(dev)
    (g,) = torch.autograd.grad(weighted_ce.cross_entropy(x, t).square().sum(), x,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="weighted_ce: a second derivative"):
        torch.autograd.grad(g.square().sum(), x)
