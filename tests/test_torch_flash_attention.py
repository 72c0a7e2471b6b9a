"""The port's training flash attention (``repro_torch.kernels.flash_attn.
flash_attention``, an autograd Function) against the JAX package's, on
the CPU, where it runs its plain versions: the forward and the VJP (dq,
dk, dv) against the Pallas kernel in interpret mode and against
``flash_attention_ref``; the lse against the Pallas forward's; the chunked
path; padded query rows; the window gate; the refused combination. The
CUDA kernels run only on a card (tests/test_torch_kernels_cuda.py).

Tolerances (tests/test_flash_attention.py): f32 forward 1e-5, VJP 5e-5
abs (rtol 1e-4), bf16 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import dispatch, flash_attn  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 5e-5
BF16_TOL = 2e-2

# (B, S, T, H, KV, Dh, softcap, window, causal, chunk): G in {1, 4} (and
# 2, 3), Dh in {8, 64}, ragged S and T, causal on and off, window and
# softcap, the chunked reference path
CASES = [
    (2, 7, 7, 4, 4, 8, 0.0, 0, True, 0),        # G=1, ragged
    (1, 13, 13, 8, 2, 64, 30.0, 5, True, 0),    # G=4, softcap + window
    (2, 9, 9, 4, 1, 64, 0.0, 0, False, 0),      # G=4, non-causal (the encoder)
    (1, 11, 11, 6, 2, 8, 20.0, 4, True, 0),     # G=3, everything on
    (2, 10, 10, 4, 4, 64, 0.0, 0, False, 0),    # G=1, Dh 64: bert's attention
    (1, 12, 12, 4, 2, 8, 0.0, 3, True, 4),      # G=2, the chunked path
    (2, 5, 12, 4, 1, 8, 10.0, 0, True, 0),      # S < T, queries continue the keys
]


def _inputs(case, dtype=np.float32, seed=0):
    B, S, T, H, KV, Dh = case[:6]
    rng = np.random.default_rng(seed + S * 31 + T + Dh)
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    cot = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (B, S)).copy()
    kv_pos = np.arange(T, dtype=np.int32)
    return q, k, v, cot, q_pos, kv_pos


def _kw(case):
    softcap, window, causal, chunk = case[6:]
    return dict(softcap=softcap, window=window, causal=causal, chunk=chunk)


def _jax_pair(case, arrays, dtype):
    q, k, v, _, q_pos, kv_pos = arrays
    kw = _kw(case)
    lf = jnp.asarray(True) if kw["window"] else None
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    ref = jfa.flash_attention_ref(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), lf, **kw)
    kern = jfa.flash_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), lf,
                               interpret=True, block_q=8, block_k=8, **kw)
    return ref, kern


def _port(case, arrays, dtype=torch.float32, requires_grad=False):
    q, k, v, _, q_pos, kv_pos = arrays
    kw = _kw(case)
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(requires_grad)
                  for x in (q, k, v))
    out = flash_attn.flash_attention(tq, tk, tv, torch.from_numpy(q_pos),
                                     torch.from_numpy(kv_pos), True if kw["window"] else None,
                                     **kw)
    return out, (tq, tk, tv)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_kernel_and_ref_f32(case):
    arrays = _inputs(case)
    ref, kern = _jax_pair(case, arrays, jnp.float32)
    got, _ = _port(case, arrays)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4], CASES[6]])
def test_forward_matches_jax_kernel_and_ref_bf16(case):
    arrays = _inputs(case)
    ref, kern = _jax_pair(case, arrays, jnp.bfloat16)
    got, _ = _port(case, arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for want in (ref, kern):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("case", CASES)
def test_vjp_matches_jax_kernel_and_ref(case):
    arrays = _inputs(case)
    q, k, v, cot, q_pos, kv_pos = arrays
    kw = _kw(case)
    lf = jnp.asarray(True) if kw["window"] else None

    def loss(fn, extra):
        return lambda q, k, v: jnp.sum(
            fn(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), lf, **kw, **extra)
            * jnp.asarray(cot))

    jargs = tuple(jnp.asarray(x) for x in (q, k, v))
    g_ref = jax.grad(loss(jfa.flash_attention_ref, {}), argnums=(0, 1, 2))(*jargs)
    g_kern = jax.grad(loss(jfa.flash_attention, dict(interpret=True, block_q=8, block_k=8)),
                      argnums=(0, 1, 2))(*jargs)
    out, leaves = _port(case, arrays, requires_grad=True)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, leaf, a, b in zip("qkv", leaves, g_ref, g_kern):
        for want in (a, b):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=GRAD_TOL,
                                       rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[5], CASES[6]])
def test_plain_lse_matches_the_pallas_forward(case):
    """The lse the forward saves (B*KV, G, S) equals the Pallas kernel's."""
    q, k, v, _, q_pos, kv_pos = _inputs(case)
    kw = _kw(case)
    lf = jnp.asarray(True) if kw["window"] else None
    use_window = kw["window"] if lf is not None else 0
    s = q.shape[1]
    _, jlse = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(q_pos), jnp.asarray(kv_pos),
                            jfa._flag_array(lf, use_window), kw["softcap"], use_window,
                            kw["causal"], True, 8, 8)
    _, lse = flash_attn.flash_attention_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos)), softcap=kw["softcap"],
        window=use_window, causal=kw["causal"], chunk=kw["chunk"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :s], atol=FWD_TOL,
                               rtol=1e-6)


def test_padded_query_rows_leave_the_other_rows_alone():
    """Positions -1 on trailing queries: the rows with positions >= 0
    agree with the Pallas kernel and the ref (the padded rows themselves
    differ between the two: zeros in the kernel, a uniform average in the
    ref, which the port's plain version follows)."""
    case = CASES[0]
    arrays = list(_inputs(case))
    arrays[4][:, -2:] = -1
    ref, kern = _jax_pair(case, arrays, jnp.float32)
    got, _ = _port(case, arrays)
    for want in (ref, kern):
        np.testing.assert_allclose(got.numpy()[:, :-2], np.asarray(want)[:, :-2],
                                   atol=FWD_TOL, rtol=0)


def test_local_flag_false_drops_the_window():
    case = CASES[1]
    q, k, v, _, q_pos, kv_pos = (torch.from_numpy(x) for x in _inputs(case))
    kw = dict(softcap=30.0, window=5)
    glob = flash_attn.flash_attention(q, k, v, q_pos, kv_pos, False, **kw)
    none = flash_attn.flash_attention(q, k, v, q_pos, kv_pos, None, **kw)
    loc = flash_attn.flash_attention(q, k, v, q_pos, kv_pos, True, **kw)
    nowin = flash_attn.flash_attention(q, k, v, q_pos, kv_pos, True, softcap=30.0, window=0)
    assert torch.equal(glob, none) and torch.equal(glob, nowin)
    assert not torch.allclose(glob, loc)


def test_non_causal_with_an_engaged_window_is_refused():
    """The JAX ref drops the window when non-causal, its kernel keeps it
    (ROADMAP queue 3): the port raises rather than pick a side."""
    q, k, v, _, q_pos, kv_pos = (torch.from_numpy(x) for x in _inputs(CASES[2]))
    with pytest.raises(ValueError, match="causal=False with an engaged window"):
        flash_attn.flash_attention(q, k, v, q_pos, kv_pos, True, window=3, causal=False)
    # a window that is not engaged (global layer) is fine
    flash_attn.flash_attention(q, k, v, q_pos, kv_pos, False, window=3, causal=False)


@pytest.mark.parametrize("t,chunk", [(13, 4), (7, 8), (9, 4)])
def test_chunked_sdpa_matches_jax(t, chunk):
    B, KV, G, Dh = 2, 2, 2, 16
    rng = np.random.default_rng(t * chunk)
    q5 = rng.standard_normal((B, t, KV, G, Dh)).astype(np.float32)
    k = rng.standard_normal((B, t, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, t, KV, Dh)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t)).copy()
    kv_pos = np.arange(t, dtype=np.int32)
    want = jattn._chunked_sdpa(*(jnp.asarray(x) for x in (q5, k, v, q_pos, kv_pos)),
                               chunk=chunk)
    got, _ = attn._chunked_sdpa(*(torch.from_numpy(x) for x in (q5, k, v, q_pos, kv_pos)),
                                chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_versions_in_both_passes():
    case = CASES[3]
    arrays = _inputs(case)
    dispatch.reset_launches()
    dispatch.clear_dispatch_log()
    out, leaves = _port(case, arrays, requires_grad=True)
    out.sum().backward()
    assert dispatch.dispatch_log() == [("flash_attention", "plain", "cpu tensor")]
    assert sum(dispatch.launches(n) for n in (flash_attn.FWD, flash_attn.DQ,
                                              flash_attn.DKV)) == 0
    assert all(leaf.grad is not None for leaf in leaves)


@pytest.mark.parametrize("bad,match", [
    (dict(q=(2, 4, 3, 8), k=(2, 4, 2, 8)), "does not group"),
    (dict(q=(2, 4, 36, 8), k=(2, 4, 4, 8)), "G <= 8"),
    (dict(q=(2, 4, 4, 12), k=(2, 4, 1, 12)), "multiple of 8"),
    (dict(dtype=torch.float64), "dtypes"),
    (dict(pos=torch.int64), "int32"),
    (dict(), "cuda tensors"),
])
def test_kernel_wrapper_rejects_what_the_kernels_do_not_take(bad, match):
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(bad.get("q", (2, 4, 4, 8)), dtype=dtype)
    k = torch.zeros(bad.get("k", (2, 4, 1, 8)), dtype=dtype)
    q_pos = torch.zeros((2, 4), dtype=bad.get("pos", torch.int32))
    kv_pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        flash_attn._check_attention(q, k, k.clone(), q_pos, kv_pos)
