"""The port's state-space layers (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``, function for function, on the JAX
weights carried over by ``repro_torch.convert`` and inputs from one numpy
seed, at the zamba2-7b (Mamba2) and rwkv6-1.6b (RWKV6) ``SMOKE`` configs:

* every function in f32 within 1e-5 (the inits: the same tree, shapes and
  dtypes, and the constant leaves equal);
* the gradients of ``apply_mamba`` and ``apply_rwkv_time_mix`` in the
  input and every weight against ``jax.grad`` within 1e-4;
* bf16 activations within 2e-2 (on the JAX init's weights);
* several one-token decode steps in a row, the state carried by each
  package, and the decode equal to the chunked forward over the same
  tokens;
* the chunk-size invariance of ``tests/test_models_property.py``, on the
  port.

The JAX inits leave ``u``, ``A_log`` and the mixes at constants; the
weights here are redrawn from numpy (``_redraw``) so that every term of
the recurrences is exercised.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs, convert, tree  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)

MAMBA, RWKV = "zamba2-7b", "rwkv6-1.6b"


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _cfgs(arch, **kw):
    return (jconfigs.get_smoke_config(arch).replace(**kw),
            configs.get_smoke_config(arch).replace(**kw))


def _redraw(p, seed):
    """The JAX tree with every leaf redrawn from numpy at a scale that keeps
    the recurrences in range: decay logits, A_log and dt_bias near their
    inits, mixes in [0, 1], weights at the fan-in scale."""
    rng = np.random.default_rng(seed)
    leaves, paths = tree.tree_flatten(_np_tree(p))
    out = []
    for path, a in zip(paths, leaves):
        name = path[-1]
        if path[0] == "mu":
            x = rng.uniform(0.0, 1.0, a.shape)
        elif name in ("w0", "dt_bias"):
            x = rng.uniform(-3.0, -0.5, a.shape)
        elif name == "A_log":
            x = rng.uniform(-1.0, 1.0, a.shape)
        elif name in ("u", "D", "conv_b", "bias") or path[-2:] == ("ln_x", "scale"):
            x = rng.uniform(-1.0, 1.0, a.shape) + (1.0 if name in ("D", "scale") else 0.0)
        elif name == "norm":
            x = rng.uniform(0.5, 1.5, a.shape)
        else:
            x = rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
        out.append(x.astype(a.dtype))
    return jax.tree_util.tree_map(jnp.asarray, tree.tree_unflatten(paths, out))


def _weights(arch, init, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = _redraw(init(jcfg, jax.random.PRNGKey(seed)), seed + 100)
    return jcfg, tcfg, jp, convert.params_from_jax(_np_tree(jp), device="cpu")


def _x(cfg, b, s, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)) * scale
            ).astype(np.float32)


def _close(got, ref, what="", **tol):
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), what
        for k in got:
            _close(got[k], ref[k], f"{what}/{k}", **tol)
        return
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, err_msg=what, **(tol or F32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# ---------------------------------------------------------------------------
# inits and dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,names", [
    (MAMBA, ("init_mamba",)), (RWKV, ("init_rwkv_time_mix", "init_rwkv_channel_mix"))])
def test_inits_give_the_reference_tree(arch, names):
    jcfg, tcfg = _cfgs(arch)
    for name in names:
        jp = _np_tree(getattr(jssm, name)(jcfg, jax.random.PRNGKey(0)))
        tp = getattr(ssm, name)(tcfg, torch.Generator().manual_seed(0), device="cpu")
        (jl, jpaths), (tl, tpaths) = tree.tree_flatten(jp), tree.tree_flatten(tp)
        assert tpaths == jpaths
        for path, a, b in zip(jpaths, jl, tl):
            assert tuple(b.shape) == a.shape and str(b.dtype).split(".")[-1] == str(a.dtype)
            if path[-1] not in ("in_proj", "conv_w", "out_proj", "wr", "wk", "wv", "wg", "wo",
                                "wA", "wB"):
                np.testing.assert_array_equal(b.numpy(), a, err_msg="/".join(path))
        stacked = getattr(ssm, name)(tcfg, torch.Generator().manual_seed(0), device="cpu",
                                     lead=(3, 2))
        assert all(tuple(x.shape) == (3, 2) + y.shape
                   for x, y in zip(tree.tree_leaves(stacked), jl))
    assert ssm.mamba_dims(tcfg) == jssm.mamba_dims(jcfg)
    assert ssm.rwkv_dims(tcfg) == jssm.rwkv_dims(jcfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_inits_match(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    for arch, jfn, tfn in ((MAMBA, jssm.init_mamba_state, ssm.init_mamba_state),
                           (RWKV, jssm.init_rwkv_state, ssm.init_rwkv_state)):
        jcfg, tcfg = _cfgs(arch)
        js, ts = jfn(jcfg, 3, jdt), tfn(tcfg, 3, dtype, device="cpu")
        assert sorted(ts) == sorted(js)
        for k in ts:
            assert tuple(ts[k].shape) == js[k].shape
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), k
            assert not torch.any(ts[k] != 0)
    # RWKV's S stays f32 whatever the cache dtype
    assert ssm.init_rwkv_state(tcfg, 1, torch.bfloat16, device="cpu")["S"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the pieces, f32
# ---------------------------------------------------------------------------


def test_causal_depthwise_conv_matches():
    rng = np.random.default_rng(3)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 11, 6), (6, 4), (6,)))
    _close(ssm.causal_depthwise_conv(_t(x), _t(w), _t(b)),
           jssm.causal_depthwise_conv(_j(x), _j(w), _j(b)))
    # causal: an impulse at t = 4 reaches nothing before it
    imp = np.zeros((1, 8, 3), np.float32)
    imp[0, 4] = 1.0
    out = ssm.causal_depthwise_conv(_t(imp), torch.ones(3, 4), torch.zeros(3))
    assert not torch.any(out[0, :4] != 0)


def test_mamba_pre_and_post_projections_match():
    jcfg, tcfg, jp, tp = _weights(MAMBA, jssm.init_mamba)
    x = _x(tcfg, 2, 8, 1)
    got, ref = ssm._mamba_preproj(tcfg, tp, _t(x)), jssm._mamba_preproj(jcfg, jp, _j(x))
    for a, b, what in zip(got, ref, ("z", "xBC", "dt")):
        _close(a, b, what)
    d_inner, H, P, _ = ssm.mamba_dims(tcfg)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 8, H, P)).astype(np.float32)
    z = rng.standard_normal((2, 8, d_inner)).astype(np.float32)
    _close(ssm._mamba_postproc(tcfg, tp, _t(y), _t(z)),
           jssm._mamba_postproc(jcfg, jp, _j(y), _j(z)))


def test_rwkv_pieces_match():
    jcfg, tcfg, jp, tp = _weights(RWKV, jssm.init_rwkv_time_mix)
    x, carry = _x(tcfg, 2, 8, 4), _x(tcfg, 2, 1, 5)[:, 0]
    for last in (None, carry):
        _close(ssm._token_shift(_t(x), None if last is None else _t(last)),
               jssm._token_shift(_j(x), None if last is None else _j(last)))
    xprev = _x(tcfg, 2, 8, 6)
    _close(ssm._mix(_t(x), _t(xprev), tp["mu"]["r"]), jssm._mix(_j(x), _j(xprev), jp["mu"]["r"]))
    got = ssm._rwkv_proj(tcfg, tp, _t(x), _t(xprev))
    ref = jssm._rwkv_proj(jcfg, jp, _j(x), _j(xprev))
    for a, b, what in zip(got, ref, ("r", "k", "v", "g", "logw")):
        _close(a, b, what)
    H, K = ssm.rwkv_dims(tcfg)
    y = np.random.default_rng(7).standard_normal((2, 8, H, K)).astype(np.float32)
    g = np.asarray(ref[3])
    _close(ssm._rwkv_out(tcfg, tp, _t(y), _t(g), torch.float32),
           jssm._rwkv_out(jcfg, jp, _j(y), _j(g), jnp.float32))


def test_channel_mix_and_its_decode_match():
    jcfg, tcfg, jp, tp = _weights(RWKV, jssm.init_rwkv_channel_mix)
    x, last = _x(tcfg, 2, 8, 8), _x(tcfg, 2, 1, 9)[:, 0]
    _close(ssm.apply_rwkv_channel_mix(tcfg, tp, _t(x)), jssm.apply_rwkv_channel_mix(jcfg, jp, _j(x)))
    _close(ssm.apply_rwkv_channel_mix(tcfg, tp, _t(x), _t(last)),
           jssm.apply_rwkv_channel_mix(jcfg, jp, _j(x), _j(last)))
    state = {"x_ffn": last}
    got = ssm.rwkv_channel_mix_decode(tcfg, tp, _t(x[:, :1]), tree.tree_map(_t, state))
    ref = jssm.rwkv_channel_mix_decode(jcfg, jp, _j(x[:, :1]), tree.tree_map(_j, state))
    _close(got[0], ref[0])
    _close(got[1], ref[1])


# ---------------------------------------------------------------------------
# the chunked layers: outputs, gradients, bf16
# ---------------------------------------------------------------------------

LAYERS = {
    "mamba": (MAMBA, jssm.init_mamba, ssm.apply_mamba, jssm.apply_mamba),
    "rwkv": (RWKV, jssm.init_rwkv_time_mix, ssm.apply_rwkv_time_mix,
             jssm.apply_rwkv_time_mix),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("b,s", [(2, 32), (1, 7), (3, 48)])
def test_chunked_layer_matches(layer, b, s):
    """Several chunks carrying the state (S = 32, 48), and one short chunk
    (S = 7 < ssm_chunk: Q = S)."""
    arch, init, fn, jfn = LAYERS[layer]
    jcfg, tcfg, jp, tp = _weights(arch, init, seed=s)
    x = _x(tcfg, b, s, s + 1)
    _close(fn(tcfg, tp, _t(x)), jfn(jcfg, jp, _j(x)))


def test_rwkv_time_mix_with_a_carried_token_matches():
    jcfg, tcfg, jp, tp = _weights(RWKV, jssm.init_rwkv_time_mix)
    x, last = _x(tcfg, 2, 16, 11), _x(tcfg, 2, 1, 12)[:, 0]
    _close(ssm.apply_rwkv_time_mix(tcfg, tp, _t(x), _t(last)),
           jssm.apply_rwkv_time_mix(jcfg, jp, _j(x), _j(last)))


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_chunked_layer_raises_on_a_ragged_last_chunk(layer):
    arch, init, fn, _ = LAYERS[layer]
    _, tcfg, _, tp = _weights(arch, init)
    Q = tcfg.ssm_chunk
    with pytest.raises(ValueError, match=f"not divisible by ssm chunk {Q}"):
        fn(tcfg, tp, _t(_x(tcfg, 1, Q + 1, 0)))


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_chunked_layer_gradients_match_jax_grad(layer):
    arch, init, fn, jfn = LAYERS[layer]
    jcfg, tcfg, jp, tp = _weights(arch, init, seed=5)
    x = _x(tcfg, 2, 32, 13)
    ct = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jfn(jcfg, p, xx) * ct)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, _j(x))
    leaves, paths = tree.tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tx = _t(x).requires_grad_(True)
    loss = torch.sum(fn(tcfg, tree.tree_unflatten(paths, leaves), tx) * _t(ct))
    grads = torch.autograd.grad(loss, leaves + [tx])
    _close(grads[-1], jgx, "x", **GRAD)
    for path, g, r in zip(paths, grads[:-1], tree.tree_leaves(_np_tree(jgp))):
        _close(g, r, "/".join(path), **GRAD)


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_masked_exponent_overflow_leaves_the_gradient_finite(layer):
    """ROADMAP queue 3: where a masked (j > i) intra-chunk exponent passes
    f32's range, the reference's ``where(mask, exp(diff), 0)`` multiplies
    its zero cotangent by exp(diff) = inf in the backward and its gradient
    turns NaN; the port sets those exponents to -inf before the
    exponential. Mamba with dt_bias 10 (dt ~ 10 a token, cumulative decays
    of ~-160 over a 16-token chunk), RWKV with w0 3 (log-decay -20 a
    token): the outputs agree, JAX's gradient is not finite, the port's
    is."""
    arch, init, fn, jfn = LAYERS[layer]
    jcfg, tcfg, jp, _ = _weights(arch, init, seed=9)
    name = "dt_bias" if layer == "mamba" else "w0"
    jp = dict(jp, **{name: jnp.full_like(jp[name], 10.0 if layer == "mamba" else 3.0)})
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    x = _x(tcfg, 1, 16, 19)
    _close(fn(tcfg, tp, _t(x)), jfn(jcfg, jp, _j(x)))
    jg = jax.grad(lambda xx: jnp.sum(jfn(jcfg, jp, xx)))(_j(x))
    assert not np.all(np.isfinite(np.asarray(jg)))
    tx = _t(x).requires_grad_(True)
    tg, = torch.autograd.grad(fn(tcfg, tp, tx).sum(), tx)
    assert bool(torch.isfinite(tg).all())


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_chunked_layer_in_bf16_matches(layer):
    """On the JAX init's own weights. With the redrawn ones (Mamba outputs
    up to 3.8) JAX's bf16 output itself lies up to 1.4 times 2e-2 from its
    f32 output, the port's no farther: XLA keeps the bf16 elementwise
    chains in f32 (excess precision) where eager PyTorch rounds each op, so
    the two bf16 results part by up to 1.7 times 2e-2 there."""
    arch, init, fn, jfn = LAYERS[layer]
    jcfg, tcfg = _cfgs(arch)
    jp = init(jcfg, jax.random.PRNGKey(6))
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    x = _x(tcfg, 2, 32, 15)
    got = fn(tcfg, tp, _t(x, torch.bfloat16))
    ref = jfn(jcfg, jp, _j(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(got, ref, **BF16)


# ---------------------------------------------------------------------------
# one-token decode, carried over several tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_decode_carries_state_like_jax(dtype):
    """Six tokens one at a time from a zero state, each package carrying its
    own state: every output and state within tolerance, the state in the
    cache's dtype (bf16: re-cast every token, as the reference does); in f32
    the outputs equal the chunked forward over the six tokens."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg, tcfg, jp, tp = _weights(MAMBA, jssm.init_mamba, seed=7)
    x = _x(tcfg, 3, 6, 16)
    jst, tst = jssm.init_mamba_state(jcfg, 3, jdt), ssm.init_mamba_state(tcfg, 3, dtype,
                                                                        device="cpu")
    tol = F32 if dtype == torch.float32 else BF16
    outs = []
    for t in range(6):
        jo, jst = jssm.mamba_decode(jcfg, jp, _j(x[:, t:t + 1], jdt), jst)
        to, tst = ssm.mamba_decode(tcfg, tp, _t(x[:, t:t + 1], dtype), tst)
        assert to.dtype == dtype and all(v.dtype == dtype for v in tst.values())
        _close(to, jo, f"out {t}", **tol)
        _close(tst, _np_tree(jst), f"state {t}", **tol)
        outs.append(to)
    if dtype == torch.float32:
        full = ssm.apply_mamba(tcfg.replace(ssm_chunk=2), tp, _t(x))
        _close(torch.cat(outs, 1), full.detach().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_decode_carries_state_like_jax(dtype):
    """As the Mamba test, through both halves of an RWKV block's decode;
    S stays f32 in either cache dtype."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg, tcfg, jp, tp = _weights(RWKV, jssm.init_rwkv_time_mix, seed=8)
    _, _, jc, tc = _weights(RWKV, jssm.init_rwkv_channel_mix, seed=9)
    x = _x(tcfg, 2, 6, 17)
    jst, tst = jssm.init_rwkv_state(jcfg, 2, jdt), ssm.init_rwkv_state(tcfg, 2, dtype,
                                                                      device="cpu")
    tol = F32 if dtype == torch.float32 else BF16
    outs = []
    for t in range(6):
        xt = x[:, t:t + 1]
        jo, ja = jssm.rwkv_time_mix_decode(jcfg, jp, _j(xt, jdt), jst)
        to, ta = ssm.rwkv_time_mix_decode(tcfg, tp, _t(xt, dtype), tst)
        jo2, jf = jssm.rwkv_channel_mix_decode(jcfg, jc, _j(xt, jdt), jst)
        to2, tf = ssm.rwkv_channel_mix_decode(tcfg, tc, _t(xt, dtype), tst)
        jst, tst = {**jst, **ja, **jf}, {**tst, **ta, **tf}
        assert tst["S"].dtype == torch.float32 and tst["x_att"].dtype == dtype
        for a, b, what in ((to, jo, "tmix"), (to2, jo2, "cmix")):
            _close(a, b, f"{what} {t}", **tol)
        _close(tst, _np_tree(jst), f"state {t}", **tol)
        outs.append(to)
    if dtype == torch.float32:
        full = ssm.apply_rwkv_time_mix(tcfg.replace(ssm_chunk=2), tp, _t(x))
        _close(torch.cat(outs, 1), full.detach().numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# chunk invariance (tests/test_models_property.py, on the port)
# ---------------------------------------------------------------------------


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 50), chunk=st.sampled_from([4, 8, 16]))
def test_mamba_chunk_invariance(seed, chunk):
    """Chunked SSD is invariant to the chunk size (it is the recurrence)."""
    tcfg = configs.get_smoke_config(MAMBA)
    p = ssm.init_mamba(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    x = torch.from_numpy(_x(tcfg, 1, 16, seed + 1, scale=0.3))
    outs = [ssm.apply_mamba(tcfg.replace(ssm_chunk=q), p, x).numpy() for q in (chunk, 16)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-3, atol=2e-4)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 50), chunk=st.sampled_from([2, 4, 8]))
def test_rwkv_chunk_invariance(seed, chunk):
    tcfg = configs.get_smoke_config(RWKV)
    p = ssm.init_rwkv_time_mix(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    x = torch.from_numpy(_x(tcfg, 1, 16, seed + 1, scale=0.3))
    outs = [ssm.apply_rwkv_time_mix(tcfg.replace(ssm_chunk=q), p, x).numpy()
            for q in (chunk, 16)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-3, atol=2e-4)
