"""The port's gemma3-1b decode step against the JAX package's, on the JAX
smoke weights carried over by ``repro_torch.convert``: block prefill
(S > 1) and one-token decode (S = 1) at per-lane positions past the
sliding window, logits and every cache leaf within 1e-4. Also: the
full-size parameter and cache trees have the same paths and shapes
(``jax.eval_shape`` against the port's init on the ``meta`` device).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_smoke_config("gemma3-1b")
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(configs.get_smoke_config("gemma3-1b"), device="cpu")
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                      device="cpu")
    return jm, jparams, tm, tparams


def _assert_tree_close(torch_tree, jax_tree):
    got = convert.params_to_numpy(torch_tree)
    ref = jax.tree_util.tree_map(np.asarray, jax_tree)
    g_leaves, g_paths = cm.tree_flatten(got)
    r_leaves, r_paths = cm.tree_flatten(ref)
    assert g_paths == r_paths
    for path, a, b in zip(g_paths, g_leaves, r_leaves):
        np.testing.assert_allclose(a, b, err_msg="/".join(path), **TOL)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_config_copy_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        a = getattr(configs, get)("gemma3-1b")
        b = getattr(jconfigs, get)("gemma3-1b")
        assert a.__dict__ == b.__dict__
        assert a.layer_kinds == b.layer_kinds


def test_params_round_trip(pair):
    _, jparams, _, tparams = pair
    _assert_tree_close(tparams, jparams)


def test_prefill_block_matches_jax(pair):
    """S > 1: the block prefill step from position 0 (the _sdpa path)."""
    jm, jparams, tm, tparams = pair
    B, P, CL = 2, 12, 24
    toks = _tokens(tm.cfg, (B, P), 0)
    jl, jc = jm.decode_step(jparams, jm.init_cache(B, CL, jnp.float32),
                            jnp.asarray(toks), jnp.asarray(0, jnp.int32))
    tl, tc = tm.decode_step(tparams, tm.init_cache(B, CL, torch.float32),
                            torch.from_numpy(toks).long(), 0)
    assert tl.shape == (B, P, tm.cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc)


def test_one_token_decode_at_lane_positions_past_the_window(pair):
    """S = 1 with a (B,) vector of positions beyond the smoke window (8):
    the flash_decode path with per-lane masking and the window gate."""
    jm, jparams, tm, tparams = pair
    B, P, CL = 3, 21, 32
    toks = _tokens(tm.cfg, (B, P), 1)
    jc = jm.init_cache(B, CL, jnp.float32)
    _, jc = jm.decode_step(jparams, jc, jnp.asarray(toks), jnp.asarray(0, jnp.int32))
    tc = tm.init_cache(B, CL, torch.float32)
    _, tc = tm.decode_step(tparams, tc, torch.from_numpy(toks).long(), 0)
    pos = np.array([21, 13, 17], np.int32)
    nxt = _tokens(tm.cfg, (B, 1), 2)
    for _ in range(3):  # a few steps, each feeding the cache forward
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt).long(),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree_close(tc, jc)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def test_one_token_decode_scalar_position(pair):
    jm, jparams, tm, tparams = pair
    B, P, CL = 2, 10, 16
    toks = _tokens(tm.cfg, (B, P), 3)
    _, jc = jm.decode_step(jparams, jm.init_cache(B, CL, jnp.float32), jnp.asarray(toks),
                           jnp.asarray(0, jnp.int32))
    _, tc = tm.decode_step(tparams, tm.init_cache(B, CL, torch.float32),
                           torch.from_numpy(toks).long(), 0)
    nxt = _tokens(tm.cfg, (B, 1), 4)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt), jnp.asarray(P, jnp.int32))
    tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt).long(), P)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc)


def _shapes(tree):
    leaves, paths = cm.tree_flatten(tree)
    return {p: tuple(x.shape) for p, x in zip(paths, leaves)}


def test_full_size_param_and_cache_shapes_match():
    jm = JaxModel(jconfigs.get_config("gemma3-1b"))
    tm = Model(configs.get_config("gemma3-1b"), device="meta")
    jshape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    tparams = tm.init(0)
    assert _shapes(tparams) == _shapes(jax.tree_util.tree_map(lambda x: x, jshape))
    assert all(x.dtype == torch.float32 for x in cm.tree_flatten(tparams)[0])
    assert 0.9e9 < tm.num_params(tparams) < 1.1e9  # about 1.0 B parameters
    jcache = jax.eval_shape(lambda: jm.init_cache(4, 1024))
    assert _shapes(tm.init_cache(4, 1024, device="meta")) == _shapes(jcache)


def test_embedding_scale_rounds_to_the_activation_dtype():
    assert cm.round_to(1152 ** 0.5, torch.bfloat16) == 34.0
    assert abs(cm.round_to(1152 ** 0.5, torch.float32) - 33.941125) < 1e-5


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = cm._act("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_rope_matches_reference():
    from repro.models import common as jcm

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    got = cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
    ref = np.asarray(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
