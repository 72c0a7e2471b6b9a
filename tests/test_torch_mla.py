"""The port's multi-head latent attention (``repro_torch.models.attention.
mla_attention``, minicpm3's) against the JAX package's, on the JAX
layer's weights carried over by ``repro_torch.convert`` and inputs from
one numpy seed, within 1e-4: the training output and its gradients; a
block written at a scalar cache position, then one token; per-lane
(``(B,)``) positions, one token and a block, into a cache already holding
rows; the cache rows written, compared leaf by leaf. With the low-rank
query (``q_lora_rank`` > 0, minicpm3) and the full query projection.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs, convert, tree  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(q_lora):
    jcfg = jconfigs.get_smoke_config("minicpm3-4b")
    tcfg = configs.get_smoke_config("minicpm3-4b")
    if not q_lora:
        jcfg, tcfg = jcfg.replace(q_lora_rank=0), tcfg.replace(q_lora_rank=0)
    jp = jattn.init_mla(jcfg, jax.random.PRNGKey(2))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert ("wq_a" in tp) == bool(q_lora) and ("wq" in tp) != bool(q_lora)
    return jcfg, jp, tcfg, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _assert_cache(tcache, jcache):
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("q_lora", [True, False])
def test_training_output_and_gradients_match_jax(q_lora):
    jcfg, jp, tcfg, tp = _pair(q_lora)
    B, S = 2, 11
    x = _x(tcfg, B, S, 0)
    ct = _x(tcfg, B, S, 1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

    def jloss(p, xx):
        out, cache = jattn.mla_attention(jcfg, p, xx, jnp.asarray(pos))
        assert cache is None
        return jnp.sum(out * ct), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = tree.tree_map(lambda t: t.requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    tout, cache = attn.mla_attention(tcfg, tp, xt, torch.from_numpy(pos.copy()))
    assert cache is None and tout.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    torch.sum(tout * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    leaves, paths = tree.tree_flatten(tp)
    jleaves, jpaths = tree.tree_flatten(jax.tree_util.tree_map(np.asarray, jgp))
    assert paths == jpaths
    for path, t, j in zip(paths, leaves, jleaves):
        np.testing.assert_allclose(t.grad.numpy(), j, err_msg="/".join(path), **TOL)


@pytest.mark.parametrize("q_lora", [True, False])
def test_scalar_position_block_then_token_match_jax(q_lora):
    jcfg, jp, tcfg, tp = _pair(q_lora)
    B, P, T = 2, 6, 12
    jcache = jattn.init_mla_cache(jcfg, B, T, jnp.float32)
    tcache = attn.init_mla_cache(tcfg, B, T, torch.float32, device="cpu")
    for start, s, seed in ((0, P, 3), (P, 1, 4), (P + 1, 1, 5)):
        x = _x(tcfg, B, s, seed)
        pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (B, s))
        jout, jcache = jattn.mla_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                           cache=jcache, cache_pos=jnp.asarray(start, jnp.int32))
        tout, same = attn.mla_attention(tcfg, tp, torch.from_numpy(x),
                                        torch.from_numpy(pos.copy()), cache=tcache,
                                        cache_pos=start)
        assert same is tcache  # written in place
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        _assert_cache(tcache, jcache)


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("s", [1, 3])
def test_per_lane_positions_match_jax(q_lora, s):
    """(B,) starts into a cache that holds rows already: each lane's rows
    scatter to its own positions and its queries see its own prefix."""
    jcfg, jp, tcfg, tp = _pair(q_lora)
    B, T = 3, 16
    rng = np.random.default_rng(6)
    ckv = rng.standard_normal((B, T, tcfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, T, tcfg.qk_rope_head_dim)).astype(np.float32)
    jcache = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(krope)}
    tcache = {"ckv": torch.from_numpy(ckv.copy()), "krope": torch.from_numpy(krope.copy())}
    starts = np.array([9, 2, 10], np.int32)
    for step in range(2):
        x = _x(tcfg, B, s, 7 + step)
        pos = starts[:, None] + np.arange(s, dtype=np.int32)[None]
        jout, jcache = jattn.mla_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                           cache=jcache, cache_pos=jnp.asarray(starts))
        tout, _ = attn.mla_attention(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                     cache=tcache, cache_pos=torch.from_numpy(starts))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        _assert_cache(tcache, jcache)
        starts = starts + s


def test_parameter_and_cache_shapes_match_jax():
    for get in ("get_config", "get_smoke_config"):
        jcfg, tcfg = getattr(jconfigs, get)("minicpm3-4b"), getattr(configs, get)("minicpm3-4b")
        jshape = jax.eval_shape(lambda: jattn.init_mla(jcfg, jax.random.PRNGKey(0)))
        tp = attn.init_mla(tcfg, None, device="meta", lead=(3,))
        jl, jpaths = tree.tree_flatten(jax.tree_util.tree_map(lambda a: a, jshape))
        tl, tpaths = tree.tree_flatten(tp)
        assert tpaths == jpaths
        assert [tuple(t.shape) for t in tl] == [(3,) + tuple(j.shape) for j in jl]
        assert [str(t.dtype).split(".")[-1] for t in tl] == [str(j.dtype) for j in jl]
        jc = jattn.init_mla_cache(jcfg, 2, 8)
        tc = attn.init_mla_cache(tcfg, 2, 8, device="meta")
        assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
