"""The port's mixture-of-experts layer (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe``, on the JAX layer's weights
carried over by ``repro_torch.convert`` and inputs from one numpy seed:
the routing first (expert indices from ``jax.lax.top_k``, and which
(choice, token) pairs keep a capacity slot, by the reference's
choice-major rule), then the output and the load-balance aux within 1e-5
and the gradients of the router, the experts, the shared experts and the
input within 5e-5, relative and of the leaf's largest entry (above 1): a
weight's gradient sums over every token the expert took, so its entries
grow with T and their rounding with them. qwen2-moe and kimi-k2 smoke
configs, with and without shared experts, and two dispatch groups of 1024
tokens where tokens are dropped. The routing is discrete: a tolerance miss is traced to a
different choice by the asserts that come first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, convert, tree  # noqa: E402
from repro_torch.models import moe  # noqa: E402

OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = 5e-5


def _assert_grad(got, ref, what):
    atol = GRAD * max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=GRAD, atol=atol, err_msg=what)


def _cfgs(arch, shared):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if not shared:
        jcfg, tcfg = (c.replace(num_shared_experts=0, shared_d_ff=0) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _inputs(cfg, b, s, seed, skew=0.0):
    """x (B, S, D) f32 from a numpy seed; ``skew`` adds one direction to
    every token, which tilts the router toward the same experts (so that
    their capacity overflows), and a cotangent for the output."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    x += skew * rng.standard_normal(cfg.d_model).astype(np.float32)
    ct = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x, ct


def _ref_keep(idx, num_experts, capacity):
    """The reference's keep mask for one group, from its expert indices
    (G, K): the choice-major cumsum of src/repro/models/moe.py."""
    G, K = idx.shape
    flat = np.eye(num_experts, dtype=np.float32)[idx.T.reshape(-1)]  # (K*G, E)
    pos = np.sum((np.cumsum(flat, 0) - flat) * flat, -1)
    return (pos < capacity).reshape(K, G)


def _jax_routing(jcfg, jp, x):
    T = x.shape[0] * x.shape[1]
    group = min(jmoe.MOE_GROUP, T)
    tokens = jnp.asarray(x).reshape(T // group, group, -1)
    logits = jnp.einsum("ngd,de->nge", tokens.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    return np.asarray(idx), group


CASES = [("qwen2-moe-a2.7b", True, 2, 24, 0.0), ("qwen2-moe-a2.7b", False, 2, 24, 0.0),
         ("kimi-k2-1t-a32b", True, 3, 16, 0.0), ("kimi-k2-1t-a32b", False, 3, 16, 0.0),
         ("qwen2-moe-a2.7b", True, 2, 1024, 3.0), ("kimi-k2-1t-a32b", False, 4, 512, 3.0)]


@pytest.mark.parametrize("arch,shared,b,s,skew", CASES)
def test_apply_moe_matches_jax(arch, shared, b, s, skew):
    jcfg, tcfg = _cfgs(arch, shared)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(5))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert ("shared" in tp) == shared
    x, ct = _inputs(tcfg, b, s, seed=b * s, skew=skew)

    # the routing: expert indices, then the capacity slots
    jidx, group = _jax_routing(jcfg, jp, x)
    n = jidx.shape[0]
    tokens = torch.from_numpy(x).reshape(n, group, -1)
    capacity = moe.moe_capacity(tcfg, group)
    assert capacity == max(int(jcfg.capacity_factor * jcfg.top_k * group / jcfg.num_experts), 4)
    tidx, keep, _, _ = moe.route(tcfg, moe.router_probs(tp, tokens), capacity)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    ref_keep = np.stack([_ref_keep(jidx[i], jcfg.num_experts, capacity) for i in range(n)])
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    if skew:  # the large-T cases must drop tokens, or they test nothing more
        assert not ref_keep.all()

    # the output and the aux, then every gradient
    def jloss(p, xx):
        out, aux = jmoe.apply_moe(jcfg, p, xx)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = tree.tree_map(lambda t: t.requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    tout, taux = moe.apply_moe(tcfg, tp, xt)
    assert tout.shape == x.shape and taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **OUT)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **OUT)
    (torch.sum(tout * torch.from_numpy(ct)) + taux).backward()
    _assert_grad(xt.grad.numpy(), np.asarray(jgx), "x")
    t_leaves, paths = tree.tree_flatten(tp)
    j_leaves, j_paths = tree.tree_flatten(jax.tree_util.tree_map(np.asarray, jgp))
    assert paths == j_paths
    for path, t, j in zip(paths, t_leaves, j_leaves):
        _assert_grad(t.grad.numpy(), j, "/".join(path))


def test_expert_leaves_stack_over_layers_then_experts():
    """(L, E, D, F) inside the layer stack: the reference's stacked_init
    nested in the layer stack's."""
    cfg = configs.get_config("qwen2-moe-a2.7b")
    p = moe.init_moe(cfg, None, device="meta", lead=(24,))
    shapes = {"/".join(k): tuple(v.shape) for v, k in zip(*tree.tree_flatten(p))}
    assert shapes == {"router": (24, 2048, 60), "experts/up": (24, 60, 2048, 1408),
                      "experts/gate": (24, 60, 2048, 1408),
                      "experts/down": (24, 60, 1408, 2048), "shared/up": (24, 2048, 5632),
                      "shared/gate": (24, 2048, 5632), "shared/down": (24, 5632, 2048)}
    assert p["router"].dtype == torch.float32


@pytest.mark.parametrize("b,s", [(3, 500), (1, 1500), (2, 1025)])
def test_token_count_off_the_group_raises(b, s):
    cfg = configs.get_smoke_config("qwen2-moe-a2.7b")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="MOE_GROUP"):
        moe.apply_moe(cfg, p, torch.zeros(b, s, cfg.d_model))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_breaks_ties_by_the_lower_index_as_jax(seed):
    """Rows full of equal values (quantised to a few levels): the port's
    top_k gives jax.lax.top_k's indices and values."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 3, (64, 60)) / 4.0).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = moe.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
