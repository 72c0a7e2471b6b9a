"""The port's Adam adaptation product and optimizers against the JAX
package's: the plain ``adam_adapt`` (what CPU tensors take) against the
Pallas kernel run in interpret mode and against ``ref.adam_adapt_product``
for aligned and ragged sizes; the optimizers' update, adaptation and fused
adaptation-product trajectories over five steps; the schedules; bf16 bias
corrections. The CUDA kernel runs only on a card
(tests/test_torch_kernels_cuda.py).

Tolerances: out rtol 1e-5 / atol 1e-7 and sum of squares rtol 1e-4
(tests/test_kernels.py); trajectories 1e-6 relative (the same f32
elementwise formulas on both sides, rounded in a different order). The
adaptation diagonal at cold moments is the difference of two terms of size
lr/|g| that nearly cancel, so there each side carries rounding of that
size: 1e-6 absolute at lr 0.05.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import optim, tree  # noqa: E402
from repro_torch.kernels import adam_adapt, dispatch  # noqa: E402

TRAJ = dict(rtol=1e-6, atol=1e-9)
ADAPT = dict(rtol=1e-6, atol=1e-6)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    g, m, v, gm = (rng.standard_normal(n).astype(np.float32) for _ in range(4))
    return g, m, np.abs(v), gm


@pytest.mark.parametrize("n", [128, 1000, 8 * 1024, 50_000])
@pytest.mark.parametrize("t", [1, 2, 7])
def test_plain_adam_adapt_matches_jax_kernel_and_ref(n, t):
    arrays = _inputs(n, n + t)
    kern, kern_ss = jops.adam_adapt_product(*map(jnp.asarray, arrays), t=t, lr=0.3,
                                            backend="pallas-interpret")
    ref, ref_ss = jref.adam_adapt_product(*map(jnp.asarray, arrays), t=t, b1=0.9, b2=0.999,
                                          eps=1e-8, lr=0.3)
    got, got_ss = adam_adapt.adam_adapt(*map(torch.from_numpy, arrays), t=t, lr=0.3)
    assert got.dtype == torch.float32 and got.shape == (n,)
    for want, want_ss in ((kern, kern_ss), (ref, ref_ss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(got_ss), float(want_ss), rtol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    g, m, v, gm = map(torch.from_numpy, _inputs(64, 0))
    dispatch.reset_launches()
    dispatch.clear_dispatch_log()
    t = torch.tensor(3, dtype=torch.int32)
    out, ss = adam_adapt.adam_adapt(g, m, v, gm, t=t, lr=torch.tensor(0.1))
    plain, plain_ss = adam_adapt.adam_adapt_plain(g, m, v, gm, t=3, b1=0.9, b2=0.999,
                                                  eps=1e-8, lr=0.1)
    assert torch.equal(out, plain) and torch.equal(ss, plain_ss)
    assert dispatch.dispatch_log() == [("adam_adapt", "plain", "cpu tensor")]
    assert dispatch.launches("adam_adapt") == 0
    with pytest.raises(ValueError, match="cuda|float32|flat"):
        adam_adapt._check(g, m, v, gm)  # the kernel's checks refuse CPU tensors


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {}),
    ("adamw", {"weight_decay": 0.05}),
    ("sgd", {"weight_decay": 0.01}),
    ("momentum", {"beta": 0.8}),
    ("rmsprop", {"rho": 0.9}),
    ("lion", {"weight_decay": 0.1}),
    ("adafactor", {"weight_decay": 0.01}),
])
def test_optimizer_trajectory_matches_jax(name, kwargs):
    """Five steps of update + apply_updates from one start, with the
    adaptation diagonal and the fused product checked at every state. The
    2-D leaf ``w`` and the 1-D leaf ``b`` give Adafactor's two second-moment
    forms, ``{"r", "c"}`` and ``{"v"}``."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jopt = joptim.get_optimizer(name, 0.05, **kwargs)
    topt = optim.get_optimizer(name, 0.05, **kwargs)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        g_meta = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        jg, tg = jax.tree_util.tree_map(jnp.asarray, grads), tree.tree_map(torch.from_numpy, grads)
        ja = jopt.adaptation(jg, jst, jp)
        ta = topt.adaptation(tg, tst, tp)
        for k in params:
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), **ADAPT)
        if jopt.adapt_product is not None:
            jgm, tgm = (jax.tree_util.tree_map(jnp.asarray, g_meta),
                        tree.tree_map(torch.from_numpy, g_meta))
            jv, jss = jopt.adapt_product(jg, jst, jp, jgm)
            tv, tss = topt.adapt_product(tg, tst, tp, tgm)
            for k in params:
                np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), **ADAPT)
            np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5, atol=1e-10)
        jupd, jst = jopt.update(jg, jst, jp)
        tupd, tst = topt.update(tg, tst, tp)
        jp, tp = joptim.apply_updates(jp, jupd), optim.apply_updates(tp, tupd)
        assert int(tst.count) == int(jst.count) == step + 1
        assert tst.count.dtype == torch.int32
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TRAJ)
        for jt, tt in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
            assert (jt is None) == (tt is None)
            if jt is not None:
                t_leaves, t_paths = tree.tree_flatten(tt)
                j_leaves, j_paths = tree.tree_flatten(jax.tree_util.tree_map(np.asarray, jt))
                assert t_paths == j_paths
                for a, b in zip(t_leaves, j_leaves):
                    np.testing.assert_allclose(a.numpy(), b, **TRAJ)


def test_adam_bias_corrections_finite_in_bf16():
    """1 - 0.999^t rounds to 0 in bf16: the update and the adaptation form
    the bias corrections in at least f32 (tests/test_optim.py)."""
    opt = optim.adam(1e-2)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.tensor([0.0, 0.1, -0.2, 0.05], dtype=torch.bfloat16)}
    state = opt.init(params)
    upd, _ = opt.update(g, state, params)
    assert torch.all(torch.isfinite(upd["w"].float()))
    assert float(upd["w"][1].abs()) > 0
    diag = opt.adaptation(g, state, params)
    assert torch.all(torch.isfinite(diag["w"].float()))


@pytest.mark.parametrize("make", [
    lambda s: s.constant(0.3),
    lambda s: s.cosine_decay(1.0, 50, alpha=0.1),
    lambda s: s.linear_warmup_cosine(1.0, warmup_steps=10, decay_steps=100),
    lambda s: s.linear_decay_with_warmup(2e-5, total_steps=100, warmup_proportion=0.6),
])
def test_schedules_match_jax(make):
    jsched, tsched = make(joptim.schedules), make(optim.schedules)
    for step in (0, 1, 9, 10, 37, 60, 100, 140):
        got = tsched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jsched(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=1e-12)


def test_unknown_optimizers_are_refused():
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        optim.get_optimizer("adagrad", 1e-3)
    assert sorted(optim.optimizers._FACTORIES) == sorted(joptim.optimizers._FACTORIES)


def test_plain_version_in_pieces_is_bitwise_the_whole(monkeypatch):
    """Above PLAIN_CHUNK elements the plain version works piece by piece
    (an expert stack's temporaries): the same values, bitwise."""
    from repro_torch.kernels import adam_adapt as aa

    rng = np.random.default_rng(4)
    g, m, gm = (torch.from_numpy(rng.standard_normal(2500).astype(np.float32) * 1e-2)
                for _ in range(3))
    v = torch.from_numpy(rng.standard_normal(2500).astype(np.float32)) ** 2 * 1e-4
    kw = dict(t=3, b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)
    whole, whole_ss = aa.adam_adapt_plain(g, m, v, gm, **kw)
    monkeypatch.setattr(aa, "PLAIN_CHUNK", 1000)
    pieces, pieces_ss = aa.adam_adapt_plain(g, m, v, gm, **kw)
    assert torch.equal(pieces, whole) and torch.equal(pieces_ss, whole_ss)
