"""The port's scale layer (``repro_torch.scale``: precision policies, the
loss-scale automaton, microbatch accumulation, the memory planner, and
their hooks in the engine, the SAMA method, ``MetaLearner``, ``convert``,
``checkpoint`` and the train CLI) against the JAX package's
``repro.scale``, on the same seeded numpy inputs.

Tolerances. f32 losses 1e-5 relative (``LOSS``), gradients 1e-4 relative
with 1e-6 absolute (the same ops summed in another order); bf16 and f16
compute 2e-2 relative, with 2e-2 of the leaf's largest entry absolute (the
flash tolerance for bf16, tests/test_flash_attention.py: the two packages
round to the low-precision type at other places). A SAMA meta step under
microbatching is held port against JAX at equal M with
tests/test_torch_sama.py's ``LOSS``, ``HYPER`` and update-share bounds, not
against the M = 1 step: the reference's own f32-exactness property fails
on the reference (ROADMAP queue 3). The automaton, the skip gate and the
planner's choice are held bitwise; an f16 state crosses between the
packages bitwise.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import checkpoint as jcheckpoint  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import scale as jscale  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import init_state as jinit_state  # noqa: E402
from repro.core import make_meta_step as jmake_meta_step  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.core.engine import guarded_meta_update as jguarded  # noqa: E402
from repro.scale import plan as jplan  # noqa: E402
from repro_torch import api, checkpoint, convert, optim, scale, tree  # noqa: E402
from repro_torch.core import EngineConfig, init_state, make_meta_step, problems  # noqa: E402
from repro_torch.core.engine import guarded_meta_update  # noqa: E402
from repro_torch.scale import plan as tplan  # noqa: E402

from test_torch_sama import (LOSS, _bert_batches, _mini_bert, _np_tree,  # noqa: E402
                             _quickstart_data, _run_pair)

GRAD = dict(rtol=1e-4, atol=1e-6)
LOW_RTOL = 2e-2

D, H, C = 6, 16, 3


# ---------------------------------------------------------------------------
# the tiny classifier bilevel problem of tests/test_scale.py, in both packages
# ---------------------------------------------------------------------------


def _japply(theta, x):
    return jnp.tanh(x @ theta["w1"]) @ theta["w2"]


def _tapply(theta, x):
    return torch.tanh(x @ theta["w1"]) @ theta["w2"]


def _problem(seed=0):
    """(jspec, tspec, theta numpy, lam numpy (JAX's draw))."""
    rng = np.random.default_rng(seed)
    theta = {"w1": (0.3 * rng.standard_normal((D, H))).astype(np.float32),
             "w2": (0.3 * rng.standard_normal((H, C))).astype(np.float32)}
    lam = _np_tree(jproblems.init_data_optimization_lam(jax.random.PRNGKey(seed + 2),
                                                        reweight=True))
    jspec = jproblems.make_data_optimization_spec(jproblems.softmax_per_example(_japply),
                                                  reweight=True)
    tspec = problems.make_data_optimization_spec(problems.softmax_per_example(_tapply),
                                                 reweight=True)
    return jspec, tspec, theta, lam


def _batches(seed, k, b, mb):
    rng = np.random.default_rng(seed + 3)
    bb = {"x": rng.standard_normal((k, b, D)).astype(np.float32),
          "y": rng.integers(0, C, (k, b)).astype(np.int32)}
    meta = {"x": rng.standard_normal((mb, D)).astype(np.float32),
            "y": rng.integers(0, C, mb).astype(np.int32)}
    return bb, meta


def _j(tree_):
    return jax.tree_util.tree_map(jnp.asarray, tree_)


def _t(tree_):
    return convert.params_from_jax(tree_, device="cpu")


def _assert_tree_close(got, want, **tol):
    g_leaves, g_paths = tree.tree_flatten(convert.params_to_numpy(got))
    w_leaves, w_paths = tree.tree_flatten(_np_tree(want))
    assert g_paths == w_paths
    for path, a, b in zip(g_paths, g_leaves, w_leaves):
        np.testing.assert_allclose(a, b, err_msg="/".join(path), **tol)


def _assert_low(got, want):
    """bf16/f16: within 2e-2 relative, 2e-2 of the leaf's largest entry absolute."""
    g_leaves = tree.tree_leaves(convert.params_to_numpy(got))
    for a, b in zip(g_leaves, tree.tree_leaves(_np_tree(want))):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=LOW_RTOL, atol=LOW_RTOL * np.abs(b).max())


# ---------------------------------------------------------------------------
# policies and the cast boundary
# ---------------------------------------------------------------------------


def test_policies_table_matches_jax():
    assert sorted(scale.POLICIES) == sorted(jscale.POLICIES)
    for name, pol in scale.POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(jscale.POLICIES[name])
        assert pol.is_identity == jscale.POLICIES[name].is_identity
        assert pol.dynamic_scaling == jscale.POLICIES[name].dynamic_scaling
        assert pol.compute_torch == getattr(torch, jscale.POLICIES[name].compute_jnp.name)
    # f16's scale starts and is capped at 2^15: float16(2^16) is inf
    assert scale.POLICIES["f16"].loss_scale == scale.POLICIES["f16"].max_loss_scale == 2.0 ** 15
    assert float(np.finfo(np.float16).max) < 2.0 ** 16
    for bad, err in (("f8", ValueError), (3, TypeError)):
        with pytest.raises(err):
            scale.resolve_policy(bad)
        with pytest.raises(err):
            jscale.resolve_policy(bad)
    with pytest.raises(ValueError, match=">= 1"):
        scale.ScaleConfig(microbatch=0)
    assert scale.ScaleConfig().is_identity and not scale.ScaleConfig(microbatch=2).is_identity


def test_cast_floats_leaves_integers_alone():
    arrays = {"x": np.ones((2, 3), np.float32), "y": np.arange(2, dtype=np.int32),
              "m": np.array([True, False])}
    for name in ("bfloat16", "float16"):
        given = tree.tree_map(torch.from_numpy, arrays)
        got = scale.cast_floats(given, getattr(torch, name))
        want = jscale.cast_floats(_j(arrays), jnp.dtype(name))
        for key in arrays:
            assert str(got[key].dtype).replace("torch.", "") == want[key].dtype.name
        assert got["y"] is given["y"] and got["m"] is given["m"]


@pytest.mark.parametrize("policy", ["f32", "bf16", "f16"])
def test_apply_to_spec_losses_and_gradients_match_jax(policy):
    """The cast boundary: losses f32, gradients in theta's f32 master dtype,
    within 2e-2 of JAX under bf16 and f16; under f32 the spec is returned
    as it is and equals the unwrapped one exactly."""
    jspec, tspec, theta, lam = _problem(1)
    bb, _ = _batches(1, 1, 16, 8)
    batch = {k: v[0] for k, v in bb.items()}
    jw = jscale.apply_to_spec(jspec, jscale.resolve_policy(policy))
    tw = scale.apply_to_spec(tspec, scale.resolve_policy(policy))
    from repro_torch.core.sama import value_and_grad

    jloss, jg = jax.value_and_grad(jw.base_scalar)(_j(theta), _j(lam), _j(batch))
    tloss, tg = value_and_grad(tw.base_scalar, 0)(_t(theta), _t(lam), _t(batch))
    assert tloss.dtype == torch.float32 and jloss.dtype == jnp.float32
    assert all(x.dtype == torch.float32 for x in tree.tree_leaves(tg))
    if policy == "f32":
        assert tw is tspec
        raw_loss, raw_g = value_and_grad(tspec.base_scalar, 0)(_t(theta), _t(lam), _t(batch))
        assert torch.equal(tloss, raw_loss)
        for a, b in zip(tree.tree_leaves(tg), tree.tree_leaves(raw_g)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS)
        _assert_tree_close(tg, jg, **GRAD)
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOW_RTOL)
        _assert_low(tg, jg)
    # the meta loss too, and lam is never cast
    seen = []
    spec_lam = problems.make_data_optimization_spec(problems.softmax_per_example(_tapply))
    orig = spec_lam.base_loss

    def spy(th, la, b):
        seen.append(tree.tree_leaves(la)[0].dtype)
        return orig(th, la, b)

    scale.apply_to_spec(dataclasses.replace(spec_lam, base_loss=spy),
                        scale.resolve_policy(policy)).base_scalar(_t(theta), _t(lam), _t(batch))
    assert seen == [torch.float32]


# ---------------------------------------------------------------------------
# the loss-scale automaton
# ---------------------------------------------------------------------------


def test_automaton_matches_jax_bitwise():
    """update_scale and backoff_on over a scripted finite/non-finite
    sequence, with growth every 3 steps, the cap and the floor reached:
    (scale, good_steps) bitwise equal after every event."""
    jpol = dataclasses.replace(jscale.resolve_policy("f16"), growth_interval=3,
                               loss_scale=4.0, min_loss_scale=1.0, max_loss_scale=16.0)
    tpol = scale.PrecisionPolicy(**dataclasses.asdict(jpol))
    js, ts = jscale.init_scale_state(jpol), scale.init_scale_state(tpol, device="cpu")
    script = [(u, f) for u, f in zip(
        "uuuuuuuuuuubuuubbuuuuuuuuu",
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1])]
    seen = set()
    for kind, finite in script:
        jf, tf = jnp.asarray(bool(finite)), torch.tensor(bool(finite))
        if kind == "u":
            js, ts = jscale.update_scale(js, jf, jpol), scale.update_scale(ts, tf, tpol)
        else:
            js, ts = jscale.backoff_on(js, jf, jpol), scale.backoff_on(ts, tf, tpol)
        assert ts.scale.dtype == torch.float32 and ts.good_steps.dtype == torch.int32
        assert float(ts.scale) == float(js.scale) and int(ts.good_steps) == int(js.good_steps)
        seen.add(float(ts.scale))
    assert {1.0, 16.0} <= seen  # the floor and the cap both hit


def test_all_finite_and_select_tree():
    t = {"a": torch.ones(3), "i": torch.arange(2)}
    assert bool(scale.all_finite(t))
    t["b"] = torch.tensor([1.0, float("nan")])
    assert not bool(scale.all_finite(t))
    st = optim.OptState(count=torch.tensor(1, dtype=torch.int32), mu={"w": torch.ones(2)})
    st0 = optim.OptState(count=torch.tensor(0, dtype=torch.int32), mu={"w": torch.zeros(2)})
    picked = scale.select_tree(torch.tensor(False), st, st0)
    assert int(picked.count) == 0 and torch.equal(picked.mu["w"], torch.zeros(2))
    assert picked.nu is None


# ---------------------------------------------------------------------------
# microbatch accumulation
# ---------------------------------------------------------------------------


def test_split_batch_and_accumulate_mean_match_jax():
    x = np.random.default_rng(0).standard_normal((12, 7)).astype(np.float32)
    s = scale.split_batch({"x": torch.from_numpy(x), "y": torch.zeros(12, dtype=torch.int32)}, 4)
    assert tuple(s["x"].shape) == (4, 3, 7) and tuple(s["y"].shape) == (4, 3)
    for m, err in ((5, "not divisible"), (0, ">= 1")):
        with pytest.raises(ValueError, match=err):
            scale.split_batch({"x": torch.from_numpy(x)}, m)
        with pytest.raises(ValueError, match=err):
            jscale.split_batch({"x": jnp.asarray(x)}, m)
    got = scale.accumulate_mean(lambda mb: {"m": mb.mean(0)}, scale.split_batch(
        torch.from_numpy(x), 4), 4, torch.float32)
    want = jscale.accumulate_mean(lambda mb: {"m": jnp.mean(mb, 0)}, jscale.split_batch(
        jnp.asarray(x), 4), 4, jnp.float32)
    np.testing.assert_allclose(got["m"].numpy(), np.asarray(want["m"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss_scale", [None, 1024.0])
@pytest.mark.parametrize("m", [2, 4])
def test_microbatch_value_and_grad_matches_jax(m, loss_scale):
    jspec, tspec, theta, lam = _problem(2)
    bb, _ = _batches(2, 1, 16, 8)
    batch = {k: v[0] for k, v in bb.items()}
    js = ts = None
    if loss_scale is not None:
        js = jscale.LossScaleState(scale=jnp.asarray(loss_scale, jnp.float32),
                                   good_steps=jnp.zeros([], jnp.int32))
        ts = scale.LossScaleState(scale=torch.tensor(loss_scale),
                                  good_steps=torch.zeros((), dtype=torch.int32))
    jloss, jg = jscale.microbatch_value_and_grad(jspec.base_scalar, _j(theta), _j(lam),
                                                 _j(batch), m, jnp.float32, scale=js)
    tloss, tg = scale.microbatch_value_and_grad(tspec.base_scalar, _t(theta), _t(lam),
                                                _t(batch), m, torch.float32, scale=ts)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS)
    _assert_tree_close(tg, jg, **GRAD)


def _jax_learner(jspec, theta, lam, *, scale_cfg, method="sama", unroll=2, **kw):
    jl = japi.MetaLearner(jspec, base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2,
                          method=method, unroll_steps=unroll, scale=scale_cfg, **kw)
    jl.init(_j(theta), _j(lam))
    return jl


@pytest.mark.parametrize("m", [2, 4])
def test_sama_meta_steps_at_equal_m_match_jax(m):
    """The quickstart problem, three meta steps, port against JAX at the
    same M (``SAMAMethod.micro_local_terms`` in both)."""
    d, batches = _quickstart_data()
    kw = dict(base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2, method="sama",
              unroll_steps=2)
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    tspec = problems.make_data_optimization_spec(
        problems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]), reweight=True)
    jl = japi.MetaLearner(jspec, scale=jscale.ScaleConfig(microbatch=m), **kw)
    jl.init({"w": jnp.zeros((d, 2)), "b": jnp.zeros((2,))},
            jproblems.init_data_optimization_lam(jax.random.PRNGKey(3), reweight=True))
    tl = api.MetaLearner(tspec, scale=scale.ScaleConfig(microbatch=m), **kw)
    _run_pair(jl, tl, batches, steps=3)


def test_mini_bert_meta_step_at_m2_matches_jax(bert_pair):
    jm, jparams = bert_pair
    from repro_torch import configs
    from repro_torch.models import Model

    tm = Model(_mini_bert(configs, True), device="cpu")
    kw = dict(base_opt="adam", base_lr=1e-3, meta_opt="adam", meta_lr=1e-3, method="sama",
              unroll_steps=2)
    jl = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.classifier_per_example),
                          scale=jscale.ScaleConfig(microbatch=2), **kw)
    jl.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(1)))
    tl = api.MetaLearner(problems.make_data_optimization_spec(tm.classifier_per_example),
                         scale=scale.ScaleConfig(microbatch=2), **kw)
    _run_pair(jl, tl, _bert_batches(7), steps=1)


@pytest.fixture(scope="module")
def bert_pair():
    from repro import configs as jconfigs
    from repro.models import Model as JaxModel

    jm = JaxModel(_mini_bert(jconfigs, False))
    return jm, jm.init(jax.random.PRNGKey(0))


def test_virtual_shard_fallback_matches_jax():
    """t1t2 has no micro hook: the virtual-shard mean. With tiled identical
    microbatches it equals the one-microbatch step, in both packages, and
    the two packages agree at M = 4."""
    jspec, tspec, theta, lam = _problem(3)
    k, b, m = 2, 4, 4
    bb1, mb1 = _batches(3, k, b, b)
    bb_t = {"x": np.tile(bb1["x"], (1, m, 1)), "y": np.tile(bb1["y"], (1, m))}
    mb_t = {"x": np.tile(mb1["x"], (m, 1)), "y": np.tile(mb1["y"], (m,))}

    def run_t(bb, mb, mm):
        cfg = EngineConfig(method="t1t2", unroll_steps=k, scale=scale.ScaleConfig(microbatch=mm))
        bo, mo = optim.adam(1e-2), optim.adam(1e-2)
        state = init_state(_t(theta), _t(lam), bo, mo, scale=cfg.scale)
        return make_meta_step(tspec, bo, mo, cfg)(state, _t(bb), _t(mb))

    cfg = JEngineConfig(method="t1t2", unroll_steps=k, scale=jscale.ScaleConfig(microbatch=m))
    bo, mo = joptim.adam(1e-2), joptim.adam(1e-2)
    js, jmetrics = jmake_meta_step(jspec, bo, mo, cfg)(
        jinit_state(_j(theta), _j(lam), bo, mo, scale=cfg.scale), _j(bb_t), _j(mb_t))
    ref, _ = run_t(bb1, mb1, 1)
    got, tmetrics = run_t(bb_t, mb_t, m)
    _assert_tree_close(got.lam, ref.lam, rtol=1e-5, atol=1e-7)
    _assert_tree_close(got.lam, js.lam, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tmetrics["meta_loss"]), float(jmetrics["meta_loss"]), **LOSS)


@pytest.mark.parametrize("method", ["cg", "neumann", "iterdiff"])
def test_nonlinear_methods_refuse_microbatching_with_the_reference_message(method):
    jspec, tspec, theta, lam = _problem()
    bb, mb = _batches(0, 2, 8, 8)
    bo, mo = optim.adam(1e-2), optim.adam(1e-2)
    cfg = EngineConfig(method=method, unroll_steps=2, scale=scale.ScaleConfig(microbatch=2))
    with pytest.raises(ValueError, match="nonlinear reduce") as got:
        make_meta_step(tspec, bo, mo, cfg)(init_state(_t(theta), _t(lam), bo, mo), _t(bb),
                                           _t(mb))
    jbo, jmo = joptim.adam(1e-2), joptim.adam(1e-2)
    jcfg = JEngineConfig(method=method, unroll_steps=2, scale=jscale.ScaleConfig(microbatch=2))
    with pytest.raises(ValueError) as want:
        jmake_meta_step(jspec, jbo, jmo, jcfg)(jinit_state(_j(theta), _j(lam), jbo, jmo),
                                               _j(bb), _j(mb))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the f16 skip and the meta gate
# ---------------------------------------------------------------------------


def _f16_overflow_policy(pkg):
    base = pkg.resolve_policy("f16")
    return dataclasses.replace(base, loss_scale=float(2 ** 30), min_loss_scale=1.0,
                               max_loss_scale=float(2 ** 31))


def test_f16_nonfinite_step_skips_and_backs_off_as_jax():
    """A scale far above f16's range makes the scaled gradients inf: the
    base step is skipped (theta, moments and count unchanged), the scale
    halves, the meta path overflows too and the gate halves it again, as
    in JAX (2^30 -> 2^28)."""
    jspec, tspec, theta, lam = _problem()
    bb, mb = _batches(0, 1, 8, 8)
    jbo, jmo = joptim.adam(1e-2), joptim.adam(1e-2)
    jcfg = JEngineConfig(method="sama", unroll_steps=1,
                         scale=jscale.ScaleConfig(policy=_f16_overflow_policy(jscale)))
    jstate = jinit_state(_j(theta), _j(lam), jbo, jmo, scale=jcfg.scale)
    jnew, jm = jmake_meta_step(jspec, jbo, jmo, jcfg)(jstate, _j(bb), _j(mb))

    bo, mo = optim.adam(1e-2), optim.adam(1e-2)
    cfg = EngineConfig(method="sama", unroll_steps=1,
                       scale=scale.ScaleConfig(policy=_f16_overflow_policy(scale)))
    state = convert.state_from_jax(_np_tree(jstate), device="cpu")
    new, m = make_meta_step(tspec, bo, mo, cfg)(state, _t(bb), _t(mb))
    assert float(new.scale.scale) == float(jnew.scale.scale) == 2.0 ** 28
    assert int(new.scale.good_steps) == int(jnew.scale.good_steps) == 0
    names, before = tree.flatten_with_keys(convert.state_to_numpy(state))
    _, after = tree.flatten_with_keys(convert.state_to_numpy(new))
    for name, a, b in zip(names, after, before):
        if name.startswith((".theta", ".lam", ".base_opt_state", ".meta_opt_state")):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(m["meta_skipped"]) == float(jm["meta_skipped"]) == 1.0
    assert float(m["loss_scale"]) == float(jm["loss_scale"])


def test_f16_policy_steps_and_scale_state_advance_as_jax():
    """Two finite base steps: good_steps 2, lam moves, the metrics carry
    loss_scale and meta_skipped 0; losses within the low-precision
    tolerance of JAX."""
    jspec, tspec, theta, lam = _problem()
    bb, mb = _batches(0, 2, 8, 8)
    jl = _jax_learner(jspec, theta, lam, scale_cfg=jscale.ScaleConfig(policy="f16"))
    tl = api.MetaLearner(tspec, base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2,
                         method="sama", unroll_steps=2, scale=scale.ScaleConfig(policy="f16"))
    tl.init(_t(theta), _t(lam))
    assert tl.state.scale is not None and float(tl.state.scale.scale) == 2.0 ** 15
    jm, tm = jl.step(_j(bb), _j(mb)), tl.step(_t(bb), _t(mb))
    assert sorted(tm) == sorted(jm)
    assert int(tl.state.scale.good_steps) == int(jl.state.scale.good_steps) == 2
    assert float(tm["meta_skipped"]) == float(jm["meta_skipped"]) == 0.0
    # hypergrad_norm and eps carry the unscaling of g_meta (eps = alpha /
    # ||v||) and of the central difference: a missing one is a 2^15 factor
    for key in ("base_loss", "meta_loss", "hypergrad_norm", "eps"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOW_RTOL)
    _assert_low(tl.state.lam, jl.state.lam)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree.tree_leaves(tl.state.lam), tree.tree_leaves(_t(lam))))
    assert moved > 0


def _assert_bitwise(got, want):
    g_names, g_leaves = tree.flatten_with_keys(got)
    w_names, w_leaves = tree.flatten_with_keys(want)
    assert g_names == w_names
    for name, a, b in zip(g_names, g_leaves, w_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("loss_scale", [2.0 ** 10, 2.0 ** 15])
def test_power_of_two_loss_scale_is_exact_under_f32_compute(loss_scale):
    """In f32 a power-of-two scale commutes with every rounding of the
    backward pass, so the scaled meta pass, both scaled central-difference
    passes and their unscaling give the unscaled results bitwise:
    ``perturbation_direction``, ``central_difference_hypergrad`` and
    ``SAMAMethod.micro_local_terms`` at M = 2. A dropped unscale is a
    factor of the scale here, which the low-precision comparisons with
    JAX cannot see (eps = alpha / ||v|| and Adam's meta update hardly move
    under a constant factor)."""
    from repro_torch.core import sama as tsama
    from repro_torch.core.methods import MethodContext, SAMAMethod

    _, tspec, theta, lam = _problem(5)
    bb, mb = _batches(5, 2, 8, 8)
    th, la, bb, mb = _t(theta), _t(lam), _t(bb), _t(mb)
    last = {k: v[-1] for k, v in bb.items()}
    bo = optim.adam(1e-2)
    _, g_base = tsama.value_and_grad(tspec.base_scalar, 0)(th, la, last)
    st = bo.init(th)
    cfg = tsama.SAMAConfig()

    def both(fn):
        return fn(None), fn(torch.tensor(loss_scale))

    plain, scaled = both(lambda s: tsama.perturbation_direction(
        tspec, th, la, mb, base_opt=bo, base_opt_state=st, g_base=g_base, cfg=cfg,
        loss_scale=s))
    _assert_bitwise(scaled, plain)
    _, v, v_sumsq = plain
    plain, scaled = both(lambda s: tsama.central_difference_hypergrad(
        tspec, th, la, last, v, cfg=cfg, v_sumsq=v_sumsq, loss_scale=s))
    _assert_bitwise(scaled, plain)
    ctx = MethodContext(base_opt=bo, theta0=th, theta=th, lam=la, g_base=g_base,
                        base_opt_state=st, base_batches=bb, last_batch=last, meta_batch=mb)
    plain, scaled = both(lambda s: SAMAMethod(cfg=cfg).micro_local_terms(
        tspec, dataclasses.replace(ctx, loss_scale=s), 2, torch.float32))
    _assert_bitwise(scaled, plain)


def test_f16_policy_needs_a_seeded_scale_state():
    _, tspec, theta, lam = _problem()
    bb, mb = _batches(0, 2, 8, 8)
    bo, mo = optim.adam(1e-2), optim.adam(1e-2)
    cfg = EngineConfig(method="sama", unroll_steps=2, scale=scale.ScaleConfig(policy="f16"))
    with pytest.raises(ValueError, match="LossScaleState"):
        make_meta_step(tspec, bo, mo, cfg)(init_state(_t(theta), _t(lam), bo, mo), _t(bb),
                                           _t(mb))


@pytest.mark.parametrize("case", ["inf_hyper", "base_skipped", "finite"])
def test_guarded_meta_update_gate_matches_jax(case):
    """The gate: a non-finite hypergradient, or an unroll where every base
    step skipped (base_ok False), keeps lam, the meta moments and theta;
    the verdict matches JAX's, and backoff_on halves on it."""
    _, _, theta, lam = _problem()
    fill = np.inf if case == "inf_hyper" else 0.5
    hyper = jax.tree_util.tree_map(lambda a: np.full_like(a, fill), lam)
    theta_post = {k: v + 1.0 for k, v in theta.items()}
    base_ok = case != "base_skipped"
    jmo = joptim.adam(1e-2)
    jstate = jinit_state(_j(theta), _j(lam), joptim.adam(1e-2), jmo,
                         scale=jscale.ScaleConfig(policy="f16"))
    jlam, jms, jth, jok = jguarded(jmo, _j(hyper), _j(theta_post), jstate, theta_pre=_j(theta),
                                   guard=True, base_ok=jnp.asarray(base_ok))
    mo = optim.adam(1e-2)
    state = convert.state_from_jax(_np_tree(jstate), device="cpu")
    tlam, tms, tth, tok = guarded_meta_update(mo, _t(hyper), _t(theta_post), state,
                                              theta_pre=_t(theta), guard=True,
                                              base_ok=torch.tensor(base_ok))
    assert bool(tok) == bool(jok) == (case == "finite")
    for got, want in ((tlam, jlam), (tth, jth)):
        _assert_tree_close(got, want, rtol=0, atol=0)
    names, got_ms = tree.flatten_with_keys(convert.params_to_numpy(tms._asdict()))
    want_ms = tree.flatten_with_keys(_np_tree(jms._asdict()))[1]
    for name, a, b in zip(names, got_ms, want_ms):
        np.testing.assert_array_equal(a, b, err_msg=name)
    backed = scale.backoff_on(state.scale, tok, scale.resolve_policy("f16"))
    jbacked = jscale.backoff_on(jstate.scale, jok, jscale.resolve_policy("f16"))
    assert float(backed.scale) == float(jbacked.scale)
    lam_u, _, _, none = guarded_meta_update(mo, _t(hyper), _t(theta_post), state,
                                            theta_pre=_t(theta), guard=False)
    assert none is None


# ---------------------------------------------------------------------------
# state crossing: convert and checkpoint, f16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f16_pair():
    """A JAX learner under the f16 policy after two meta steps, and a port
    learner of the same problem (for its template state)."""
    jspec, tspec, theta, lam = _problem(4)
    jl = _jax_learner(jspec, theta, lam, scale_cfg=jscale.ScaleConfig(policy="f16"))
    for i in range(2):
        jl.step(*(_j(x) for x in _batches(10 + i, 2, 8, 8)))
    tl = api.MetaLearner(tspec, base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2,
                         method="sama", unroll_steps=2, scale=scale.ScaleConfig(policy="f16"))
    tl.init(_t(theta), _t(lam))
    return jl, tl


def _assert_same_leaves(tstate, jstate):
    jflat = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    names, leaves = tree.flatten_with_keys(convert.state_to_numpy(tstate))
    assert names == [jax.tree_util.keystr(p) for p, _ in jflat]
    assert names[-2:] == [".scale.scale", ".scale.good_steps"]
    for name, got, (_, want) in zip(names, leaves, jflat):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_f16_state_crosses_convert_bitwise(f16_pair):
    jl, _ = f16_pair
    tstate = convert.state_from_jax(_np_tree(jl.state), device="cpu")
    assert isinstance(tstate.scale, scale.LossScaleState)
    _assert_same_leaves(tstate, jl.state)


def test_f16_checkpoints_cross_both_ways_bitwise(f16_pair, tmp_path):
    jl, tl = f16_pair
    jpath = str(tmp_path / "from_jax")
    jcheckpoint.save(jpath, jl.state, step=int(jl.state.step))
    restored, _ = checkpoint.restore(jpath, tl.state)
    _assert_same_leaves(restored, jl.state)

    tl.state = restored
    tpath = tl.save(str(tmp_path / "from_port"))
    back, _ = jcheckpoint.restore(tpath, jl.state)
    _assert_same_leaves(restored, back)
    # and a loaded learner holds the scale state
    tl2 = api.MetaLearner(tl.spec, base_opt="adam", base_lr=1e-2, meta_opt="adam", meta_lr=1e-2,
                          method="sama", unroll_steps=2, scale=scale.ScaleConfig(policy="f16"))
    tl2.init(*(tree.tree_map(torch.zeros_like, x) for x in (tl.state.theta, tl.state.lam)))
    tl2.load(tpath)
    assert float(tl2.state.scale.scale) == float(jl.state.scale.scale)


def test_unscaled_state_keeps_its_layout():
    """f32 and bf16 states carry no scale leaves: the pre-scale layout."""
    jspec, tspec, theta, lam = _problem()
    for pol in ("f32", "bf16"):
        tl = api.MetaLearner(tspec, scale=scale.ScaleConfig(policy=pol))
        tl.init(_t(theta), _t(lam))
        assert tl.state.scale is None
        names, _ = tree.flatten_with_keys(tl.state)
        assert not any(n.startswith(".scale") for n in names)
        jl = _jax_learner(jspec, theta, lam, scale_cfg=jscale.ScaleConfig(policy=pol))
        assert len(names) == len(jax.tree_util.tree_leaves(jl.state))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _planner_args(pkg_side, batch=16, meta=8, unroll=2):
    jspec, tspec, theta, lam = _problem()
    bb, mb = _batches(0, unroll, batch, meta)
    if pkg_side == "jax":
        bo, mo = joptim.adam(1e-2), joptim.adam(1e-2)
        cfg = JEngineConfig(method="sama", unroll_steps=unroll)
        return jspec, bo, mo, cfg, jinit_state(_j(theta), _j(lam), bo, mo), _j(bb), _j(mb)
    bo, mo = optim.adam(1e-2), optim.adam(1e-2)
    cfg = EngineConfig(method="sama", unroll_steps=unroll)
    return tspec, bo, mo, cfg, init_state(_t(theta), _t(lam), bo, mo), _t(bb), _t(mb)


@pytest.mark.parametrize("batch,meta,cap", [(16, 8, None), (16, 8, 2), (12, 18, None),
                                            (7, 5, None)])
def test_candidate_microbatches_match_jax(batch, meta, cap):
    *_, jbb, jmb = _planner_args("jax", batch, meta)
    *_, tbb, tmb = _planner_args("torch", batch, meta)
    assert scale.candidate_microbatches(tbb, tmb, cap) == jscale.candidate_microbatches(
        jbb, jmb, cap)
    # per data-parallel shard: the candidates of the JAX package, or its refusal
    try:
        want = jscale.candidate_microbatches(jbb, jmb, cap, shard_divisor=2)
    except ValueError:
        with pytest.raises(ValueError, match="do not shard evenly"):
            scale.candidate_microbatches(tbb, tmb, cap, shard_divisor=2)
    else:
        assert scale.candidate_microbatches(tbb, tmb, cap, shard_divisor=2) == want


@pytest.mark.parametrize("budget", [1, 450, 700, 1000, 10 ** 6])
def test_plan_microbatch_choice_on_a_scripted_peak_table_matches_jax(budget, monkeypatch):
    """Both planners bisect the same candidates (1, 2, 4, 8) over one
    scripted peak table: the same choice, fit, peak and audit trail."""
    table = {1: 1000, 2: 700, 4: 450, 8: 300}
    monkeypatch.setattr(jplan, "measure_peak",
                        lambda *a, engine_cfg=None, **k: (table[a[3].scale.microbatch], "table"))
    monkeypatch.setattr(tplan, "measure_peak",
                        lambda *a, **k: (table[a[3].scale.microbatch], "table"))
    jp = jscale.plan_microbatch(*_planner_args("jax"), hbm_budget=budget)
    tp = scale.plan_microbatch(*_planner_args("torch"), hbm_budget=budget)
    assert (tp.microbatch, tp.fits, tp.peak_bytes, tp.candidates, tp.hbm_budget) == (
        jp.microbatch, jp.fits, jp.peak_bytes, jp.candidates, jp.hbm_budget)
    assert tp.scale.microbatch == tp.microbatch
    peaks = [p for _, p in tp.candidates]
    assert peaks == sorted(peaks, reverse=True)
    with pytest.raises(ValueError, match="hbm_budget"):
        scale.plan_microbatch(*_planner_args("torch"), hbm_budget=0)


def test_plan_microbatch_on_the_cpu_estimate_is_monotone_and_fits():
    args = _planner_args("torch", batch=32, meta=16)
    hi = scale.plan_microbatch(*args, hbm_budget=10 ** 12)
    lo = scale.plan_microbatch(*args, hbm_budget=1)
    assert hi.microbatch == 1 and hi.fits and hi.source == "aval"
    assert not lo.fits and lo.microbatch == 16
    peak_1, peak_max = dict(hi.candidates)[1], dict(lo.candidates)[16]
    assert peak_max < peak_1
    mid = scale.plan_microbatch(*args, hbm_budget=(peak_1 + peak_max) // 2)
    assert mid.fits and 1 < mid.microbatch and mid.peak_bytes <= (peak_1 + peak_max) // 2
    for m, peak in mid.candidates:
        if m < mid.microbatch:
            assert peak > (peak_1 + peak_max) // 2


def test_measure_peak_reads_an_out_of_memory_candidate_as_not_fitting(monkeypatch):
    """On the card a candidate that raises torch.cuda.OutOfMemoryError is
    measured as None, which the bisection reads as above any budget; any
    other error propagates. (The card's calls are stubbed here.)"""
    ooms, calls = {1, 2}, []

    def fake_step_factory(spec, bo, mo, cfg):
        def step(state, bb, mb):
            calls.append(cfg.scale.microbatch)
            if cfg.scale.microbatch in ooms:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
            return state, {}
        return step

    from repro_torch.core import engine
    peaks = {4: 600, 8: 400}
    monkeypatch.setattr(tplan, "_on_card", lambda state: True)
    monkeypatch.setattr(engine, "make_meta_step", fake_step_factory)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: peaks[calls[-1]])
    plan = scale.plan_microbatch(*_planner_args("torch"), hbm_budget=500)
    assert plan.microbatch == 8 and plan.fits and plan.source == "cuda_max_allocated"
    assert dict(plan.candidates)[2] is None
    plan = scale.plan_microbatch(*_planner_args("torch"), hbm_budget=10 ** 6)
    assert plan.microbatch == 4 and dict(plan.candidates)[2] is None
    ooms.clear()
    monkeypatch.setattr(engine, "make_meta_step",
                        lambda *a: (lambda *b: (_ for _ in ()).throw(RuntimeError("other"))))
    with pytest.raises(RuntimeError, match="other"):
        scale.measure_peak(*_planner_args("torch"))


# ---------------------------------------------------------------------------
# the CLI flags and f16 in weighted_ce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--precision", "bf16", "--microbatch", "2"],
                                   ["--precision", "f16", "--microbatch", "2"],
                                   ["--hbm-budget-gb", "1e-6"]])
def test_train_cli_scale_flags_on_the_smoke_config(flags, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "bert-base", "--smoke", "--device", "cpu", "--steps", "2",
                "--log-every", "1", "--batch", "4", "--seq", "16", *flags])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    if "--hbm-budget-gb" in flags:
        plan = rows.pop(0)["planner"]
        # batch 4 / meta batch 2: candidates 1, 2; nothing fits 1 KB
        assert plan["microbatch"] == 2 and not plan["fits"] and plan["source"] == "aval"
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert np.isfinite(r["base_loss"]) and np.isfinite(r["meta_loss"])
        assert ("loss_scale" in r) == ("f16" in flags)


@pytest.mark.parametrize("v", [4096, 5000])
def test_weighted_ce_plain_route_takes_f16_logits_as_jax(v):
    """The plain forward and its gradient with f16 logits: f32 CE, f16
    dlogits (the logits' dtype, as src/repro/kernels/weighted_ce.py
    stores them), within the low-precision tolerance of the JAX kernel in
    interpret mode."""
    from repro.kernels import weighted_ce as jwce
    from repro_torch.kernels import weighted_ce

    rng = np.random.default_rng(v)
    logits = (3.0 * rng.standard_normal((7, v))).astype(np.float16)
    targets = rng.integers(0, v, 7).astype(np.int32)
    g = rng.standard_normal(7).astype(np.float32)
    jx = jnp.asarray(logits)
    kern, vjp = jax.vjp(lambda a: jwce.cross_entropy(a, jnp.asarray(targets), True), jx)
    (jgrad,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(logits).requires_grad_(True)
    ce = weighted_ce.cross_entropy(leaf, torch.from_numpy(targets))
    (ce * torch.from_numpy(g)).sum().backward()
    assert ce.dtype == torch.float32 and leaf.grad.dtype == torch.float16
    assert jgrad.dtype == jnp.float16
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(jgrad, np.float32),
                               rtol=LOW_RTOL, atol=1e-4)
    assert 2 == weighted_ce._DTYPE_CODES[torch.float16]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sliced", [((37, 5000), False), ((3, 40, 8192), True)])
def test_weighted_ce_f16_kernels_match_plain_on_the_card(shape, sliced):
    """The f16 instantiation on the card: ce and lse within 1e-5 (1 + |ref|)
    of the plain version in f32 on the same values, dlogits in f16 within
    2^-24 (the spacing of f16's subnormals) + (1e-5 + half an f16 ulp) |ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import dispatch, weighted_ce

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(sum(shape))
    x = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * 3).to(dev,
                                                                               torch.float16)
    x_in = x[:, :-1] if sliced else x
    v = shape[-1]
    t = torch.from_numpy(rng.integers(0, v, x_in.numel() // v).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(t.numel()).astype(np.float32)).to(dev)
    dispatch.reset_launches()
    ce, lse = weighted_ce._fwd_cuda(x_in, t)
    d = weighted_ce._bwd_cuda(x_in, t, lse, g)
    torch.cuda.synchronize()
    assert dispatch.launches(weighted_ce.FWD) == dispatch.launches(weighted_ce.BWD) == 1
    x32 = x_in.float().reshape(-1, v)
    ce_ref, lse_ref = weighted_ce.cross_entropy_fwd_plain(x32, t)
    assert ((ce - ce_ref).abs() <= 1e-5 * (1 + ce_ref.abs())).all()
    assert ((lse - lse_ref).abs() <= 1e-5 * (1 + lse_ref.abs())).all()
    d_ref = weighted_ce.cross_entropy_bwd_plain(x32, t, lse_ref, g)
    assert d.dtype == torch.float16
    rtol = 1e-5 + torch.finfo(torch.float16).eps / 2
    assert ((d.reshape(-1, v).float() - d_ref).abs() <= 2.0 ** -24 + rtol * d_ref.abs()).all()


def test_bench_scale_records_are_valid_in_both_packages(tmp_path, monkeypatch):
    """``perf/bench_scale.py`` at a smoke size on the CPU: one record per
    arm, its launches counted (none on the CPU), the arm in ``extra``, and
    a BENCH_torch_scale.json that the JAX package's loader accepts; an arm
    out of memory is recorded as such (stubbed here)."""
    from repro import perf as jperf
    from repro_torch import configs
    from repro_torch.perf import bench_scale

    cfg = configs.get_smoke_config("bert-base")
    records = bench_scale.run(cfg, device="cpu", arms=(("f32", 1), ("bf16", 2)),
                              **bench_scale.SMOKE_SIZES)
    assert [(r.extra["policy"], r.extra["microbatch"]) for r in records] == [("f32", 1),
                                                                            ("bf16", 2)]
    assert not any(r.extra["out_of_memory"] for r in records)
    path = bench_scale.write(str(tmp_path), records, 1.0)
    payload = jperf.load_bench(path)
    assert [r["name"] for r in payload["records"]] == ["scale_f32_m1", "scale_bf16_m2"]
    assert payload["rows"][1]["derived"]["microbatch"] == 2

    def profile(self, *a, **k):
        if self.cfg.scale.microbatch == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        return real(self, *a, **k)

    real = api.MetaLearner.profile
    monkeypatch.setattr(api.MetaLearner, "profile", profile)
    records = bench_scale.run(cfg, device="cpu", arms=(("bf16", 1), ("bf16", 2)),
                              **bench_scale.SMOKE_SIZES)
    assert [r.extra["out_of_memory"] for r in records] == [True, False]
    assert records[0].memory["per_device"]["source"] == "out_of_memory"
    path = bench_scale.write(str(tmp_path), records, 1.0)
    assert jperf.load_bench(path)["rows"][0]["derived"]["peak_mb"] is None


def test_tree_walks_release_spent_trees_without_the_cycle_collector():
    """The tree walks hold no reference cycle: a tensor whose last owner is
    a spent tree is freed at once, with the cycle collector off (a
    self-calling nested function kept it, and on the card parameter-sized
    trees, alive until a collection)."""
    import gc
    import weakref

    def freed(fn):
        t = torch.ones(3)
        ref = weakref.ref(t)
        fn({"a": {"b": t}})
        del t
        return ref() is None

    was = gc.isenabled()
    gc.disable()
    try:
        assert freed(lambda tr: tree.tree_map(lambda x: x + 1, tr))
        assert freed(lambda tr: tree.tree_map(lambda x: x + 1, (tr, [tr], None)))
        assert freed(lambda tr: tree.unflatten_like(tr, [torch.zeros(1)]))
        assert freed(lambda tr: scale.select_tree(torch.tensor(True), tr, tr))
        assert freed(lambda tr: scale.cast_floats(tr, torch.float16))
    finally:
        if was:
            gc.enable()
