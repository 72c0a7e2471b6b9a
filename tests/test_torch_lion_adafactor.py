"""The port's Lion and Adafactor adaptation products and optimizer states
against the JAX package's: the plain ``lion_adapt`` and ``adafactor_adapt``
(what CPU tensors take) against the Pallas kernels run in interpret mode
and against their ``ref`` twins, at aligned and ragged sizes; the
optimizers' adaptation diagonals against the surrogate each declares; the
CUDA wrappers' refusals; and an ``EngineState`` with Lion's ``mu`` and
Adafactor's nested ``nu`` dicts carried from JAX to the port and back.
The optimizer trajectories are in tests/test_torch_adam_adapt.py and the
quickstart meta steps with these bases in tests/test_torch_sama.py. The
CUDA kernels run only on a card (tests/test_torch_kernels_cuda.py).

Tolerances: out rtol 1e-5 / atol 1e-7 and sum of squares rtol 1e-4, as
``adam_adapt`` (tests/test_kernels.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert, optim, tree  # noqa: E402
from repro_torch.kernels import adafactor_adapt, dispatch, lion_adapt  # noqa: E402

SIZES = [128, 1000, 8 * 1024 + 5, 50_001]


def _arrays(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _close(got, got_ss, want, want_ss):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got_ss), float(want_ss), rtol=1e-4)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lr,b1,delta", [(1.0, 0.9, 1e-3), (3e-4, 0.95, 1e-2)])
def test_plain_lion_adapt_matches_jax_kernel_and_ref(n, lr, b1, delta):
    g, m, gm = _arrays(n, 3, n)
    m *= 1e-2  # |c| near delta for some coordinates: the surrogate's knee
    g *= 1e-2
    kw = dict(lr=lr, b1=b1, delta=delta)
    kern = jops.lion_adapt_product(*map(jnp.asarray, (g, m, gm)), backend="pallas-interpret",
                                   **kw)
    ref = jref.lion_adapt_product(*map(jnp.asarray, (g, m, gm)), **kw)
    got, got_ss = lion_adapt.lion_adapt(*map(torch.from_numpy, (g, m, gm)), **kw)
    assert got.dtype == torch.float32 and got.shape == (n,)
    for want, want_ss in (kern, ref):
        _close(got, got_ss, want, want_ss)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lr,eps", [(1.0, 1e-8), (1e-3, 1e-3)])
def test_plain_adafactor_adapt_matches_jax_kernel_and_ref(n, lr, eps):
    vhat, gm = _arrays(n, 2, n + 1)
    vhat = np.square(vhat) * 1e-4
    vhat[::97] = 0.0  # an unseen coordinate: diag lr / eps
    kern = jops.adafactor_adapt_product(*map(jnp.asarray, (vhat, gm)),
                                        backend="pallas-interpret", lr=lr, eps=eps)
    ref = jref.adafactor_adapt_product(*map(jnp.asarray, (vhat, gm)), lr=lr, eps=eps)
    got, got_ss = adafactor_adapt.adafactor_adapt(*map(torch.from_numpy, (vhat, gm)), lr=lr,
                                                  eps=eps)
    for want, want_ss in (kern, ref):
        _close(got, got_ss, want, want_ss)


def test_lion_adaptation_is_the_surrogate_derivative():
    """Lion's diagonal is d/dg of lr * c / (|c| + delta), c = b1 m + (1-b1) g:
    the smoothed sign's derivative, not the a.e.-zero one of sign. In f64,
    but for the f32 scalar the schedule forms lr (1 - b1) delta in: 1e-6."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float64) * 1e-2)
    m = torch.from_numpy(rng.standard_normal(64).astype(np.float64) * 1e-2)
    opt = optim.lion(0.1, b1=0.9, adapt_delta=1e-2)
    state = optim.OptState(count=torch.tensor(0, dtype=torch.int32), mu={"w": m})
    diag = opt.adaptation({"w": g}, state, {"w": g})["w"]

    def surrogate(gg):
        c = 0.9 * m + (1.0 - 0.9) * gg
        return 0.1 * c / (c.abs() + 1e-2)

    jac = torch.autograd.functional.jacobian(surrogate, g)
    torch.testing.assert_close(diag, torch.diagonal(jac), rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_versions_and_the_kernels_refuse_them(monkeypatch):
    g, m, gm = map(torch.from_numpy, _arrays(64, 3, 0))
    dispatch.reset_launches()
    dispatch.clear_dispatch_log()
    lion_adapt.lion_adapt(g, m, gm, lr=torch.tensor(0.1))
    adafactor_adapt.adafactor_adapt(g.abs(), gm, lr=torch.tensor(0.1))
    assert dispatch.dispatch_log() == [("lion_adapt", "plain", "cpu tensor"),
                                       ("adafactor_adapt", "plain", "cpu tensor")]
    assert dispatch.launches("lion_adapt") == dispatch.launches("adafactor_adapt") == 0
    monkeypatch.setattr(dispatch, "route", lambda name, x, backend=None: dispatch.CUDA)
    with pytest.raises(ValueError, match="cuda"):
        lion_adapt.lion_adapt(g, m, gm)
    with pytest.raises(ValueError, match="float32"):
        adafactor_adapt.adafactor_adapt(g.double(), gm.double())
    with pytest.raises(ValueError, match="flat"):
        adafactor_adapt.adafactor_adapt(g.reshape(8, 8), gm.reshape(8, 8))


@pytest.mark.parametrize("base_opt", ["lion", "adafactor", "rmsprop"])
def test_state_crosses_to_jax_and_back(base_opt):
    """A JAX EngineState after one meta step, its base optimizer's state
    (Lion's mu; Adafactor's {"r", "c"} and {"v"} dicts; RMSprop's nu)
    carried into the port and back unchanged, leaf for leaf."""
    jspec = jproblems.make_data_optimization_spec(
        jproblems.softmax_per_example(lambda th, x: x @ th["w"] + th["b"]))
    jl = japi.MetaLearner(jspec, base_opt=base_opt, base_lr=1e-2, meta_opt="adam",
                          unroll_steps=2)
    rng = np.random.default_rng(1)
    jl.init({"w": jnp.asarray(rng.standard_normal((3, 2)), jnp.float32),
             "b": jnp.zeros((2,))}, jproblems.init_data_optimization_lam(jax.random.PRNGKey(0)))
    x = rng.standard_normal((2, 8, 3)).astype(np.float32)
    y = rng.integers(0, 2, (2, 8)).astype(np.int32)
    jl.step({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": jnp.asarray(x[0]), "y": jnp.asarray(y[0])})
    jstate = jax.tree_util.tree_map(np.asarray, jl.state)
    state = convert.state_from_jax(jstate, device="cpu")
    if base_opt == "adafactor":
        assert set(state.base_opt_state.nu["w"]) == {"r", "c"}
        assert set(state.base_opt_state.nu["b"]) == {"v"}
        assert state.base_opt_state.nu["w"]["r"].shape == (3,)
    # the port's optimizer takes the carried state as its own
    topt = optim.get_optimizer(base_opt, 1e-2)
    grads = tree.tree_map(torch.ones_like, state.theta)
    topt.update(grads, state.base_opt_state, state.theta)
    back = convert.state_to_numpy(state)
    got, want = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
