"""The port's kernel registry (``repro_torch.kernels``: ``dispatch``'s
registry, ``ops``, ``ref``) against the JAX package's.

* the names registered and each one's routes (``cuda`` for the JAX
  package's ``pallas-tpu``, ``plain`` for its ``ref`` and
  ``pallas-interpret``);
* registration, a duplicate refused, ``overwrite``, removal;
* ``backend_order`` per device, and ``REPRO_KERNEL_BACKEND`` honoured
  where it agrees with the tensor's device and refused where it does not:
  the registry never falls back as the JAX package's does;
* the meta route taken by meta tensors only;
* every ``ops`` function and every ``ref`` oracle against the JAX
  package's on the same numpy inputs: f32 within 1e-5, bf16 within 2e-2
  (the bf16 tolerance of the port's other parity tests). Lion's
  surrogate divides by (|c| + delta)**2 with delta 1e-3, so in bf16 an
  element with c near 0 carries the rounding of c's two terms amplified by
  2 (|b1 m| + |(1 - b1) g|) / (|c| + delta): there the 2e-2 is taken on
  that propagated scale (:func:`_lion_bound`), for both outputs;
* ``models``' and ``perf``'s exports name for name against JAX's
  ``__all__``, with the names that differ listed.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkernels  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import perf as jperf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import kernels, models, perf  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: perf names of the JAX package the port has no counterpart of: XLA's
#: compiled-buffer breakdown (``compiled_memory``)
PERF_ONLY_JAX = {"compiled_memory"}
#: perf names only the port has: the device synchronisation its timers use
PERF_ONLY_PORT = {"synchronize"}


def _lion_bound(g, m, gm, out, tol, b1=0.9, delta=1e-3):
    """Elementwise bound on two bf16 evaluations of Lion's product, and on
    their sums of squares: ``tol`` of each element's f32 value scaled by
    the first-order sensitivity of (|c| + delta)**-2 to the rounding of
    c's two terms."""
    c = b1 * m + (1 - b1) * g
    kappa = 2 * (np.abs(b1 * m) + np.abs((1 - b1) * g)) / (np.abs(c) + delta)
    bound = tol * (1 + kappa) * np.abs(out) + tol * np.abs(out).max() * 1e-3
    return bound, float(np.sum(2 * np.abs(out) * bound + bound ** 2))


def _hold(got, want, tol, bound=None):
    if bound is None:
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=tol)
        return
    err = np.abs(_np(got[0]) - _np(want[0]))
    assert np.all(err <= bound[0]), float((err - bound[0]).max())
    assert abs(float(got[1]) - float(want[1])) <= bound[1] + tol * abs(float(want[1]))


def _np(x):
    return np.asarray(x.float().detach().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def test_registered_names_and_routes_match_jax():
    assert kernels.available_kernels() == jkernels.available_kernels()
    for name in kernels.available_kernels():
        assert kernels.kernel_backends(name) == ("cuda", "plain")
        assert "ref" in jkernels.kernel_backends(name)
    assert kernels.BACKENDS == ("cuda", "plain")
    assert (kernels.ENV_VAR, kernels.CE_VOCAB_THRESHOLD) == (jkernels.ENV_VAR,
                                                              jkernels.CE_VOCAB_THRESHOLD)
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels.get_kernel("nope")


def test_register_refuses_a_duplicate_and_overwrites_on_request():
    try:
        kernels.register_kernel("probe", "plain", lambda x: x + 1)
        with pytest.raises(ValueError, match="already has"):
            kernels.register_kernel("probe", "plain", lambda x: x + 2)
        kernels.register_kernel("probe", "plain", lambda x: x + 3, overwrite=True)
        assert float(kernels.get_kernel("probe")(torch.zeros(()))) == 3.0
        assert kernels.kernel_backends("probe") == ("plain",)

        @kernels.register_kernel("probe", "cuda", eligible=lambda x: x.dim() == 1)
        def _probe_cuda(x):
            return x

        assert kernels.kernel_backends("probe") == ("cuda", "plain")
        with pytest.raises(ValueError, match="unknown backend"):
            kernels.register_kernel("probe", "pallas-tpu", lambda x: x)
    finally:
        kernels.unregister_kernel("probe")
    assert "probe" not in kernels.available_kernels()


def test_backend_order_per_device(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert kernels.backend_order(device="cpu") == ("plain",)
    assert kernels.backend_order(device="cuda") == ("cuda",)
    assert kernels.backend_order(device="meta") == ("cuda",)
    assert kernels.backend_order("plain", device="cpu") == ("plain",)
    with pytest.raises(ValueError, match="on a cuda tensor is refused"):
        kernels.backend_order("plain", device="cuda")
    with pytest.raises(ValueError, match="on a cpu tensor is refused"):
        kernels.backend_order("cuda", device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        kernels.backend_order("ref", device="cpu")


@pytest.mark.parametrize("env,device,ok", [("plain", "cpu", True), ("cuda", "cuda", True),
                                           ("cuda", "cpu", False), ("plain", "cuda", False),
                                           ("plain", "meta", True), ("cuda", "meta", True)])
def test_env_var_honoured_only_where_it_agrees(monkeypatch, env, device, ok):
    monkeypatch.setenv(dispatch.ENV_VAR, env)
    if ok:
        assert kernels.backend_order(device=device) == (("cuda",) if device == "meta"
                                                        else (env,))
    else:
        with pytest.raises(ValueError, match=dispatch.ENV_VAR):
            kernels.backend_order(device=device)


def test_env_var_disagreeing_with_a_cpu_tensor_raises_on_every_path(monkeypatch):
    g = torch.randn(8)
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match=dispatch.ENV_VAR):
        ops.adam_adapt_product(g, g, g.abs(), g, t=1)
    with pytest.raises(ValueError, match=dispatch.ENV_VAR):
        kernels.adam_adapt.adam_adapt(g, g, g.abs(), g, t=1)
    monkeypatch.setenv(dispatch.ENV_VAR, "plain")
    assert ops.adam_adapt_product(g, g, g.abs(), g, t=1)[0].shape == (8,)
    monkeypatch.setenv(dispatch.ENV_VAR, "pallas-interpret")
    with pytest.raises(ValueError, match="must be one of"):
        ops.adam_adapt_product(g, g, g.abs(), g, t=1)


def test_registry_on_a_cuda_device_never_picks_the_plain_version(monkeypatch):
    """A call whose tensor lies on the card: the ``cuda`` implementation,
    whatever ``backend=`` or the variable ask for plain (the device's
    tensor is faked here; the card's own check is chip_smoke.py's phase
    25)."""
    fake = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(dispatch, "_first_tensor", lambda args, kwargs: fake)
    seen = []
    try:
        kernels.register_kernel("probe", "cuda", lambda x: seen.append("cuda"))
        kernels.register_kernel("probe", "plain", lambda x: seen.append("plain"))
        kernels.get_kernel("probe")(fake)
        assert seen == ["cuda"]
        with pytest.raises(ValueError, match="refused"):
            kernels.get_kernel("probe", backend="plain")(fake)
        monkeypatch.setenv(dispatch.ENV_VAR, "plain")
        with pytest.raises(ValueError, match=dispatch.ENV_VAR):
            kernels.get_kernel("probe")(fake)
        assert seen == ["cuda"]
        kernels.register_kernel("probe", "cuda", lambda x: x, eligible=lambda x: False,
                                overwrite=True)
        monkeypatch.delenv(dispatch.ENV_VAR)
        with pytest.raises(ValueError, match="does not take"):
            kernels.get_kernel("probe")(fake)
    finally:
        kernels.unregister_kernel("probe")


def test_meta_route_is_taken_by_meta_tensors_only():
    cpu, meta = torch.zeros(4), torch.zeros(4, device="meta")
    assert dispatch.route("adam_adapt", cpu) == dispatch.PLAIN
    assert dispatch.route("adam_adapt", meta) == dispatch.META
    assert dispatch.route("adam_adapt", meta, "plain") == dispatch.META
    with dispatch.plain_everywhere():
        assert dispatch.route("adam_adapt", meta) == dispatch.META
        assert dispatch.route("adam_adapt", cpu) == dispatch.PLAIN
    out, s = ops.adam_adapt_product(meta, meta, meta, meta, t=1)
    assert out.is_meta and out.shape == (4,) and s.is_meta and s.shape == ()
    logits = torch.zeros(3, 5000, device="meta", requires_grad=True)
    ce = ops.cross_entropy(logits, torch.zeros(3, dtype=torch.int64, device="meta"))
    assert ce.is_meta and ce.dtype == torch.float32 and ce.shape == (3,)
    (g,) = torch.autograd.grad(ce.sum(), logits)
    assert g.is_meta and g.shape == logits.shape


def _flat_inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    g, m, gm = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    jx = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    tx = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    return (g, m, v, gm), jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_adapt_products_match_jax(dtype):
    (g, m, v, gm), jx, tx = _flat_inputs(1031, dtype, 0)
    tol = TOL[dtype]
    kw = dict(t=3, b1=0.9, b2=0.999, eps=1e-8, lr=0.5)
    lion = jref.lion_adapt_product(*map(jnp.asarray, (g, m, gm)), lr=0.5)[0]
    lion_bound = _lion_bound(g, m, gm, np.asarray(lion), tol) if dtype != "float32" else None
    for got, want, bound in (
            (ops.adam_adapt_product(*map(tx, (g, m, v, gm)), **kw),
             jops.adam_adapt_product(*map(jx, (g, m, v, gm)), **kw), None),
            (ops.lion_adapt_product(*map(tx, (g, m, gm)), lr=0.5, b1=0.9, delta=1e-3),
             jops.lion_adapt_product(*map(jx, (g, m, gm)), lr=0.5, b1=0.9, delta=1e-3),
             lion_bound),
            (ops.adafactor_adapt_product(*map(tx, (v, gm)), lr=0.5, eps=1e-8),
             jops.adafactor_adapt_product(*map(jx, (v, gm)), lr=0.5, eps=1e-8), None)):
        assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
        _hold(got, want, tol, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_oracles_match_jax(dtype):
    (g, m, v, gm), jx, tx = _flat_inputs(517, dtype, 1)
    tol = TOL[dtype]
    kw = dict(t=2, b1=0.9, b2=0.999, eps=1e-8, lr=1.0)
    lion = np.asarray(jref.lion_adapt_product(*map(jnp.asarray, (g, m, gm)))[0])
    lion_bound = _lion_bound(g, m, gm, lion, tol) if dtype != "float32" else None
    pairs = [
        (ref.adam_adapt_math(*map(tx, (g, m, v, gm)), **kw),
         jref.adam_adapt_math(*map(jx, (g, m, v, gm)), **kw)),
        (ref.lion_adapt_math(*map(tx, (g, m, gm)), lr=1.0, b1=0.9, delta=1e-3),
         jref.lion_adapt_math(*map(jx, (g, m, gm)), lr=1.0, b1=0.9, delta=1e-3)),
        (ref.adafactor_adapt_math(*map(tx, (v, gm)), lr=1.0, eps=1e-8),
         jref.adafactor_adapt_math(*map(jx, (v, gm)), lr=1.0, eps=1e-8)),
        (ref.adam_adapt_product(*map(tx, (g, m, v, gm)), **kw),
         jref.adam_adapt_product(*map(jx, (g, m, v, gm)), **kw)),
        (ref.lion_adapt_product(*map(tx, (g, m, gm))),
         jref.lion_adapt_product(*map(jx, (g, m, gm)))),
        (ref.adafactor_adapt_product(*map(tx, (v, gm))),
         jref.adafactor_adapt_product(*map(jx, (v, gm)))),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got[0].dtype == (getattr(torch, dtype) if i < 3 else torch.float32)
        _hold(got, want, tol, lion_bound if i == 1 else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_ops_and_ref_match_jax(dtype):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 3, 4096)) * 3).astype(np.float32)
    targets = rng.integers(0, 4096, (2, 3))
    g = rng.standard_normal(6).astype(np.float32)
    tol = TOL[dtype]
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = ops.cross_entropy(tl, torch.from_numpy(targets))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(jops.cross_entropy(jl, jnp.asarray(targets))),
                               rtol=tol, atol=tol)
    flat, tflat = tl.reshape(6, 4096), torch.from_numpy(targets.reshape(6))
    jflat, jtflat = jl.reshape(6, 4096), jnp.asarray(targets.reshape(6))
    np.testing.assert_allclose(_np(ref.cross_entropy(flat, tflat)),
                               _np(jref.cross_entropy(jflat, jtflat)), rtol=tol, atol=tol)
    dg = ref.cross_entropy_grad(flat, tflat, torch.from_numpy(g))
    assert dg.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(dg), _np(jref.cross_entropy_grad(jflat, jtflat,
                                                                    jnp.asarray(g))),
                               rtol=tol, atol=tol)
    # the gradient through ops.cross_entropy is the oracle's
    x = flat.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((ops.cross_entropy(x, tflat) * torch.from_numpy(g)).sum(), x)
    np.testing.assert_allclose(_np(gx), _np(dg), rtol=tol, atol=tol)


def test_exports_name_for_name():
    assert sorted(models.__all__) == sorted(jmodels.__all__)
    assert models.token_cross_entropy is models.model.token_cross_entropy
    assert set(jperf.__all__) - set(perf.__all__) == PERF_ONLY_JAX
    assert set(perf.__all__) - set(jperf.__all__) == PERF_ONLY_PORT
    assert sorted(kernels.__all__) == sorted(jkernels.__all__)
    assert sorted(ops.__all__) == sorted(jops.__all__)
    for name in perf.__all__:
        assert getattr(perf, name) is not None


def test_census_of_counts_one_executed_call():
    from repro_torch.launch import distributed as D
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")

    def fn(x):
        D.collective("all-reduce", x, mesh)
        D.collective("all-reduce", x, mesh)
        return x

    got = perf.census_of(fn, torch.ones(4))
    assert got["all-reduce_count"] == 2 and got["all-reduce_bytes"] == 32
    assert perf.verify_single_sync(got, 1)["single_sync_ok"]
    assert perf.device_memory() is None  # no card here
    assert "device_stats" not in perf.memory_report(example_args=(torch.ones(2),))
