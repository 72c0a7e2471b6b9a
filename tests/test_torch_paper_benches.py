"""The port's twins of the paper benches (``repro_torch.perf.bench_*``:
Tables 1, 3, 8-9, Figures 1, 3 and 5, the serving bench and the obs bench):

* Figure 5's four hypergradients (SAMA, CG, Neumann, T1-T2) on identical
  numpy X, y and lam: each one's cosine to the closed-form hypergradient
  within 1e-4 of what the JAX package's ``sama_hypergrad`` and
  ``baselines`` give on the same arrays (f32 in both; the closed forms
  solve the same 20 x 20 system);
* each twin end to end on the CPU at a cut size (a few steps, fewer
  rows): its bench file passes both packages' ``validate_bench``, its row
  names are those of ``benchmarks/baselines/BENCH_<name>.json``, and each
  claim is recorded as held, not held or (a memory claim on the CPU) not
  measured;
* each twin's CLI refuses to run without a card unless given
  ``--device cpu``.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro import perf as jperf  # noqa: E402
from repro.core import BilevelSpec as JSpec  # noqa: E402
from repro.core import SAMAConfig as JSAMAConfig  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import sama_hypergrad as jsama_hypergrad  # noqa: E402
from repro_torch import perf  # noqa: E402
from repro_torch.perf import bench_biased_regression  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
COS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small models are dominated by many tiny
    ops, whose thread pools spin against the other test workers' on a
    shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cosines(arrays, beta=0.1):
    """The JAX bench's ``_problem`` and cosine panel, on given arrays."""
    X, Xp, y, yp = (jnp.asarray(a) for a in arrays)
    d = X.shape[1]
    A = X.T @ X + beta * jnp.eye(d)
    spec = JSpec(
        base_loss=lambda th, lam, b: jnp.sum((X @ th["w"] - y) ** 2)
        + beta * jnp.sum((th["w"] - lam["w"]) ** 2),
        meta_loss=lambda th, lam, b: jnp.sum((Xp @ th["w"] - yp) ** 2),
    )

    def w_star(lam):
        return jnp.linalg.solve(A, X.T @ y + beta * lam)

    lam = {"w": jnp.ones((d,)) * 0.5}
    theta = {"w": w_star(lam["w"])}
    gt = 2.0 * beta * jnp.linalg.solve(A, Xp.T @ (Xp @ theta["w"] - yp))
    opt = joptim.sgd(0.01)
    st = opt.init(theta)
    g_base = jax.grad(spec.base_scalar)(theta, lam, None)
    gs = {
        "sama": jsama_hypergrad(spec, theta, lam, None, None, base_opt=opt, base_opt_state=st,
                                g_base=g_base, cfg=JSAMAConfig()).hypergrad["w"],
        "cg": jbaselines.cg_hypergrad(spec, theta, lam, None, None, num_iters=20)["w"],
        "neumann": jbaselines.neumann_hypergrad(spec, theta, lam, None, None, num_terms=200,
                                                scale=0.05)["w"],
        "t1t2": jbaselines.t1t2_hypergrad(spec, theta, lam, None, None)["w"],
    }
    return {k: float(jnp.vdot(g, gt) / (jnp.linalg.norm(g) * jnp.linalg.norm(gt) + 1e-30))
            for k, g in gs.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_biased_regression_cosines_match_jax(seed):
    arrays = bench_biased_regression.problem_arrays(seed)
    spec, w_star, g_true, _ = bench_biased_regression.make_problem(arrays, "cpu")
    lam = {"w": torch.ones(arrays[0].shape[1]) * 0.5}
    theta = {"w": w_star(lam["w"])}
    gt = g_true(lam["w"])
    got = {k: bench_biased_regression._cos(fn(), gt)
           for k, fn in bench_biased_regression.hypergrad_fns(spec, theta, lam).items()}
    want = _jax_cosines(arrays)
    assert set(got) == set(want) == {"sama", "cg", "neumann", "t1t2"}
    for k in got:
        assert abs(got[k] - want[k]) <= COS_ATOL, (k, got[k], want[k])


# the cut sizes: a few steps and fewer rows; the row names do not depend on them
CUTS = {
    "cont_pretrain": dict(steps=2, n_train=32, n_meta=16, n_test=64),
    "wrench": dict(steps=2, n_train=64, n_meta=32, n_test=64),
    "ablation": dict(steps=2, n_train=64, n_meta=32, n_test=64),
    "memory_vs_modelsize": dict(n_train=32, n_meta=16, layers=1),
    "data_pruning": dict(steps=2, retrain_steps=2, n=64, n_test=64),
    "biased_regression": dict(steps=5, repeats=1),
    "serve": dict(),
    "obs": dict(pairs=1, steps=2),
}


@pytest.mark.parametrize("name", sorted(CUTS))
def test_twin_runs_on_the_cpu_with_the_jax_rows(name, tmp_path, capsys):
    mod = importlib.import_module(f"repro_torch.perf.bench_{name}")
    bench = mod.run(fast=True, device="cpu", **CUTS[name])
    path = bench.write(str(tmp_path), fast=True, elapsed_s=1.0)
    assert pathlib.Path(path).name == f"BENCH_torch_{name}.json"
    payload = perf.load_bench(path)
    assert jperf.validate_bench(payload) == []
    assert payload["bench"] == f"torch_{name}" and payload["env"]["backend"] == "cpu"
    baseline = json.loads((ROOT / "benchmarks" / "baselines" / f"BENCH_{name}.json").read_text())
    want = [r["name"] for r in baseline["rows"]]
    assert [r["name"] for r in payload["rows"]] == want
    for row in payload["rows"]:
        assert np.isfinite(row["us_per_call"]) and isinstance(row["derived"], dict)
    assert all(v in (True, False, None) for v in payload["claims"].values())
    if name != "serve":  # the serving bench asserts; the paper benches record claims
        assert payload["claims"]
    out = capsys.readouterr().out
    assert all(f"{r['name']}," in out for r in payload["rows"])


def test_memory_rows_on_the_cpu_say_not_measured():
    from repro_torch.perf import bench_memory_vs_modelsize

    bench = bench_memory_vs_modelsize.run(device="cpu", widths=[128], n_train=16, n_meta=16,
                                          layers=1)
    assert {r["derived"]["peak_mb"] for r in bench.rows} == {"not_measured"}
    assert all(rec.extra["memory_source"] == "not measured" for rec in bench.records)
    assert bench.claims == {"sama_flattest_growth": None, "sama_least_peak_each_width": None}
    params = bench.rows[0]["derived"]["params"]
    assert [rec.extra["params"] for rec in bench.records] == [params] * 4


def test_cli_writes_the_bench_file(tmp_path):
    from repro_torch.perf import bench_biased_regression as mod

    path = mod.main(["--device", "cpu", "--out", str(tmp_path)])
    payload = perf.load_bench(path)
    assert payload["fast"] is True and len(payload["rows"]) == 6
    assert "numpy" in payload["notes"]["data"]


@pytest.mark.parametrize("name", sorted(CUTS))
def test_twin_cli_raises_without_a_card(monkeypatch, tmp_path, name):
    mod = importlib.import_module(f"repro_torch.perf.bench_{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
