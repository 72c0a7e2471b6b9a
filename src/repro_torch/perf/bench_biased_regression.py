"""Paper Appendix E / Figure 5 on the card: biased regression with
closed-form solutions, the port's twin of
``benchmarks/bench_biased_regression.py``.

    PYTHONPATH=src python -m repro_torch.perf.bench_biased_regression \
        [--device cpu] [--full] [--out DIR]

The base problem ``min_w ||X w - y||^2 + beta ||w - lam||^2`` has the
closed-form ``w*(lam)`` and hypergradient of the meta loss
``||X' w*(lam) - y'||^2``. Reports the cosine between each algorithm's
hypergradient (SAMA, CG at 20 iterations, Neumann at 200 terms with scale
0.05, T1-T2) and the true one at ``w*(lam)``, with its µs per call, and
``||lam_t - lam*||`` after 100 meta updates (Adam 0.05) of SAMA and CG.
X, y and w_true are drawn with numpy (the port has no ``jax.random``), so
the numbers need not equal the JAX baseline's; the bench file says so.
The paper's claims (SAMA's cosine above 0.9; SAMA ending nearer lam* than
CG) are recorded, not asserted. Writes
``BENCH_torch_biased_regression.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.perf.common import Bench, cli


def problem_arrays(seed: int = 0, n: int = 100, n_meta: int = 80, d: int = 20):
    """(X, Xp, y, yp) f32, drawn as the JAX bench draws them but from a
    numpy generator."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    Xp = (rng.standard_normal((n_meta, d)) / np.sqrt(d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    y = (X @ w_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    yp = (Xp @ w_true).astype(np.float32)
    return X, Xp, y, yp


def make_problem(arrays, device, beta: float = 0.1):
    """The spec, ``w_star(lam)``, ``g_true(lam)`` and ``lam*`` on
    ``device`` from numpy ``(X, Xp, y, yp)``."""
    from repro_torch.core import BilevelSpec

    X, Xp, y, yp = (torch.from_numpy(a).to(device) for a in arrays)
    d = X.shape[1]
    A = X.T @ X + beta * torch.eye(d, device=device)

    spec = BilevelSpec(
        base_loss=lambda th, lam, b: (torch.sum((X @ th["w"] - y) ** 2)
                                      + beta * torch.sum((th["w"] - lam["w"]) ** 2)),
        meta_loss=lambda th, lam, b: torch.sum((Xp @ th["w"] - yp) ** 2),
    )

    def w_star(lam):
        return torch.linalg.solve(A, X.T @ y + beta * lam)

    def g_true(lam):
        return 2.0 * beta * torch.linalg.solve(A, Xp.T @ (Xp @ w_star(lam) - yp))

    Ainv = torch.linalg.inv(A)
    M = beta * Xp @ Ainv
    b_ls = yp - Xp @ Ainv @ (X.T @ y)
    lam_star = torch.linalg.lstsq(M.cpu(), b_ls.cpu()[:, None]).solution[:, 0].to(device)
    return spec, w_star, g_true, lam_star


def _cos(a, b):
    return float(torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-30))


def hypergrad_fns(spec, theta, lam):
    """name -> a call giving that algorithm's hypergradient in lam["w"] at
    (theta, lam), with the JAX bench's settings."""
    from repro_torch import optim
    from repro_torch.core import SAMAConfig, baselines, sama_hypergrad
    from repro_torch.core.sama import value_and_grad

    opt = optim.sgd(0.01)
    st = opt.init(theta)
    _, g_base = value_and_grad(spec.base_scalar, 0)(theta, lam, None)

    def sama_fn():
        return sama_hypergrad(spec, theta, lam, None, None, base_opt=opt, base_opt_state=st,
                              g_base=g_base, cfg=SAMAConfig()).hypergrad["w"]

    return {
        "sama": sama_fn,
        "cg": lambda: baselines.cg_hypergrad(spec, theta, lam, None, None, num_iters=20)["w"],
        "neumann": lambda: baselines.neumann_hypergrad(spec, theta, lam, None, None,
                                                       num_terms=200, scale=0.05)["w"],
        "t1t2": lambda: baselines.t1t2_hypergrad(spec, theta, lam, None, None)["w"],
    }


def run(*, fast: bool = True, device="cuda", steps: int = 100, repeats: int = 3) -> Bench:
    from repro_torch import optim, perf
    from repro_torch.core import SAMAConfig, baselines, sama_hypergrad
    from repro_torch.core.sama import value_and_grad
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    bench = Bench("biased_regression")
    spec, w_star, g_true, lam_star = make_problem(problem_arrays(0), dev)
    d = lam_star.shape[0]
    lam = {"w": torch.ones(d, device=dev) * 0.5}
    theta = {"w": w_star(lam["w"])}
    gt = g_true(lam["w"])
    for name, fn in hypergrad_fns(spec, theta, lam).items():
        g = fn()
        us = perf.time_callable(fn, warmup=1, repeats=repeats).median_us
        bench.emit(f"fig5_cosine_{name}", us, f"cos={_cos(g, gt):.4f}")

    # convergence panel
    opt = optim.sgd(0.01)
    for name in ("sama", "cg"):
        lam_t = {"w": torch.zeros(d, device=dev)}
        meta_opt = optim.adam(0.05)
        mst = meta_opt.init(lam_t)
        for _ in range(steps):
            th = {"w": w_star(lam_t["w"])}
            stt = opt.init(th)
            _, gb = value_and_grad(spec.base_scalar, 0)(th, lam_t, None)
            if name == "sama":
                g = sama_hypergrad(spec, th, lam_t, None, None, base_opt=opt,
                                   base_opt_state=stt, g_base=gb, cfg=SAMAConfig()).hypergrad
            else:
                g = baselines.cg_hypergrad(spec, th, lam_t, None, None, num_iters=20)
            upd, mst = meta_opt.update(g, mst, lam_t)
            lam_t = optim.apply_updates(lam_t, upd)
        dist = float(torch.linalg.norm(lam_t["w"] - lam_star))
        bench.emit(f"fig5_lamdist_{name}", 0.0, f"dist_after_{steps}={dist:.4f}")

    cos = {r["name"]: r["derived"]["cos"] for r in bench.rows if "cosine" in r["name"]}
    bench.claim("cos_sama>0.9", cos["fig5_cosine_sama"] > 0.9)
    dist = {n: bench.derived(f"fig5_lamdist_{n}")[f"dist_after_{steps}"]
            for n in ("sama", "cg")}
    bench.claim("lamdist_sama<lamdist_cg", dist["sama"] < dist["cg"])
    bench.notes.update({"data": "X, y, w_true drawn with numpy's default_rng(0) where the "
                                "JAX bench draws with jax.random: the rows need not equal "
                                "the JAX baseline's",
                        "steps": steps})
    return bench


def main(argv=None):
    return cli("biased_regression", run, argv)


if __name__ == "__main__":
    main()
