"""The port's blockwise cross-entropy (``repro_torch.kernels.weighted_ce``)
against the JAX package's: the plain forward (what CPU tensors take) and
its autograd gradient against the Pallas kernel run in interpret mode
(values and ``jax.vjp``) and against ``ref.cross_entropy`` /
``ref.cross_entropy_grad``; the kernels' row addressing; the route a CUDA
tensor takes (with the kernel launches stubbed, since the CUDA kernels run
only on a card: tests/test_torch_kernels_cuda.py); and the gemma3 smoke
model at a vocabulary of 8192 (above ``CE_VOCAB_THRESHOLD``), whose LM
losses and SAMA meta step go through ``weighted_ce``, against JAX.

Tolerances: f32 1e-5 (docs/kernels.md "Numerical contract"), bf16 logits
2e-2 (the flash tolerances of tests/test_flash_attention.py). The meta
step takes tests/test_torch_sama.py's tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import problems as jproblems  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import weighted_ce as jwce  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import api, configs, convert, tree  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.kernels import dispatch, weighted_ce  # noqa: E402
from repro_torch.models import Model  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(r, v, dtype, seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((r, v))).astype(np.float32)
    if dtype == "bfloat16":  # the values both sides see: rounded to bf16 once
        logits = logits.astype(ml_dtypes.bfloat16).astype(np.float32)
    targets = rng.integers(0, v, r).astype(np.int32)
    targets[0] = 0
    targets[-1] = v - 1
    g = rng.standard_normal(r).astype(np.float32)
    return logits, targets, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [4096, 5000, 8192])
@pytest.mark.parametrize("r", [1, 7, 37])
def test_plain_forward_and_gradient_match_jax(r, v, dtype):
    logits, targets, g = _inputs(r, v, dtype, r * v)
    jx = jnp.asarray(logits).astype(getattr(jnp, dtype))
    jt = jnp.asarray(targets)
    kern, vjp = jax.vjp(lambda a: jwce.cross_entropy(a, jt, True), jx)
    (kern_grad,) = vjp(jnp.asarray(g))
    ref = jref.cross_entropy(jx, jt)
    ref_grad = jref.cross_entropy_grad(jx, jt, jnp.asarray(g))

    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    ce = weighted_ce.cross_entropy(x, torch.from_numpy(targets))
    assert ce.dtype == torch.float32 and ce.shape == (r,)
    (ce * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    for want, want_grad in ((kern, kern_grad), (ref, ref_grad)):
        np.testing.assert_allclose(ce.detach().numpy(), np.asarray(want), **TOL["float32"])
        np.testing.assert_allclose(x.grad.float().numpy(),
                                   np.asarray(want_grad).astype(np.float32), **TOL[dtype])


def test_forward_and_lse_match_the_pallas_kernel():
    """The (ce, lse) pair the forward kernel saves for its backward."""
    logits, targets, _ = _inputs(16, 8192, "float32", 3)
    j_ce, j_lse = jwce._ce_fwd(jnp.asarray(logits), jnp.asarray(targets), True)
    ce, lse = weighted_ce.cross_entropy_fwd_plain(torch.from_numpy(logits),
                                                  torch.from_numpy(targets))
    np.testing.assert_allclose(ce.numpy(), np.asarray(j_ce), **TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL["float32"])


@pytest.mark.parametrize("make", [
    lambda x: x,                      # (B, S, V) contiguous: one level
    lambda x: x[:, :-1],              # the LM loss's view: two levels
    lambda x: x[1],                   # (S, V)
    lambda x: x[:, 2:3],              # a size-1 axis dropped
    lambda x: x[:1, :-1],
])
def test_row_layout_addresses_every_row(make):
    """Row r of the view starts where ``row_layout`` says: what the CUDA
    kernels compute from (inner_n, s_outer, s_inner)."""
    base = torch.arange(3 * 6 * 8, dtype=torch.float32).reshape(3, 6, 8)
    view = make(base)
    rows, inner_n, s_outer, s_inner = weighted_ce.row_layout(view)
    want = view.reshape(-1, 8)
    assert rows == want.shape[0]
    start = view.storage_offset()
    for r in range(rows):
        off = start + (r // inner_n) * s_outer + (r % inner_n) * s_inner
        assert torch.equal(base.reshape(-1)[off:off + 8], want[r])


def test_row_layout_refuses_what_the_kernels_do_not_take():
    x = torch.zeros(4, 5, 6, 8)
    with pytest.raises(ValueError, match="two strides"):
        weighted_ce.row_layout(x[:, :-1, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        weighted_ce.row_layout(x.transpose(-1, -2))


def test_cuda_route_launches_the_kernels(monkeypatch):
    """On the CUDA route the forward calls the forward kernel's wrapper and
    the backward the backward kernel's (stubbed here by the plain versions,
    counting calls): no plain fallback is taken for the wrapper's work.
    softmax_per_example at CE_VOCAB_THRESHOLD classes goes the same way."""
    calls = []

    def fake_fwd(logits, targets):
        calls.append(("fwd", tuple(logits.shape), logits.is_contiguous()))
        return weighted_ce.cross_entropy_fwd_plain(logits.reshape(-1, logits.shape[-1]),
                                                   targets)

    def fake_bwd(logits, targets, lse, g):
        calls.append(("bwd", tuple(logits.shape), g.dtype))
        return weighted_ce.cross_entropy_bwd_plain(logits.reshape(-1, logits.shape[-1]),
                                                   targets, lse, g).reshape(logits.shape)

    monkeypatch.setattr(dispatch, "route", lambda name, x, backend=None: dispatch.CUDA)
    monkeypatch.setattr(weighted_ce, "_fwd_cuda", fake_fwd)
    monkeypatch.setattr(weighted_ce, "_bwd_cuda", fake_bwd)
    logits, targets, _ = _inputs(12, 4096, "float32", 0)
    x = torch.from_numpy(logits).reshape(3, 4, 4096).requires_grad_(True)
    t = torch.from_numpy(targets).reshape(3, 4)
    ce = weighted_ce.cross_entropy(x[:, :-1], t[:, 1:])
    ce.mean().backward()
    # the sliced view reaches the kernel as it is, uncopied
    assert calls == [("fwd", (3, 3, 4096), False), ("bwd", (3, 3, 4096), torch.float32)]
    pe = problems.softmax_per_example(lambda th, z: z)(
        None, {"x": torch.from_numpy(logits), "y": torch.from_numpy(targets)})
    assert calls[-1] == ("fwd", (12, 4096), True)
    np.testing.assert_allclose(pe.loss.numpy(), np.asarray(
        jref.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors_and_other_dtypes():
    x = torch.zeros(2, 4096)
    t = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        weighted_ce._fwd_cuda(x, t)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        weighted_ce._fwd_cuda(x.double(), t)
    with pytest.raises(ValueError, match="int32"):
        weighted_ce._fwd_cuda(x, t.long())


# ---------------------------------------------------------------------------
# the gemma3 smoke model at V = 8192
# ---------------------------------------------------------------------------


def _gemma(pkg_configs, vocab=8192):
    return pkg_configs.get_smoke_config("gemma3-1b").replace(vocab_size=vocab)


@pytest.fixture(scope="module")
def gemma_pair():
    jm = JaxModel(_gemma(jconfigs))
    return jm, jm.init(jax.random.PRNGKey(11))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _lm_tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("use_ce_kernel,vocab", [(False, 8192), (True, 512)])
def test_gemma_lm_losses_take_weighted_ce_and_match_jax(use_ce_kernel, vocab):
    """per_example and lm_loss of the gemma3 smoke model: at V 8192 by the
    threshold, at the smoke config's V 512 by ``use_ce_kernel``."""
    jm = JaxModel(_gemma(jconfigs, vocab), use_ce_kernel=use_ce_kernel)
    jparams = jm.init(jax.random.PRNGKey(vocab))
    tm = Model(_gemma(configs, vocab), device="cpu", use_ce_kernel=use_ce_kernel)
    tparams = convert.params_from_jax(_np_tree(jparams), device="cpu")
    toks = _lm_tokens(vocab, 2, 16, vocab)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    dispatch.clear_dispatch_log()
    np.testing.assert_allclose(float(tm.lm_loss(tparams, tb)), float(jm.lm_loss(jparams, jb)),
                               rtol=1e-5)
    jpe, tpe = jm.per_example(jparams, jb), tm.per_example(tparams, tb)
    for key in ("loss", "uncertainty"):
        np.testing.assert_allclose(getattr(tpe, key).detach().numpy(),
                                   np.asarray(getattr(jpe, key)), rtol=1e-5, err_msg=key)
    assert [e for e in dispatch.dispatch_log() if e[0] == "weighted_ce"] == \
        [("weighted_ce", "plain", "cpu tensor")] * 2


def test_gemma_meta_step_matches_jax(gemma_pair):
    """One SAMA meta step on the per-sequence LM loss, from the JAX
    learner's state carried across. The K base batches are row
    permutations of one set of sequences and the meta batch is that set,
    so the rows the meta gradient touches have warm Adam moments
    (tests/test_torch_sama.py ``_bert_batches``). The base Adam takes
    eps 1e-3, as the full-width comparisons do (ROADMAP queue 3): every
    row of the tied 8192-row embedding gets only the softmax tail's small
    gradients, and at eps 1e-8 the exact Adam diagonal, ~lr/|g|, lets
    those rows' rounding make up v, so eps follows the rounding of
    whichever implementation computes it (this step at 1e-8: the port in
    f32 0.42992, the port with theta in f64 0.43001, JAX in f32 0.42883)."""
    from repro import optim as joptim
    from repro_torch import optim
    from test_torch_sama import _run_pair

    jm, jparams = gemma_pair
    tm = Model(_gemma(configs), device="cpu")
    kw = dict(meta_opt="adam", meta_lr=1e-3, method="sama", unroll_steps=2)
    jlearner = japi.MetaLearner(jproblems.make_data_optimization_spec(jm.per_example),
                                base_opt=joptim.adam(1e-3, eps=1e-3), **kw)
    jlearner.init(jparams, jproblems.init_data_optimization_lam(jax.random.PRNGKey(12)))
    tlearner = api.MetaLearner(problems.make_data_optimization_spec(tm.per_example),
                               base_opt=optim.adam(1e-3, eps=1e-3), **kw)

    def batches(i):
        r = np.random.default_rng(40 + i)
        toks = _lm_tokens(41 + i, 4, 16, 8192)
        perms = np.stack([r.permutation(4) for _ in range(2)])
        return {"tokens": toks[perms]}, {"tokens": toks}

    dispatch.clear_dispatch_log()
    _run_pair(jlearner, tlearner, batches, steps=1)
    # K base forwards, the meta pass, two central-difference passes
    assert sum(e[0] == "weighted_ce" for e in dispatch.dispatch_log()) == 5
