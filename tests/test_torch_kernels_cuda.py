"""The port's training kernels against their plain PyTorch versions on the
card: the flash-attention forward and its dq and dk/dv backward kernels
(through autograd), the blockwise cross-entropy forward and backward, and
the Adam, Lion and Adafactor adaptation products; then SAMA meta steps of
the bert-base and gemma3 smoke models through the kernels, against the
same steps with every kernel forced to its plain version, with each
kernel's launches counted.

Every test here needs a CUDA card (``-m cuda``) and skips without one:
the CUDA kernels have no CPU mode. This file imports no JAX, so it runs on
a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: flash forward 1e-5 and VJP 5e-5 in f32, 2e-2 in bf16
(tests/test_flash_attention.py); the adaptation products out rtol 1e-5 /
atol 1e-7 and sum of squares rtol 1e-4 (tests/test_kernels.py);
weighted_ce as stated at its test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adam_adapt, dispatch, flash_attn  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


# (B, S, T, KV, G, Dh, causal, window, softcap): bert-base's layer, the
# gemma-like training shape (G 4, Dh 256, window, softcap), and ragged or
# odd group and head sizes
CASES = [
    (4, 128, 128, 12, 1, 64, False, 0, 0.0),
    (2, 200, 200, 1, 4, 256, True, 64, 50.0),
    (3, 17, 45, 2, 3, 40, True, 0, 0.0),
    (2, 33, 33, 1, 8, 8, True, 5, 20.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_flash_attention_kernels_match_plain(dev, case, dtype):
    B, S, T, KV, G, Dh, causal, window, softcap = case
    rng = np.random.default_rng(S * 7 + Dh)
    q = _randn(rng, (B, S, KV * G, Dh), dtype, dev)
    k = _randn(rng, (B, T, KV, Dh), dtype, dev)
    v = _randn(rng, (B, T, KV, Dh), dtype, dev)
    cot = _randn(rng, (B, S, KV * G, Dh), dtype, dev)
    # queries continue after the first T - S keys, as a prefill would
    q_pos = (torch.arange(S, device=dev) + (T - S))[None].expand(B, S)
    kv_pos = torch.arange(T, device=dev)
    kw = dict(softcap=softcap, window=window, causal=causal)
    fwd_tol, grad_tol = TOL[dtype]

    def run(backend):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = flash_attn.flash_attention(qq, kk, vv, q_pos, kv_pos, True, backend=backend, **kw)
        (out.float() * cot.float()).sum().backward()
        return out.detach(), qq.grad, kk.grad, vv.grad

    dispatch.reset_launches()
    got = run(None)
    torch.cuda.synchronize()
    assert [dispatch.launches(n) for n in (flash_attn.FWD, flash_attn.DQ, flash_attn.DKV)] == [1, 1, 1]
    plain = run("plain")
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, plain,
                               (fwd_tol, grad_tol, grad_tol, grad_tol)):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item()) if name != "out" else 1.0
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol} x {scale:.2f}"


def test_flash_attention_kernel_lse_and_masked_rows(dev):
    """Fully masked rows (every key padded) give zeros and lse = NEG, and
    the lse of the other rows matches the plain version's."""
    rng = np.random.default_rng(0)
    B, S, KV, G, Dh = 2, 40, 2, 2, 32
    q = _randn(rng, (B, S, KV * G, Dh), torch.float32, dev)
    k = _randn(rng, (B, S, KV, Dh), torch.float32, dev)
    v = _randn(rng, (B, S, KV, Dh), torch.float32, dev)
    q_pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
    kv_pos = torch.arange(S, device=dev, dtype=torch.int32)
    q_pos[1, 5:] = -1  # padded queries
    out, lse = flash_attn._fwd_cuda(q, k, v, q_pos, kv_pos, softcap=0.0, window=0, causal=True)
    _, lse_plain = flash_attn.flash_attention_fwd_plain(q[:1], k[:1], v[:1], q_pos[:1], kv_pos)
    assert torch.all(out[1, 5:] == 0)
    assert torch.all(lse.reshape(B, KV * G, S)[1, :, 5:] == flash_attn.NEG)
    torch.testing.assert_close(lse[:KV], lse_plain, atol=1e-5, rtol=1e-6)


def test_flash_attention_wrapper_rejects_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 12), device=dev)  # Dh 12: not a multiple of 8
    pos = torch.arange(4, device=dev)[None]
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attn.flash_attention(q, q[:, :, :1], q[:, :, :1], pos, pos[0])
    q = torch.zeros((1, 4, 2, 8), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attn.flash_attention(q, q[:, :, :1], q[:, :, :1], pos, pos[0])


@pytest.mark.parametrize("n", [23_440_896, 1_000_003])
@pytest.mark.parametrize("t", [1, 7])
def test_adam_adapt_kernel_matches_plain(dev, n, t):
    rng = np.random.default_rng(n % 1000 + t)
    g, gm = (_randn(rng, (n,), torch.float32, dev) * 1e-2 for _ in range(2))
    m = _randn(rng, (n,), torch.float32, dev) * 1e-2
    v = _randn(rng, (n,), torch.float32, dev).square() * 1e-4
    lr = torch.tensor(1e-3, device=dev)
    step = torch.tensor(t, dtype=torch.int32, device=dev)
    dispatch.reset_launches()
    out, ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr)
    torch.cuda.synchronize()
    assert dispatch.launches("adam_adapt") == 1
    ref, ref_ss = adam_adapt.adam_adapt(g, m, v, gm, t=step, lr=lr, backend="plain")
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ss, ref_ss, rtol=1e-4, atol=0)
    # unaligned views take the kernel's scalar loop
    out1, _ = adam_adapt.adam_adapt(g[1:], m[1:], v[1:], gm[1:], t=step, lr=lr)
    torch.testing.assert_close(out1, ref[1:], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sliced", [((37, 5000), False), ((3, 40, 8192), True),
                                          ((2, 4096), False), ((5, 4097), False)])
def test_weighted_ce_kernels_match_plain(dev, shape, sliced, dtype):
    """Forward (ce, lse) and backward (dlogits) through autograd, the
    backward kernel's gradient in the logits' dtype. ``sliced`` feeds the
    LM loss's logits[:, :-1] view; V 4097 leaves rows unaligned and a
    ragged end. f32 within 1e-5 (1 + |ref|) forward and 1e-6 + 1e-5 |ref|
    backward; bf16 gradients within half an ulp of the plain version in
    f32 (plus the f32 tolerance)."""
    from repro_torch.kernels import weighted_ce

    rng = np.random.default_rng(sum(shape))
    x = (_randn(rng, shape, torch.float32, dev) * 3).to(dtype)
    t = torch.from_numpy(rng.integers(0, shape[-1], shape[:-1]).astype(np.int64)).to(dev)
    if sliced:
        x_in, t_in = x[:, :-1], t[:, 1:]
    else:
        x_in, t_in = x, t
    g = _randn(rng, t_in.shape, torch.float32, dev)

    def run(backend):
        leaf = x.clone().requires_grad_(True)
        xi = leaf[:, :-1] if sliced else leaf
        ce = weighted_ce.cross_entropy(xi, t_in, backend=backend)
        (ce * g).sum().backward()
        return ce.detach(), leaf.grad

    dispatch.reset_launches()
    ce, grad = run(None)
    torch.cuda.synchronize()
    assert dispatch.launches(weighted_ce.FWD) == dispatch.launches(weighted_ce.BWD) == 1
    ce_ref, grad_ref = run("plain")
    assert ce.dtype == torch.float32 and grad.dtype == dtype
    assert ((ce - ce_ref).abs() <= 1e-5 * (1 + ce_ref.abs())).all()
    f32 = weighted_ce.cross_entropy_bwd_plain(
        x_in.float().reshape(-1, shape[-1]), t_in.reshape(-1),
        weighted_ce.cross_entropy_fwd_plain(x_in.float().reshape(-1, shape[-1]),
                                            t_in.reshape(-1))[1], g.reshape(-1))
    got = grad[:, :-1] if sliced else grad
    rtol = 1e-5 + (torch.finfo(dtype).eps / 2 if dtype != torch.float32 else 0.0)
    err = (got.float().reshape(-1, shape[-1]) - f32).abs()
    assert (err <= 1e-6 + rtol * f32.abs()).all()
    if sliced:
        assert torch.all(grad[:, -1] == 0)


@pytest.mark.parametrize("n", [23_440_896, 1_000_003])
def test_lion_and_adafactor_kernels_match_plain(dev, n):
    from repro_torch.kernels import adafactor_adapt, lion_adapt

    rng = np.random.default_rng(n % 997)
    g, m, gm = (_randn(rng, (n,), torch.float32, dev) * 1e-2 for _ in range(3))
    vhat = _randn(rng, (n,), torch.float32, dev).square() * 1e-4
    lr = torch.tensor(1e-3, device=dev)
    dispatch.reset_launches()
    for fn, args, kw in ((lion_adapt.lion_adapt, (g, m, gm), dict(lr=lr, b1=0.9, delta=1e-3)),
                         (adafactor_adapt.adafactor_adapt, (vhat, gm), dict(lr=lr, eps=1e-8))):
        out, ss = fn(*args, **kw)
        torch.cuda.synchronize()
        ref, ref_ss = fn(*args, backend="plain", **kw)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(ss, ref_ss, rtol=1e-4, atol=0)
        # unaligned views take the kernel's scalar loop
        out1, _ = fn(*(a[1:] for a in args), **kw)
        torch.testing.assert_close(out1, ref[1:], rtol=1e-5, atol=1e-7)
    assert dispatch.launches("lion_adapt") == dispatch.launches("adafactor_adapt") == 2


def test_gemma_smoke_meta_step_goes_through_weighted_ce(dev):
    """A SAMA meta step of the gemma3 smoke model at V 8192 (above
    CE_VOCAB_THRESHOLD): weighted_ce forward K + 3 = 5 (K base steps, the
    meta pass, two central-difference passes) and backward K + 1 = 3 (the
    CD passes record no graph), and the step within the f32 tolerances of
    the same step with every kernel plain (base Adam eps 1e-3, warm rows:
    ROADMAP queue 3)."""
    from repro_torch import api, configs, optim, tree
    from repro_torch.core import problems
    from repro_torch.kernels import weighted_ce
    from repro_torch.models import Model

    cfg = configs.get_smoke_config("gemma3-1b").replace(vocab_size=8192)
    model = Model(cfg, device=dev)
    K, B, S = 2, 4, 64
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    perms = np.stack([r.permutation(B) for _ in range(K)])
    base = {"tokens": torch.from_numpy(toks[perms]).to(dev)}
    meta = {"tokens": torch.from_numpy(toks).to(dev)}
    learner = api.MetaLearner(problems.make_data_optimization_spec(model.per_example),
                              base_opt=optim.adam(1e-3, eps=1e-3), meta_opt="adam",
                              meta_lr=1e-3, method="sama", unroll_steps=K)
    state = learner.init(model.init(0), problems.init_data_optimization_lam(1, device=dev))
    dispatch.reset_launches()
    got_s, got = learner.step_fn(state, base, meta)
    assert dispatch.launches(weighted_ce.FWD) == K + 3
    assert dispatch.launches(weighted_ce.BWD) == K + 1
    with dispatch.plain_everywhere():
        ref_s, ref = learner.step_fn(state, base, meta)
    assert dispatch.launches(weighted_ce.FWD) == K + 3  # none added
    for key, rtol in (("base_loss", 1e-5), ("meta_loss", 1e-5), ("eps", 2e-3),
                      ("hypergrad_norm", 2e-3)):
        a, b = float(got[key]), float(ref[key])
        assert abs(a - b) <= rtol * abs(b) + 1e-7, (key, a, b)
    for x, y, y0 in zip(*(tree.tree_leaves(st.theta) for st in (got_s, ref_s, state))):
        assert (x - y).abs().max().item() <= 1e-6 + 0.05 * (y - y0).abs().max().item()


def test_adam_adapt_wrapper_rejects_bf16_and_strided(dev):
    x = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        adam_adapt.adam_adapt(x, x, x, x, t=1)
    y = torch.zeros(64, device=dev)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        adam_adapt.adam_adapt(y, y, y, y, t=1)


def test_meta_step_goes_through_the_kernels(dev):
    """SAMA meta steps of the bert-base smoke model (2 layers, K = 2), each
    from one state twice: through the kernels and with every kernel
    forced plain. Launches per step: L(K+3) forwards + L(K+1) remat
    recomputes, L(K+1) dq and dk/dv, one adam_adapt per theta leaf. The two
    agree as the port agrees with JAX (tests/test_torch_sama.py): losses
    1e-5, eps and hypergrad_norm 2e-3 relative, theta and lam per leaf
    within 1e-6 + 5% of the step's largest update. The K base batches are
    permutations of one set of sequences and the meta batch is that set, so
    every row the meta gradient touches has warm Adam moments (on a cold
    row the adaptation diagonal goes as 1/g^2 and the central difference
    follows rounding: ROADMAP queue 3). Run freely instead of from a shared
    state, two f32 trajectories part within a few meta steps."""
    from repro_torch import api, configs, tree
    from repro_torch.core import problems
    from repro_torch.models import Model

    cfg = configs.get_smoke_config("bert-base")
    model = Model(cfg, device=dev)
    spec = problems.make_data_optimization_spec(model.classifier_per_example)
    L, K, steps, B, S = cfg.num_layers, 2, 3, 8, 32

    def batches(i):
        r = np.random.default_rng(i)
        toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        perms = np.stack([r.permutation(B) for _ in range(K)])
        y = r.integers(0, 4, (K + 1, B)).astype(np.int32)
        base = {"tokens": torch.from_numpy(toks[perms]).to(dev),
                "y": torch.from_numpy(np.take_along_axis(y[:K], perms, 1)).to(dev)}
        meta = {"tokens": torch.from_numpy(toks).to(dev), "y": torch.from_numpy(y[K]).to(dev)}
        return base, meta

    learner = api.MetaLearner(spec, base_opt="adam", base_lr=1e-3, meta_opt="adam",
                              meta_lr=1e-3, method="sama", unroll_steps=K)
    state = learner.init(model.init(0), problems.init_data_optimization_lam(1, device=dev))
    n_leaves = len(tree.tree_leaves(state.theta))
    for i in range(steps):
        dispatch.reset_launches()
        got_s, got = learner.step_fn(state, *batches(i))
        assert dispatch.launches(flash_attn.FWD) == L * (K + 3) + L * (K + 1)
        assert dispatch.launches(flash_attn.DQ) == dispatch.launches(flash_attn.DKV) == L * (K + 1)
        assert dispatch.launches("adam_adapt") == n_leaves
        with dispatch.plain_everywhere():
            ref_s, ref = learner.step_fn(state, *batches(i))
        assert dispatch.launches(flash_attn.FWD) == L * (K + 3) + L * (K + 1)  # none added
        for key, rtol in (("base_loss", 1e-5), ("meta_loss", 1e-5), ("eps", 2e-3),
                          ("hypergrad_norm", 2e-3)):
            a, b = float(got[key]), float(ref[key])
            assert abs(a - b) <= rtol * abs(b) + 1e-7, (i, key, a, b)
        for field in ("theta", "lam"):
            leaves = zip(*(tree.tree_leaves(getattr(st, field)) for st in (got_s, ref_s, state)))
            for x, y, y0 in leaves:
                bound = 1e-6 + 0.05 * (y - y0).abs().max().item()
                assert (x - y).abs().max().item() <= bound, (field, i)
        state = ref_s
