"""The port's training kernels against their plain PyTorch versions on the
card: the flash-attention forward and its dq and dk/dv backward kernels
(through autograd), and the Adam adaptation product; then one SAMA meta
step of the bert-base smoke model through the kernels, against the same
step with every kernel forced to its plain version, with each kernel's
launches counted.

Every test here needs a CUDA card (``-m cuda``) and skips without one:
the CUDA kernels have no CPU mode. This file imports no JAX, so it runs on
a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: flash forward 1e-5 and VJP 5e-5 in f32, 2e-2 in bf16
(tests/test_flash_attention.py); adam_adapt out rtol 1e-5 / atol 1e-7 and
sum of squares rtol 1e-4 (tests/test_kernels.py).
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


def test_weighted_ce_route_raises_on_the_card(dev):
    """At CE_VOCAB_THRESHOLD classes the per-example CE takes the
    weighted_ce kernel, not ported yet: a CUDA tensor raises instead of
    computing the plain CE on the card."""
    from repro_torch.core import problems

    logits = torch.zeros((2, dispatch.CE_VOCAB_THRESHOLD), device=dev)
    y = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="weighted_ce"):
        problems.softmax_per_example(lambda th, x: x)(None, {"x": logits, "y": y})


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
