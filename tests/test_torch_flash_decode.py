"""The port's split-KV decode (``repro_torch.kernels.flash_attn``) against
the JAX package's: its plain version against the Pallas kernel run in
interpret mode and against ``flash_decode_ref``, the split merge, the
cluster plan and the rows each block of a cluster takes, and device
routing. The CUDA kernel itself runs only on
a card (``-m cuda``); here every call takes the plain version because the
tensors lie on the CPU.

Tolerance: 1e-5 abs in f32 (tests/test_flash_attention.py FWD_TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attn as jax_fa  # noqa: E402
from repro_torch.kernels import dispatch, flash_attn  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = 1e-5


def _case(seed, B, T, H, KV, Dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dh)).astype(np.float32)
    # staggered per-lane positions: the last row, a middle one, the trash
    # lane's 0
    pos = np.array([[T - 1], [T // 2], [0]], np.int32)[:B]
    return q, k, v, pos


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 4), (30.0, 4)])
@pytest.mark.parametrize("G,T", [(1, 11), (2, 17), (4, 9)])
def test_plain_decode_matches_jax_kernel_and_ref(G, T, softcap, window, n_splits):
    KV, Dh = 2, 16
    q, k, v, pos = _case(G * 100 + T, 3, T, KV * G, KV, Dh)
    lf = True if window else None
    jlf = jnp.asarray(True) if window else None
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jlf)
    kw = dict(softcap=softcap, window=window)
    ref = np.asarray(jax_fa.flash_decode_ref(*jargs, **kw))
    kern = np.asarray(jax_fa.flash_decode(*jargs, interpret=True, n_splits=n_splits, **kw))
    got = flash_attn.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(pos), lf, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), kern, atol=TOL, rtol=0)


def test_window_off_when_layer_is_global():
    """local_flag False keeps the window out, as the traced flag does."""
    q, k, v, pos = _case(7, 3, 13, 4, 1, 8)
    t = [torch.from_numpy(x) for x in (q, k, v, pos)]
    glob = flash_attn.flash_decode(*t, False, window=3)
    none = flash_attn.flash_decode(*t, None, window=3)
    loc = flash_attn.flash_decode(*t, True, window=3)
    ref = jax_fa.flash_decode_ref(*[jnp.asarray(x) for x in (q, k, v, pos)],
                                  jnp.asarray(False), window=3)
    np.testing.assert_allclose(glob.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert torch.equal(glob, none)
    assert not torch.allclose(glob[:2], loc[:2])  # lanes past the window differ


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(0)
    o = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    lse = rng.standard_normal((3, 5, 4)).astype(np.float32)
    lse[0, 2:] = flash_attn.NEG  # empty splits
    lse[1] = flash_attn.NEG      # a fully masked row: zeros, not NaN
    o[1] = 0.0
    got = flash_attn.merge_partials(torch.from_numpy(o), torch.from_numpy(lse))
    ref = jax_fa.merge_partials(jnp.asarray(o), jnp.asarray(lse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    assert torch.all(got[1] == 0)


def test_merge_partials_is_single_pass_softmax():
    G, Dh, T = 4, 8, 10
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.standard_normal((G, T)).astype(np.float32))
    vv = torch.from_numpy(rng.standard_normal((T, Dh)).astype(np.float32))
    full = torch.softmax(s, -1) @ vv
    o_parts, lse_parts = [], []
    for lo, hi in [(0, 3), (3, 4), (4, 10)]:
        sl = s[:, lo:hi]
        m = sl.amax(-1)
        p = torch.exp(sl - m[:, None])
        l = p.sum(-1)
        o_parts.append((p @ vv[lo:hi]) / l[:, None])
        lse_parts.append(m + torch.log(l))
    got = flash_attn.merge_partials(torch.stack(o_parts), torch.stack(lse_parts))
    torch.testing.assert_close(got, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rows,bh", [(1024, 4), (512, 4), (256, 8), (16, 4), (1, 1),
                                     (4096, 1), (10**6, 1), (4096, 512), (100, 3)])
def test_decode_cluster_stays_within_the_card_limit(rows, bh):
    c = flash_attn.decode_cluster(rows, bh, max_cluster=16)  # an H100's limit
    assert 1 <= c <= 16
    assert c <= max(1, -(-rows // 64))  # no block below one 64-row chunk
    assert flash_attn.decode_cluster(rows, bh, max_cluster=8) <= 8  # what the card schedules


def test_decode_cluster_fills_the_card_at_serving_shapes():
    # serving: 4 lanes x 1 KV head. A global layer's 1024-row bucket takes
    # the widest cluster, a local layer's 512-row window half of it; the
    # lanes alone fill the card at 512 pairs
    # (an H100 schedules clusters of up to 16 of the kernel's blocks)
    assert flash_attn.decode_cluster(1024, 4, max_cluster=16) == 16
    assert flash_attn.decode_cluster(512, 4, max_cluster=16) == 8
    assert flash_attn.decode_cluster(16, 4, max_cluster=16) == 1
    assert flash_attn.decode_cluster(4096, 512, max_cluster=16) == 1


def _covered(t, pos, window, cluster):
    shares = flash_attn.decode_shares(pos, t, window, cluster)
    assert len(shares) == cluster
    lo = shares[0][0]
    seen = []
    for beg, end in shares:
        assert beg <= end
        if end > beg:
            assert (beg - lo) % flash_attn.SHARE_ROWS == 0
        seen.extend(range(beg, end))
    return seen


_SHARE_CASES = [
    (1024, 1023, 0), (1024, 700, 512), (1024, 300, 512),  # global and windowed
    (1024, 0, 0), (1024, 0, 512),                          # the trash lane: one row
    (1024, 1500, 512), (1024, 1600, 512), (64, 70, 0),     # pos >= T
    (5, 4, 0), (9, 8, 3),                                  # T shorter than the cluster
]


@pytest.mark.parametrize("cluster", [1, 3, 7, 8, 16])
@pytest.mark.parametrize("t,pos,window", _SHARE_CASES)
def test_decode_shares_cover_every_visible_row_once(t, pos, window, cluster):
    seen = _covered(t, pos, window, cluster)
    # in order, each once: the visible rows are the plain version's mask,
    # causal and in the window
    mask = attn.make_mask(torch.tensor([[pos]]), torch.arange(t), causal=True,
                          local_flag=bool(window), window=window)[0, 0, 0]
    assert seen == torch.nonzero(mask).flatten().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 3, 7, 8, 16])
def test_decode_shares_are_the_kernels(cluster):
    """The shares the CPU tests hold are the kernel's: its library's
    ``block_share`` gives the same [beg, end) at every case and at random
    positions and windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(cluster)
    cases = _SHARE_CASES + [(int(t), int(p), int(w)) for t, p, w in zip(
        rng.integers(1, 4096, 200), rng.integers(0, 5000, 200), rng.integers(0, 1024, 200))]
    for t, pos, window in cases:
        assert flash_attn.decode_kernel_shares(pos, t, window, cluster) == \
            flash_attn.decode_shares(pos, t, window, cluster), (t, pos, window)


@pytest.mark.parametrize("n", [0, 17, -1, 2.0, True])
def test_cluster_sizes_the_kernel_does_not_take_raise(n):
    with pytest.raises(ValueError, match="cluster size"):
        flash_attn._check_cluster(n, 16)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, pos = (torch.from_numpy(x) for x in _case(3, 2, 9, 4, 1, 8))
    dispatch.reset_launches()
    dispatch.clear_dispatch_log()
    got = flash_attn.flash_decode(q, k, v, pos, None)
    plain = flash_attn.flash_decode_plain(q, k, v, pos, None)
    assert torch.equal(got, plain)
    assert dispatch.dispatch_log() == [("flash_decode", "plain", "cpu tensor")]
    assert dispatch.launches("flash_decode") == 0  # no kernel was launched
    flash_attn.flash_decode(q, k, v, pos, None, backend="plain")
    assert dispatch.dispatch_log()[-1] == ("flash_decode", "plain", "forced")
    with pytest.raises(ValueError, match="backend"):
        flash_attn.flash_decode(q, k, v, pos, None, backend="triton")
    # a meta tensor takes the meta route: an empty output of the kernel's
    # shape and dtype, no launch (the dry run's trace)
    out = flash_attn.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"), pos.to("meta"))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert dispatch.dispatch_log()[-1] == ("flash_decode", "meta", "meta tensor")
    assert dispatch.launches("flash_decode") == 0


@pytest.mark.parametrize("bad,match", [
    (dict(q=(2, 2, 4, 8)), "q must be"),
    (dict(k=(2, 9, 3, 8)), "does not group"),
    (dict(q=(2, 1, 36, 8), k=(2, 9, 4, 8)), "G <= 8"),
    (dict(q=(2, 1, 4, 12), k=(2, 9, 1, 12)), "multiple of 8"),
    (dict(dtype=torch.float64), "dtypes"),
    (dict(pos=torch.int64), "int32"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(bad.get("q", (2, 1, 4, 8)), dtype=dtype)
    k = torch.zeros(bad.get("k", (2, 9, 1, 8)), dtype=dtype)
    pos = torch.zeros((2, 1), dtype=bad.get("pos", torch.int32))
    with pytest.raises(ValueError, match=match):
        flash_attn._check(q, k, k.clone(), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    B, T, KV, G, Dh = 4, 1024, 1, 4, 256
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dt)
               for s in [(B, 1, KV * G, Dh), (B, T, KV, Dh), (B, T, KV, Dh)])
    pos = torch.tensor([[1023], [700], [300], [0]], dtype=torch.int32, device="cuda")
    for local in (True, False):
        for n_splits in (1, 3, 8, 16, None):  # cluster sizes
            got = flash_attn.flash_decode(q, k, v, pos, local, window=512, softcap=50.0,
                                          n_splits=n_splits)
            plain = flash_attn.flash_decode(q, k, v, pos, local, window=512, softcap=50.0,
                                            backend="plain")
            assert (got.float() - plain.float()).abs().max().item() <= tol
