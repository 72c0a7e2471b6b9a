"""The tile skip of the port's bf16/f16 training attention kernels.

``flash_attn.live_tiles`` is the rule the kernels use (``tc::tile_state``
in csrc/attn_mma.cuh) to decide which (query tile, key tile) pairs a block
visits, and ``flash_attn.full_tiles`` its other half: the tiles run
without the elementwise mask. On the CPU: every tile ``live_tiles`` drops
holds no valid (query, key) pair under the JAX package's Pallas
``_tile_mask``, and every pair of a full tile within S and T is valid, for
any positions (ragged S and T, padding -1 on either side, S < T, the group
sizes that set the query tile) and any of the kernels' key tiles; for
``arange`` positions the numbers of live and full tiles equal the
closed-form causal and window counts. On the card (``-m cuda``): the tile
sizes the kernels' libraries report, and their own walk over the tiles
(``flash_attn.tc_visits``: the forward's and dq's from the query side,
dk/dv's from the key side) visits exactly the tiles ``live_tiles`` keeps
at those sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import flash_attn as jfa  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402

#: dq's and dk/dv's blocks hold 64 (query, head) rows, so 64 // G queries,
#: and their key tiles are 16, 32 or 64 keys (which one is the library's)
ROWS = 64
KEY_TILES = (16, 32, 64)
#: the forward's tiles: 128 rows (two warpgroups of 64), so 128 // G
#: queries, by 64 keys, or 16 at Dh 256
FWD_ROWS, FWD_KEY_TILES = 128, (16, 64)
#: each kernel's rows per block
KERNEL_ROWS = {flash_attn.FWD: FWD_ROWS, flash_attn.DQ: ROWS, flash_attn.DKV: ROWS}


def _valid(q_pos, kv_pos, causal, window):
    """(B, S, T) validity by the Pallas ``_tile_mask``, lane by lane, with
    the window engaged when ``window`` > 0."""
    kp = jnp.asarray(np.asarray(kv_pos), jnp.int32)
    rows = [np.asarray(jfa._tile_mask(jnp.asarray(row, jnp.int32), kp, causal=causal,
                                      window=window, use_window=window > 0, lf=jnp.int32(1)))
            for row in np.asarray(q_pos)]
    return torch.from_numpy(np.stack(rows))


def _pairs_per_tile(q_pos, kv_pos, bq, bk, causal, window):
    """(B, tiles over S, tiles over T) count of valid pairs."""
    valid = _valid(q_pos, kv_pos, causal, window)
    b, s, t = valid.shape
    nq, nk = -(-s // bq), -(-t // bk)
    padded = torch.zeros((b, nq * bq, nk * bk), dtype=torch.int64)
    padded[:, :s, :t] = valid.long()
    return padded.reshape(b, nq, bq, nk, bk).sum(dim=(2, 4))


def _check_dropped_tiles_are_empty(q_pos, kv_pos, bq, bk, causal, window):
    live = flash_attn.live_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
    pairs = _pairs_per_tile(q_pos, kv_pos, bq, bk, causal, window)
    assert live.shape == pairs.shape and live.dtype == torch.bool
    assert int(pairs[~live].sum()) == 0, "a dropped tile holds a valid pair"
    return live, pairs


def _check_full_tiles_are_all_valid(q_pos, kv_pos, bq, bk, causal, window):
    """Every (query within S, key within T) pair of a full tile is valid:
    the kernels run such a tile with no elementwise mask."""
    full = flash_attn.full_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
    live = flash_attn.live_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
    pairs = _pairs_per_tile(q_pos, kv_pos, bq, bk, causal, window)
    b, s = q_pos.shape
    t = kv_pos.shape[0]
    rows = (torch.arange(pairs.shape[1] * bq) < s).reshape(-1, bq).sum(-1)
    keys = (torch.arange(pairs.shape[2] * bk) < t).reshape(-1, bk).sum(-1)
    size = (rows[:, None] * keys[None, :]).expand_as(pairs)
    assert full.shape == pairs.shape and full.dtype == torch.bool
    assert bool((pairs[full] == size[full]).all()), "a full tile holds an invalid pair"
    assert not bool((full & ~live).any()), "a full tile the walk skips"
    return full


def _positions(b, s, t, *, q_pad=(), k_pad=()):
    q_pos = (torch.arange(s) + (t - s))[None].repeat(b, 1)
    kv_pos = torch.arange(t)
    for lane, lo, hi in q_pad:
        q_pos[lane, lo:hi] = -1
    for lo, hi in k_pad:
        kv_pos[lo:hi] = -1
    return q_pos, kv_pos


# (B, S, T, G, causal, window, query padding (lane, lo, hi), key padding (lo, hi))
CASES = [
    (2, 300, 333, 4, True, 128, (), ()),                         # ragged, S < T
    (2, 1024, 1024, 4, True, 512, (), ()),                       # gemma3-1b local
    (2, 1024, 1024, 4, True, 0, (), ()),                         # gemma3-1b global
    (3, 128, 128, 1, False, 0, (), ()),                          # bert-base
    (2, 170, 250, 4, True, 0, ((1, 32, 96),), ((64, 192),)),     # whole tiles padded
    (2, 77, 91, 3, True, 17, ((0, 0, 5),), ((0, 3), (80, 91))),  # padding at both ends
    (1, 45, 45, 3, False, 0, ((0, 40, 45),), ((10, 30),)),       # non-causal, padded
    (2, 33, 200, 1, True, 0, ((1, 0, 33),), ()),                 # a lane all padding
]


@pytest.mark.parametrize("bk", KEY_TILES)
@pytest.mark.parametrize("case", CASES)
def test_dropped_tiles_hold_no_valid_pair(case, bk):
    _check_dropped(case, ROWS, bk)


@pytest.mark.parametrize("bk", FWD_KEY_TILES)
@pytest.mark.parametrize("case", CASES)
def test_dropped_tiles_hold_no_valid_pair_at_the_forward_tile(case, bk):
    _check_dropped(case, FWD_ROWS, bk)


def _check_dropped(case, rows, bk):
    b, s, t, g, causal, window, q_pad, k_pad = case
    bq = rows // g
    q_pos, kv_pos = _positions(b, s, t, q_pad=q_pad, k_pad=k_pad)
    live, pairs = _check_dropped_tiles_are_empty(q_pos, kv_pos, bq, bk, causal, window)
    if q_pad and q_pad[0][1] == 0 and q_pad[0][2] == s:  # a lane of padding only
        assert not live[q_pad[0][0]].any()
    if k_pad == ((64, 192),):  # whole key tiles of padding are never visited
        assert not live[:, :, 64 // bk:192 // bk].any()
    # a tile is visited whenever it holds a valid pair (these positions are
    # monotone, so the min / max rule is exact)
    assert bool(live[pairs > 0].all())


def _closed_form(s, t, bq, bk, causal, window):
    """Live tiles for q_pos = arange(S) + (T - S), kv_pos = arange(T):
    query tile i spans positions lo..hi; key tile j is live when its first
    key is at most hi (causal) and its last key lies within the window of
    lo."""
    off = t - s
    nq, nk = -(-s // bq), -(-t // bk)
    total = 0
    for i in range(nq):
        lo, hi = off + i * bq, off + min((i + 1) * bq, s) - 1
        j_max = min(hi // bk, nk - 1) if causal else nk - 1
        j_min = max(0, (lo - window + 1) // bk) if window else 0
        total += max(0, j_max - j_min + 1)
    return total


@pytest.mark.parametrize("bk", KEY_TILES)
@pytest.mark.parametrize("case", CASES)
def test_full_tiles_hold_only_valid_pairs(case, bk):
    _check_full(case, ROWS, bk)


@pytest.mark.parametrize("bk", FWD_KEY_TILES)
@pytest.mark.parametrize("case", CASES)
def test_full_tiles_hold_only_valid_pairs_at_the_forward_tile(case, bk):
    _check_full(case, FWD_ROWS, bk)


def _check_full(case, rows, bk):
    b, s, t, g, causal, window, q_pad, k_pad = case
    q_pos, kv_pos = _positions(b, s, t, q_pad=q_pad, k_pad=k_pad)
    full = _check_full_tiles_are_all_valid(q_pos, kv_pos, rows // g, bk, causal, window)
    if not (q_pad or k_pad or t % bk):  # no padding: some tile is full
        assert bool(full.any())


def _closed_form_full(s, t, bq, bk, causal, window):
    """Full tiles for the positions of ``_closed_form``: key tile j lies
    within T, and (causal) its last key is at most lo, and its first key
    lies within the window of hi."""
    off = t - s
    total = 0
    for i in range(-(-s // bq)):
        lo, hi = off + i * bq, off + min((i + 1) * bq, s) - 1
        for j in range(t // bk):
            total += (not causal or (j + 1) * bk - 1 <= lo) and (not window
                                                                 or hi - j * bk < window)
    return total


CLOSED_FORM_CASES = [
    (1024, 1024, 4, True, 0),
    (1024, 1024, 4, True, 512),
    (128, 128, 1, False, 0),
    (300, 333, 4, True, 128),
    (61, 500, 3, True, 100),
    (200, 200, 8, True, 5),
]


@pytest.mark.parametrize("s,t,g,causal,window", CLOSED_FORM_CASES)
@pytest.mark.parametrize("bk", KEY_TILES)
def test_live_count_equals_the_closed_form(s, t, g, causal, window, bk):
    _check_closed_form(s, t, g, causal, window, ROWS, bk)


@pytest.mark.parametrize("s,t,g,causal,window", CLOSED_FORM_CASES)
@pytest.mark.parametrize("bk", FWD_KEY_TILES)
def test_live_count_equals_the_closed_form_at_the_forward_tile(s, t, g, causal, window, bk):
    _check_closed_form(s, t, g, causal, window, FWD_ROWS, bk)


def _check_closed_form(s, t, g, causal, window, rows, bk):
    bq = rows // g
    q_pos, kv_pos = _positions(2, s, t)
    live = flash_attn.live_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
    assert int(live.sum()) == 2 * _closed_form(s, t, bq, bk, causal, window)
    full = flash_attn.full_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
    assert int(full.sum()) == 2 * _closed_form_full(s, t, bq, bk, causal, window)


def test_gemma_global_layer_visits_about_half_its_tiles():
    """At gemma3-1b's global layer (S = T = 1024, G 4) in 16-query by
    32-key tiles (dk/dv's at Dh 256): (64 query tiles) x (32 key tiles) in
    all, of which 1,056 per lane hold a causal pair; in the forward's
    32-query by 16-key tiles, 1,056 of 32 x 64."""
    q_pos, kv_pos = _positions(1, 1024, 1024)
    live = flash_attn.live_tiles(q_pos, kv_pos, 16, 32, causal=True, window=0)
    assert live.shape == (1, 64, 32)
    assert int(live.sum()) == sum(i // 2 + 1 for i in range(64)) == 1056
    live = flash_attn.live_tiles(q_pos, kv_pos, FWD_ROWS // 4, 16, causal=True, window=0)
    assert live.shape == (1, 32, 64)
    assert int(live.sum()) == sum(2 * i + 2 for i in range(32)) == 1056


@st.composite
def _layouts(draw):
    b = draw(st.integers(1, 3))
    s = draw(st.integers(1, 90))
    t = draw(st.integers(1, 120))
    bq = draw(st.sampled_from([8, 9, 16, 21, 32, 64]))
    bk = draw(st.sampled_from(KEY_TILES))
    causal = draw(st.booleans())
    window = draw(st.sampled_from([0, 1, 5, 33, 200]))
    seed = draw(st.integers(0, 2**31 - 1))
    monotone = draw(st.booleans())
    return b, s, t, bq, bk, causal, window, seed, monotone


def _random_positions(rng, b, s, t, monotone):
    """Positions with padding scattered on both sides; monotone rows like
    a batch's, or any order."""
    if monotone:
        q_pos = np.sort(rng.integers(0, t + 10, size=(b, s)), axis=1)
        kv_pos = np.arange(t)
    else:
        q_pos = rng.integers(0, t + 10, size=(b, s))
        kv_pos = rng.integers(0, t + 10, size=t)
    q_pos[rng.random((b, s)) < 0.2] = -1
    kv_pos[rng.random(t) < 0.2] = -1
    return torch.from_numpy(q_pos), torch.from_numpy(kv_pos)


@settings(max_examples=60, deadline=None)
@given(_layouts())
def test_dropped_tiles_hold_no_valid_pair_property(layout):
    """Any positions, monotone or not, with padding scattered on both sides."""
    b, s, t, bq, bk, causal, window, seed, monotone = layout
    q_pos, kv_pos = _random_positions(np.random.default_rng(seed), b, s, t, monotone)
    _check_dropped_tiles_are_empty(q_pos, kv_pos, bq, bk, causal, window)


@settings(max_examples=60, deadline=None)
@given(_layouts())
def test_full_tiles_hold_only_valid_pairs_property(layout):
    """Any positions, monotone or not, with padding scattered on both sides."""
    b, s, t, bq, bk, causal, window, seed, monotone = layout
    q_pos, kv_pos = _random_positions(np.random.default_rng(seed), b, s, t, monotone)
    _check_full_tiles_are_all_valid(q_pos, kv_pos, bq, bk, causal, window)


def test_tc_helpers_refuse_what_no_kernel_takes():
    """A kernel with no tensor-core route (the decode kernel) has no tiles
    to report, and the walk takes positions on the card only: both refused
    before any library is built."""
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        flash_attn.tc_tiles("flash_decode", 1, 64)
    q_pos, kv_pos = _positions(1, 8, 8)
    with pytest.raises(ValueError, match="cuda tensors"):
        flash_attn.tc_visits(flash_attn.FWD, q_pos, kv_pos, 1, 1, 64, causal=True, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [flash_attn.FWD, flash_attn.DQ, flash_attn.DKV])
def test_tc_tiles_follow_the_kernels(kernel):
    """On the card: the library's tile sizes, and its walk over the tiles
    (run alone; dk/dv's from the key side) visits exactly the tiles
    ``live_tiles`` keeps at those sizes, summed over lanes and KV heads, at
    every case above and at random positions, for each head dim the
    kernels are built for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' walk runs only there")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    layouts = [(b, s, t, g, causal, window, *_positions(b, s, t, q_pad=q_pad, k_pad=k_pad))
               for b, s, t, g, causal, window, q_pad, k_pad in CASES]
    layouts += [(2, 70, 130, g, causal, window, *_random_positions(rng, 2, 70, 130, mono))
                for g, causal, window, mono in ((1, True, 0, False), (3, True, 33, True),
                                                (4, False, 0, False), (8, True, 5, False))]
    for dh, kv in ((8, 2), (64, 1), (128, 1), (256, 2)):
        for b, s, t, g, causal, window, q_pos, kv_pos in layouts:
            bq, bk = flash_attn.tc_tiles(kernel, g, dh)
            assert bq == KERNEL_ROWS[kernel] // g and bk in KEY_TILES
            live = flash_attn.live_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)
            walk = flash_attn.tc_visits(kernel, q_pos.to(dev), kv_pos.to(dev), kv, g, dh,
                                        causal=causal, window=window)
            assert walk == kv * int(live.sum()), (dh, kv, b, s, t, g, causal, window)
