"""Flash attention of the port: the CUDA kernels' wrappers, their plain
PyTorch versions and, for decode, the cluster plan, the row shares and
the split merge.

Counterpart of ``src/repro/kernels/flash_attn.py``:

* training (``flash_attention``): on CUDA tensors a
  ``torch.autograd.Function``, first order only, whose forward is
  ``csrc/flash_attn_fwd.cu`` (blockwise online softmax, saving ``out``
  and ``lse``) and whose backward is the two recompute kernels of
  ``csrc/flash_attn_bwd.cu`` (dq; dk and dv summed over the query group).
  In bf16 and f16 all three run on the tensor cores and visit only the
  tiles :func:`live_tiles` keeps (tile sizes :func:`tc_tiles`, the walk's
  own count :func:`tc_visits`), skipping the elementwise mask on the
  tiles :func:`full_tiles` marks; f32 runs on the CUDA cores. Like the
  JAX custom VJP it saves only ``(q, k, v, out, lse)`` and the positions.
  Its plain versions are ``flash_attention_ref``'s ops (which also give
  the lse) and the recompute of ``_bwd_tile`` in torch ops. CPU tensors
  take the plain forward's ops under autograd, differentiable to any
  order, as the JAX package's ``ref`` twin.
* decode (``flash_decode``): ``csrc/flash_decode.cu``, one launch whose
  thread-block clusters split each lane's visible rows
  (:func:`decode_shares`) and merge the splits in shared memory (the math
  of :func:`merge_partials`).

One combination is refused: ``causal=False`` with an engaged window. The
JAX ``ref`` twin drops the window when non-causal while its Pallas kernel
keeps it (ROADMAP queue 3), so there is no one answer to port; no path of
the system uses it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, dispatch

NEG = -1e30
_TINY = 1e-30

#: streaming multiprocessors of an H100 SXM
NUM_SMS = 132

#: the kernels' limits (csrc/attn_common.cuh: kMaxGroup, kMaxDh)
MAX_GROUP = 8
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


#: a decode block's share of the visible rows is a multiple of this
#: (csrc/flash_decode.cu kShareRows; ``decode_kernel_shares`` holds the
#: kernel's own arithmetic)
SHARE_ROWS = 16


def decode_cluster(rows: int, bh: int, *, max_cluster: int) -> int:
    """Cluster size (splits) of the decode kernel for ``bh = B * KV``
    (lane, KV head) pairs that each see up to ``rows`` rows (the bucket
    length, or the window on a local layer), at most ``max_cluster`` (what
    the card schedules: :func:`decode_max_cluster`).

    A cluster's blocks split a lane's visible rows and merge through each
    other's shared memory, so more blocks cost a longer merge. No block
    gets fewer than 64 rows (one chunk of the 2-byte kernel: at 32 rows a
    block the local layer measured no faster), and splitting stops once the
    pairs fill half the card's SMs; a block holds ~160 KB of shared
    memory, so one runs per SM. Serving runs B * KV = slots x 1 = 4 to 8
    pairs, so the splits fill the card."""
    by_rows = max(1, math.ceil(rows / 64))
    want = max(1, math.ceil(NUM_SMS / 2 / max(bh, 1)))
    return max(1, min(by_rows, want, max_cluster))


def decode_shares(pos: int, t: int, window: int, cluster: int):
    """[beg, end) of each block of a ``cluster`` over the rows a lane at
    position ``pos`` sees, [lo, hi) = [max(0, pos - window + 1), min(pos +
    1, t)) (``window`` > 0 engaged): an equal share, rounded up to
    ``SHARE_ROWS`` rows, in rank order; the last blocks' shares may be
    empty. What ``block_share`` in csrc/flash_decode.cu computes on the
    card; :func:`decode_kernel_shares` runs that."""
    hi = max(0, min(pos + 1, t))
    lo = min(hi, max(0, pos - window + 1)) if window > 0 else 0
    share = -(-(hi - lo) // cluster)  # ceil
    per = -(-share // SHARE_ROWS) * SHARE_ROWS
    shares = []
    for rank in range(cluster):
        beg = min(hi, lo + rank * per)
        shares.append((beg, min(hi, beg + per)))
    return shares


def merge_partials(o, lse):
    """Two-stage softmax combine: ``o`` is (..., n_splits, G, Dh) of
    *normalized* partial outputs, ``lse`` (..., n_splits, G) their
    log-sum-exps (NEG for empty splits). Returns (..., G, Dh)."""
    m = torch.amax(lse, dim=-2, keepdim=True)
    w = torch.exp(lse - m)                     # empty splits: exp(NEG-m)->0
    denom = torch.sum(w, dim=-2)
    out = torch.sum(w[..., None] * o, dim=-3)
    return out / torch.clamp_min(denom, _TINY)[..., None]


def flash_decode_plain(q, k, v, q_pos, local_flag=None, *, softcap=0.0, window=0):
    """The plain version: the model's own decode ops, ``make_mask`` over
    ``arange(T)`` and ``_sdpa``."""
    from repro_torch.models import attention as attn  # lazy: import cycle

    t = k.shape[1]
    mask = attn.make_mask(q_pos, torch.arange(t, device=k.device), causal=True,
                          local_flag=local_flag, window=window)
    return attn._sdpa(q, k, v, mask, softcap=softcap)


def flash_decode(q, k, v, q_pos, local_flag=None, *, softcap=0.0, window=0,
                 n_splits=None, backend=None):
    """Split-KV decode: q (B, 1, H, Dh), k/v (B, T, KV, Dh), q_pos (B, 1)
    per-lane positions. Inference-only. Returns (B, 1, H, Dh) in q's dtype.

    CUDA tensors launch the kernel: one launch, ``n_splits`` blocks per
    (lane, KV head) forming one thread-block cluster that merges its
    splits (default :func:`decode_cluster`; a size the card cannot take
    raises ``ValueError``). CPU tensors (or ``backend="plain"``) take
    :func:`flash_decode_plain`."""
    if dispatch.route("flash_decode", q, backend) == dispatch.PLAIN:
        return flash_decode_plain(q, k, v, q_pos, local_flag, softcap=softcap,
                                  window=window)
    return _flash_decode_cuda(q, k, v, q_pos, local_flag, softcap=softcap,
                              window=window, n_splits=n_splits)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = build.load("flash_decode")
    lib.flash_decode_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_max_cluster.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_decode_max_cluster.restype = ctypes.c_int
    lib.flash_decode_shares.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_decode_shares.restype = ctypes.c_int
    return lib


def decode_kernel_shares(pos: int, t: int, window: int, cluster: int):
    """:func:`decode_shares` as the kernel's library computes them (its
    ``block_share``, run on the host). Needs the card's toolchain: the
    library is built to ask it."""
    buf = (ctypes.c_int * (2 * cluster))()
    if _lib().flash_decode_shares(pos, t, window, cluster, buf) != 0:
        raise ValueError(f"flash_decode: no cluster of {cluster} blocks over T={t}")
    return [(buf[2 * r], buf[2 * r + 1]) for r in range(cluster)]


@functools.lru_cache(maxsize=None)
def decode_max_cluster(dh: int, dtype: torch.dtype) -> int:
    """The largest cluster the decode kernel takes at head dim ``dh`` and
    ``dtype`` on this card (what ``cudaOccupancyMaxActiveClusters`` can
    schedule, at most 16). Needs the card."""
    n = _lib().flash_decode_max_cluster(dh, _DTYPE_CODES[dtype])
    if n < 1:
        raise ValueError(f"flash_decode: the card schedules no cluster of the kernel at "
                         f"Dh={dh} {dtype} (code {n})")
    return n


def _check(q, k, v, q_pos):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode: q must be (B, 1, H, Dh), got {tuple(q.shape)}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: k and v must be one (B, T, KV, Dh) shape, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    b, _, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kv < 1 or h % kv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not group over "
                         f"k {tuple(k.shape)}")
    if h // kv > MAX_GROUP or dh > MAX_HEAD_DIM or dh % 8:
        raise ValueError(f"flash_decode: the kernel takes G <= {MAX_GROUP} and Dh a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got G={h // kv}, Dh={dh}")
    if b * kv > 65535:
        raise ValueError(f"flash_decode: B * KV = {b * kv} exceeds the grid's 65535")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
                         "kernel takes one of float32, bfloat16, float16")
    if q_pos.dtype != torch.int32 or q_pos.numel() != b:
        raise ValueError(f"flash_decode: q_pos must be {b} int32 positions, got "
                         f"{q_pos.dtype} {tuple(q_pos.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_decode: {name} is on {x.device}, not {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
        if name != "q_pos" and x.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned (the kernel "
                             "stages rows with 16-byte cp.async copies)")


def _check_cluster(n, limit):
    if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= limit:
        raise ValueError(f"flash_decode: n_splits={n!r} is no cluster size this card takes "
                         f"for the kernel (1 to {limit})")


def _flash_decode_cuda(q, k, v, q_pos, local_flag, *, softcap, window, n_splits):
    _check(q, k, v, q_pos)
    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    use_window = int(window) if (window and local_flag is not None
                                 and bool(local_flag)) else 0
    limit = decode_max_cluster(dh, q.dtype)
    if n_splits is None:
        n_splits = decode_cluster(min(t, use_window) if use_window else t, b * kv,
                                  max_cluster=limit)
    _check_cluster(n_splits, limit)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        b, t, kv, h // kv, dh, n_splits, use_window, float(softcap or 0.0),
        1.0 / math.sqrt(dh), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA error {err}")
    dispatch.count_launch("flash_decode")
    return out


# ---------------------------------------------------------------------------
# training: blockwise attention, forward and recompute backward
# ---------------------------------------------------------------------------

#: the training kernels' launch counters (``dispatch.launches``)
FWD, DQ, DKV = "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"


#: the bf16/f16 kernels' libraries and the prefix of their C entry points
_TC = {FWD: ("flash_attn_fwd", "flash_attn_fwd"), DQ: ("flash_attn_bwd", "flash_attn_dq"),
       DKV: ("flash_attn_bwd", "flash_attn_dkv")}


@functools.lru_cache(maxsize=None)
def _tc_fn(kernel, what):
    if kernel not in _TC:
        raise ValueError(f"{kernel!r} has no tensor-core kernel")
    source, prefix = _TC[kernel]
    fn = getattr(build.load(source), f"{prefix}_{what}")
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2 if what == "tiles"
                   else [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def tc_tiles(kernel, g, dh):
    """(queries, keys) per tile of the bf16/f16 ``kernel`` (FWD, DQ or DKV)
    at group size ``g`` and head dim ``dh``, as its library reports them (a
    query tile holds all g heads of its queries; the key tile shrinks as Dh
    grows). FWD and DQ blocks own a query tile and walk key tiles, DKV
    blocks own a key tile and walk query tiles. Needs the card's toolchain:
    the library is built to ask it."""
    bq, bk = ctypes.c_int(), ctypes.c_int()
    err = _tc_fn(kernel, "tiles")(g, dh, ctypes.byref(bq), ctypes.byref(bk))
    if err != 0:
        raise ValueError(f"tc_tiles: {kernel} takes no G={g}, Dh={dh} (CUDA error {err})")
    return bq.value, bk.value


def tc_visits(kernel, q_pos, kv_pos, kv, g, dh, *, causal, window):
    """(query tile, key tile) pairs the blocks of the bf16/f16 ``kernel``
    (FWD, DQ or DKV) visit at these positions (cuda int32 q_pos (B, S),
    kv_pos (T,)), summed over the lanes and the ``kv`` heads: the kernel's
    own walk over its tiles (``tc::visit_kernel``, ``visit_dkv_kernel``)
    run alone, with nothing loaded or multiplied.
    ``window`` > 0 is an engaged window, as at the kernels' C calls."""
    if q_pos.dim() != 2 or kv_pos.dim() != 1 or q_pos.device.type != "cuda" \
            or kv_pos.device != q_pos.device:
        raise ValueError(f"tc_visits: q_pos (B, S) and kv_pos (T,) must be cuda tensors on one "
                         f"device, got {tuple(q_pos.shape)} on {q_pos.device}, "
                         f"{tuple(kv_pos.shape)} on {kv_pos.device}")
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    (b, s), t = q_pos.shape, kv_pos.shape[0]
    count = torch.zeros(1, dtype=torch.int64, device=q_pos.device)
    err = _tc_fn(kernel, "visits")(
        q_pos.data_ptr(), kv_pos.data_ptr(), b, s, t, kv, g, dh, int(causal), int(window),
        count.data_ptr(), torch.cuda.current_stream(q_pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tc_visits: {kernel} walk failed with CUDA error {err}")
    return int(count.item())


def live_tiles(q_pos, kv_pos, bq, bk, *, causal, window):
    """Which (query tile, key tile) pairs the bf16/f16 kernels visit: (B,
    ceil(S / bq), ceil(T / bk)) bool. Over the valid (>= 0) positions of a
    query tile of lane b and of a key tile, a tile is skipped when it has
    no valid query or no valid key, or ``causal`` and min(key) > max(query),
    or ``window`` > 0 and min(query) - max(key) >= window; then no pair of
    it passes ``_tile_valid``. The rule of ``tc::tile_state`` in
    csrc/attn_mma.cuh; ``tc_tiles`` gives the kernels' tile sizes and
    ``tc_visits`` counts what their walk visits."""
    return _tile_spans(q_pos, kv_pos, bq, bk, causal=causal, window=window)[0]


def full_tiles(q_pos, kv_pos, bq, bk, *, causal, window):
    """Which tiles the bf16/f16 kernels take as full, running them without
    the elementwise mask: (B, ceil(S / bq), ceil(T / bk)) bool, the other
    half of ``tc::tile_state``. A live tile is full when every query of it
    within S and every key of it has a valid position, the key tile ends
    within T, and ``causal`` max(key) <= min(query), and ``window`` > 0
    max(query) - min(key) < window: then every such pair passes
    ``_tile_valid``. (Rows past S are staged as zeros and never stored or
    summed.)"""
    return _tile_spans(q_pos, kv_pos, bq, bk, causal=causal, window=window)[1]


def _tile_spans(q_pos, kv_pos, bq, bk, *, causal, window):
    """(live, full) of every tile, as ``tc::tile_state`` classifies them."""
    q_pos = torch.as_tensor(q_pos).long()
    kv_pos = torch.as_tensor(kv_pos).long()
    b, s = q_pos.shape
    t = kv_pos.shape[0]
    nq, nk = -(-s // bq), -(-t // bk)
    qp = torch.nn.functional.pad(q_pos, (0, nq * bq - s), value=-1).reshape(b, nq, bq)
    kp = torch.nn.functional.pad(kv_pos, (0, nk * bk - t), value=-1).reshape(nk, bk)
    in_s = (torch.arange(nq * bq, device=q_pos.device) < s).reshape(nq, bq)
    far = 1 << 40  # above every position, so no difference overflows
    q_ok, k_ok = qp >= 0, kp >= 0
    q_lo = torch.where(q_ok, qp, far).amin(-1)[:, :, None]
    q_hi = torch.where(q_ok, qp, -1).amax(-1)[:, :, None]
    k_lo = torch.where(k_ok, kp, far).amin(-1)[None, None, :]
    k_hi = torch.where(k_ok, kp, -1).amax(-1)[None, None, :]
    live = q_ok.any(-1)[:, :, None] & k_ok.any(-1)[None, None, :]
    full = (q_ok | ~in_s).all(-1)[:, :, None] & k_ok.all(-1)[None, None, :]
    if causal:
        live = live & (k_lo <= q_hi)
        full = full & (k_hi <= q_lo)
    if window:
        live = live & (q_lo - k_hi < window)
        full = full & (q_hi - k_lo < window)
    return live, live & full


def _tile_valid(q_pos, kv_pos, *, causal, window):
    """(B, 1, 1, S, T) validity, the Pallas ``_tile_mask``: positions < 0
    are padding, causality optional, the window when engaged."""
    qp = q_pos[:, :, None].long()
    kp = kv_pos[None, None, :].long()
    valid = (kp >= 0) & (qp >= 0)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & ((qp - kp) < window)
    return valid[:, None, None]


def flash_attention_fwd_plain(q, k, v, q_pos, kv_pos, *, softcap=0.0, window=0,
                              causal=True, chunk=0):
    """The plain forward: ``flash_attention_ref``'s ops (``_sdpa`` with the
    causal mask or, non-causal, none; ``_chunked_sdpa`` when ``chunk`` and
    S > chunk), returning (out, lse) with lse (B*KV, G, S) f32 from the
    same scores. ``window`` is the engaged window (0 on global layers)."""
    from repro_torch.models import attention as attn  # lazy: import cycle

    b, s, h, dh = q.shape
    kv = k.shape[2]
    if chunk and s > chunk:
        out, lse = attn._chunked_sdpa(q.reshape(b, s, kv, h // kv, dh), k, v, q_pos, kv_pos,
                                      chunk=chunk, softcap=softcap, local_flag=True,
                                      window=window, causal=causal)
    else:
        mask = (attn.make_mask(q_pos, kv_pos, causal=True, local_flag=True, window=window)
                if causal else None)
        out, lse = attn._sdpa(q, k, v, mask, softcap=softcap, return_lse=True)
    return out, lse.reshape(b * kv, h // kv, s)


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, lse, delta, g_out, *, softcap=0.0,
                              window=0, causal=True):
    """The plain backward: the Pallas ``_bwd_tile`` recompute over the whole
    (S, T) score matrix in f32. ``lse`` (B*KV, G, S) from the forward,
    ``delta`` = rowsum(g_out * out) (B, S, H) f32. Returns (dq, dk, dv) in
    the inputs' dtypes; dk and dv summed over the query group."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, s, kv, g, dh)
    dof = g_out.float().reshape(b, s, kv, g, dh)
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    if softcap:
        tt = torch.tanh(raw / softcap)
        x = softcap * tt
        dcap = 1.0 - tt * tt
    else:
        x, dcap = raw, 1.0
    valid = _tile_valid(q_pos, kv_pos, causal=causal, window=window)
    lse4 = lse.reshape(b, kv, g, s)
    lse_safe = torch.where(lse4 <= NEG, 0.0, lse4)
    p = torch.where(valid, torch.exp(x - lse_safe[..., None]), 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
    delta4 = delta.reshape(b, s, kv, g).permute(0, 2, 3, 1)
    ds = p * (dp - delta4[..., None]) * dcap * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(b, s, h, dh)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_plain_vjp(q, k, v, q_pos, kv_pos, g_out, *, softcap=0.0, window=0,
                              causal=True, chunk=0):
    """The CUDA route's two passes in plain versions: the plain forward's
    (out, lse), then ``flash_attention_bwd_plain`` from that lse with
    delta = rowsum(g_out * out) in f32. Returns (out, dq, dk, dv): what the
    kernels are held against on the card (``chip_smoke.py``, the ``cuda``
    tests). ``window`` is the engaged window. Not differentiable."""
    with torch.no_grad():
        out, lse = flash_attention_fwd_plain(q, k, v, q_pos, kv_pos, softcap=softcap,
                                             window=window, causal=causal, chunk=chunk)
        delta = torch.sum(g_out.float() * out.float(), dim=-1)
        grads = flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, lse, delta, g_out,
                                          softcap=softcap, window=window, causal=causal)
    return (out, *grads)


class _FlashAttention(torch.autograd.Function):
    """The CUDA route: the forward kernel saves (q, k, v, out, lse) and the
    positions; the backward kernels recompute the probabilities from lse,
    as the JAX custom VJP does. First order only: the saved lse is no
    function of the inputs to autograd, so a second derivative through it
    would be wrong, and ``dispatch.first_order_only`` raises instead (the
    JAX package's Pallas path raises there too)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, softcap, window, causal):
        opts = dict(softcap=softcap, window=window, causal=causal)
        out, lse = _fwd_cuda(q, k, v, q_pos, kv_pos, **opts)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        g_out = g_out.contiguous()
        # delta = rowsum(dO * O) in f32, outside the kernels as in JAX
        delta = torch.sum(g_out.float() * out.float(), dim=-1)
        grads = _bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, g_out, **ctx.opts)
        dq, dk, dv = dispatch.first_order_only("flash_attention", (q, k, v, g_out), grads)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, local_flag=None, *, softcap=0.0, window=0,
                    causal=True, chunk=0, backend=None):
    """Blockwise flash attention, differentiable.

    q (B, S, H, Dh); k, v (B, T, KV, Dh) with H % KV == 0; q_pos (B, S) and
    kv_pos (T,) integer positions (-1 = padding); ``local_flag`` (a Python
    bool per layer) engages the sliding ``window``. Returns (B, S, H, Dh)
    in q's dtype. CUDA tensors launch the kernels in both passes (first
    order only: a second derivative raises). CPU tensors (or
    ``backend="plain"``) take the plain forward's ops under autograd, as
    the JAX package's ``ref`` twin does, so they differentiate to any
    order."""
    use_window = int(window) if (window and local_flag is not None and bool(local_flag)) else 0
    if use_window and not causal:
        raise ValueError("flash_attention: causal=False with an engaged window is refused: "
                         "the JAX reference drops the window there and its kernel keeps it")
    plain = dispatch.route("flash_attention", q, backend) == dispatch.PLAIN
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    if plain:
        return flash_attention_fwd_plain(q, k, v, q_pos, kv_pos, softcap=float(softcap or 0.0),
                                         window=use_window, causal=bool(causal),
                                         chunk=int(chunk or 0))[0]
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, float(softcap or 0.0), use_window,
                                 bool(causal))


@functools.lru_cache(maxsize=None)
def _train_fn(source, name):
    fn = getattr(build.load(source), name)
    n_ptr = {"flash_attn_fwd_launch": 7, "flash_attn_dq_launch": 9,
             "flash_attn_dkv_launch": 10}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_attention(q, k, v, q_pos, kv_pos):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, Dh) and k, v one (B, T, KV, Dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kv < 1 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not group over "
                         f"k {tuple(k.shape)}")
    if s < 1 or t < 1:
        raise ValueError(f"flash_attention: empty sequence S={s}, T={t}")
    if h // kv > MAX_GROUP or dh > MAX_HEAD_DIM or dh % 8:
        raise ValueError(f"flash_attention: the kernels take G <= {MAX_GROUP} and Dh a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got G={h // kv}, Dh={dh}")
    if b * kv > 65535:
        raise ValueError(f"flash_attention: B * KV = {b * kv} exceeds the grid's 65535")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the "
                         "kernels take one of float32, bfloat16, float16")
    if q_pos.dtype != torch.int32 or tuple(q_pos.shape) != (b, s):
        raise ValueError(f"flash_attention: q_pos must be ({b}, {s}) int32, got "
                         f"{q_pos.dtype} {tuple(q_pos.shape)}")
    if kv_pos.dtype != torch.int32 or tuple(kv_pos.shape) != (t,):
        raise ValueError(f"flash_attention: kv_pos must be ({t},) int32, got "
                         f"{kv_pos.dtype} {tuple(kv_pos.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {x.device}; the kernels take "
                             f"cuda tensors on one device (q is on {q.device})")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    _check_aligned(q=q, k=k, v=v)


def _check_aligned(**tensors):
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned (the kernels "
                             "stage rows with 16-byte cp.async copies)")


def _dims(q, k):
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    return b, s, t, kv, h // kv, dh


def _fwd_cuda(q, k, v, q_pos, kv_pos, *, softcap, window, causal):
    _check_attention(q, k, v, q_pos, kv_pos)
    b, s, t, kv, g, dh = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((b * kv, g, s), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _train_fn("flash_attn_fwd", "flash_attn_fwd_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, s, t, kv, g, dh, int(causal), window,
        softcap, 1.0 / math.sqrt(dh), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: forward launch failed with CUDA error {err}")
    dispatch.count_launch(FWD)
    return out, lse


def _bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, g_out, *, softcap, window, causal):
    _check_attention(q, k, v, q_pos, kv_pos)
    b, s, t, kv, g, dh = _dims(q, k)
    if g_out.shape != q.shape or g_out.dtype != q.dtype or g_out.device != q.device:
        raise ValueError(f"flash_attention: the output gradient is {g_out.dtype} "
                         f"{tuple(g_out.shape)}, q is {q.dtype} {tuple(q.shape)}")
    _check_aligned(g_out=g_out)
    for name, x, shape in (("lse", lse, (b * kv, g, s)), ("delta", delta, (b, s, kv * g))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous float32 {shape} "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (b, s, t, kv, g, dh, int(causal), window, softcap, 1.0 / math.sqrt(dh),
              _DTYPE_CODES[q.dtype], stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(), q_pos.data_ptr(),
           kv_pos.data_ptr(), lse.data_ptr(), delta.data_ptr())
    err = _train_fn("flash_attn_bwd", "flash_attn_dq_launch")(*ins, dq.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f"flash_attention: dq launch failed with CUDA error {err}")
    dispatch.count_launch(DQ)
    err = _train_fn("flash_attn_bwd", "flash_attn_dkv_launch")(*ins, dk.data_ptr(),
                                                                dv.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f"flash_attention: dk/dv launch failed with CUDA error {err}")
    dispatch.count_launch(DKV)
    return dq, dk, dv
