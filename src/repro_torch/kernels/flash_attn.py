"""Flash attention of the port: the CUDA kernels' wrappers, their plain
PyTorch versions and, for decode, the split-count heuristic and the
stage-2 merge.

Counterpart of ``src/repro/kernels/flash_attn.py``:

* training (``flash_attention``): a ``torch.autograd.Function`` whose
  forward is ``csrc/flash_attn_fwd.cu`` (blockwise online softmax, saving
  ``out`` and ``lse``) and whose backward is the two recompute kernels of
  ``csrc/flash_attn_bwd.cu`` (dq; dk and dv summed over the query group).
  Like the JAX custom VJP it saves only ``(q, k, v, out, lse)`` and the
  positions. Its plain versions are ``flash_attention_ref``'s ops (which
  also give the lse) and the recompute of ``_bwd_tile`` in torch ops.
* decode (``flash_decode``): ``csrc/flash_decode.cu``, stage 1 and the
  merge as two CUDA kernels behind one C call.

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

#: the kernels' limits (csrc/flash_decode.cu, csrc/attn_common.cuh: G up to 8, kMaxDh)
MAX_GROUP = 8
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pick_splits(t: int, bh: int, *, min_split: int = 32,
                target_blocks: int = 2 * NUM_SMS, max_splits: int = 64) -> int:
    """KV split count for ``bh = B * KV`` rows over a cache of ``t`` tokens.

    Enough ``(split, row)`` blocks for about two on each of the card's 132
    SMs, but no split shorter than ``min_split`` rows (a block would spend
    more on its set-up and its partial output than on its rows) and no more
    than ``max_splits`` (the merge reads every split). Serving runs B * KV =
    slots x 1 = 4 to 8 rows, so the splits, not the lanes, fill the card.
    """
    by_len = max(1, math.ceil(t / min_split))
    want = max(1, math.ceil(target_blocks / max(bh, 1)))
    return max(1, min(by_len, want, max_splits))


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

    CUDA tensors launch the kernel; CPU tensors (or ``backend="plain"``)
    take :func:`flash_decode_plain`."""
    if dispatch.route("flash_decode", q, backend) == dispatch.PLAIN:
        return flash_decode_plain(q, k, v, q_pos, local_flag, softcap=softcap,
                                  window=window)
    return _flash_decode_cuda(q, k, v, q_pos, local_flag, softcap=softcap,
                              window=window, n_splits=n_splits)


@functools.lru_cache(maxsize=1)
def _lib():
    fn = build.load("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
                             "reads rows with 16-byte loads)")


def _flash_decode_cuda(q, k, v, q_pos, local_flag, *, softcap, window, n_splits):
    _check(q, k, v, q_pos)
    b, _, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    bh = b * kv
    if n_splits is None:
        n_splits = pick_splits(t, bh)
    split = math.ceil(t / n_splits)
    use_window = int(window) if (window and local_flag is not None
                                 and bool(local_flag)) else 0
    o_part = torch.empty((bh, n_splits, g, dh), device=q.device, dtype=torch.float32)
    lse_part = torch.empty((bh, n_splits, g), device=q.device, dtype=torch.float32)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 o_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(),
                 b, t, kv, g, dh, n_splits, split, use_window,
                 float(softcap or 0.0), 1.0 / math.sqrt(dh), _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA error {err}")
    dispatch.count_launch("flash_decode")
    return out


# ---------------------------------------------------------------------------
# training: blockwise attention, forward and recompute backward
# ---------------------------------------------------------------------------

#: the training kernels' launch counters (``dispatch.launches``)
FWD, DQ, DKV = "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"


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


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse) and the positions; backward
    recomputes the probabilities from lse, as the JAX custom VJP does.
    ``plain`` picks the plain versions for both passes."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, softcap, window, causal, chunk, plain):
        opts = dict(softcap=softcap, window=window, causal=causal)
        if plain:
            out, lse = flash_attention_fwd_plain(q, k, v, q_pos, kv_pos, chunk=chunk, **opts)
        else:
            out, lse = _fwd_cuda(q, k, v, q_pos, kv_pos, **opts)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts, ctx.plain = opts, plain
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        g_out = g_out.contiguous()
        # delta = rowsum(dO * O) in f32, outside the kernels as in JAX
        delta = torch.sum(g_out.float() * out.float(), dim=-1)
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, lse, delta, g_out,
                                                   **ctx.opts)
        else:
            dq, dk, dv = _bwd_cuda(q, k, v, q_pos, kv_pos, lse, delta, g_out, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, local_flag=None, *, softcap=0.0, window=0,
                    causal=True, chunk=0, backend=None):
    """Blockwise flash attention, differentiable.

    q (B, S, H, Dh); k, v (B, T, KV, Dh) with H % KV == 0; q_pos (B, S) and
    kv_pos (T,) integer positions (-1 = padding); ``local_flag`` (a Python
    bool per layer) engages the sliding ``window``. Returns (B, S, H, Dh)
    in q's dtype. CUDA tensors launch the kernels in both passes; CPU
    tensors (or ``backend="plain"``) take the plain versions."""
    use_window = int(window) if (window and local_flag is not None and bool(local_flag)) else 0
    if use_window and not causal:
        raise ValueError("flash_attention: causal=False with an engaged window is refused: "
                         "the JAX reference drops the window there and its kernel keeps it")
    plain = dispatch.route("flash_attention", q, backend) == dispatch.PLAIN
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, float(softcap or 0.0), use_window,
                                 bool(causal), int(chunk or 0), plain)


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
