"""Split-KV one-token decode attention: the CUDA kernel's wrapper, its
plain PyTorch version, the split-count heuristic and the stage-2 merge.

Counterpart of the decode half of ``src/repro/kernels/flash_attn.py``
(``pick_splits``, ``merge_partials``, ``flash_decode``,
``flash_decode_ref``). The kernel is ``csrc/flash_decode.cu``: stage 1 and
the merge are two CUDA kernels behind one C call. The blockwise training
kernel (``flash_attention``) comes with the training slice.
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

#: the kernel's limits (csrc/flash_decode.cu: kG templates up to 8, kMaxDh)
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
    lib = build.load()
    fn = lib.flash_decode_launch
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
