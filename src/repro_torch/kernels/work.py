"""The analytic work of one call of each kernel: the FLOPs and bytes that
``chip_smoke.py`` bounds each kernel's time with (PERF.md section 6), as a
function of the call's shapes, dtypes and options alone.

A hand-written kernel is a call the attribution (``obs/profile.py``) cannot
see, and a meta tensor holds no data, so every route of a kernel charges
the count given here (``dispatch.charge``): the work counts the same on the
card, on the CPU and on ``meta`` tensors.

* the flat adaptation products: each input read and the output written
  once, and the bound's operations per element;
* the CE: the logits read once (twice in the backward, which also writes
  dlogits), 12 bytes a row, about four f32 operations a logit;
* training attention: the (query, key) pairs of the tiles the bf16/f16
  kernels visit (``flash_attn.live_tiles`` at each kernel's tile sizes,
  :func:`tiles`, cut to S and T), two products in the forward, three in dq,
  four in dk/dv, each a multiply and an add per pair and head dim. The
  tiles are those of positions 0..S-1 over keys 0..T-1, which every
  training forward gives; padding (positions -1) would skip tiles the
  count keeps;
* decode attention: two products over the rows a lane sees, counted as if
  every lane stood at the end of its cache (all T rows, or the window).

Every product is matmul-class work (``Work.matmul_flops``), the class the
attribution's per-phase comparison with the JAX package's HLO holds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


class Work(NamedTuple):
    flops: float
    bytes: float
    #: the part of ``flops`` done by products (dot or convolution class)
    matmul_flops: float = 0.0


def _item(dtype: torch.dtype) -> int:
    return dtype.itemsize


def flat(name: str, n: int, dtype: torch.dtype) -> Work:
    """One flat adaptation product over ``n`` elements of ``dtype``."""
    arrays, ops = {"adam_adapt": (5, 20), "lion_adapt": (4, 10),
                   "adafactor_adapt": (3, 4)}[name]
    return Work(float(ops * n), float(arrays * n * _item(dtype)))


def ce(rows: int, v: int, dtype: torch.dtype, backward: bool = False) -> Work:
    """The CE forward (or backward) over ``rows`` rows of ``v`` logits."""
    logits = rows * v * _item(dtype)
    return Work(float(4 * rows * v), float((2 if backward else 1) * logits + 12 * rows))


#: (query, head) rows per block of each bf16/f16 training kernel: the
#: forward's two consumer warpgroups (csrc/flash_attn_fwd.cu FwdTc::kRows),
#: dq's and dk/dv's four warps (csrc/attn_mma.cuh kM)
_ROWS = {"fwd": 128, "dq": 64, "dkv": 64}


def _tile_dh(dh: int) -> int:
    return 32 if dh <= 32 else 64 if dh <= 64 else 128 if dh <= 128 else 256


def tiles(kernel: str, g: int, dh: int):
    """(queries, keys) per tile of the bf16/f16 training ``kernel``
    ("fwd", "dq" or "dkv") at group size ``g`` and head dim ``dh``: what
    ``flash_attn.tc_tiles`` asks the kernels' libraries (held equal on the
    card by ``chip_smoke.py``)."""
    d = _tile_dh(dh)
    bk = {"fwd": 64 if d <= 128 else 16,
          "dq": 64 if d <= 64 else 32 if d <= 128 else 16,
          "dkv": 64 if d <= 64 else 32}[kernel]
    return _ROWS[kernel] // g, bk


@functools.lru_cache(maxsize=256)
def tile_pairs(s: int, t: int, bq: int, bk: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one lane inside the live tiles (the
    ``live_tiles`` rule over positions 0..S-1 and keys 0..T-1), each tile
    cut to S and T."""
    from repro_torch.kernels import dispatch, flash_attn

    with dispatch.uncounted():
        q_pos = torch.arange(s, dtype=torch.int64)[None]
        kv_pos = torch.arange(t, dtype=torch.int64)
        live = flash_attn.live_tiles(q_pos, kv_pos, bq, bk, causal=causal, window=window)[0]
        rows = torch.clamp(s - torch.arange(live.shape[0]) * bq, max=bq)
        keys = torch.clamp(t - torch.arange(live.shape[1]) * bk, max=bk)
        return int((live.long() * rows[:, None] * keys[None, :]).sum())


def attention(kernel: str, b: int, s: int, t: int, kv: int, g: int, dh: int,
              dtype: torch.dtype, *, causal: bool, window: int) -> Work:
    """One call of the training ``kernel`` ("fwd", "dq" or "dkv") on q (B,
    S, KV*G, Dh) over k, v (B, T, KV, Dh); ``window`` > 0 engaged."""
    h, item = kv * g, _item(dtype)
    bq, bk = tiles(kernel, g, dh)
    pairs = b * h * tile_pairs(s, t, bq, bk, bool(causal), int(window))
    act = b * s * h * dh * item           # q, out, dO, dq
    kvb = b * t * kv * dh * item          # k, v, dk, dv
    rows = b * s * h * 4                  # lse or delta, f32
    pos = b * s * 4 + t * 4
    nbytes, products = {"fwd": (act * 2 + kvb * 2 + rows + pos, 2),
                        "dq": (act * 3 + kvb * 2 + rows * 2 + pos, 3),
                        "dkv": (act * 2 + kvb * 4 + rows * 2 + pos, 4)}[kernel]
    flops = float(2 * products * pairs * dh)
    return Work(flops, float(nbytes), flops)


def decode(b: int, t: int, kv: int, g: int, dh: int, dtype: torch.dtype, *,
           window: int) -> Work:
    """One split-KV decode call: q (B, 1, KV*G, Dh) over a cache of T rows
    (the window's rows on an engaged ``window`` > 0), every lane at the end
    of its cache."""
    rows = min(t, window) if window else t
    h, item = kv * g, _item(dtype)
    nbytes = 2 * b * h * dh * item + 2 * b * rows * kv * dh * item + 4 * b
    flops = float(4 * b * h * rows * dh)
    return Work(flops, float(nbytes), flops)


def attention_dims(q: torch.Tensor, k: torch.Tensor):
    """(B, S, T, KV, G, Dh) of a call."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    return b, s, t, kv, h // kv, dh

