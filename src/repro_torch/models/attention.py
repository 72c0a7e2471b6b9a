"""GQA self-attention, after ``src/repro/models/attention.py``: the
training branch (no cache, through the ``flash_attention`` kernel) and the
decode branch over an explicit KV cache.

Layout conventions (the JAX package's):
  activations x: (B, S, D)
  q/k/v:        (B, S, H, Dh)
  KV cache:     {"k": (B, T, KV, Dh), "v": (B, T, KV, Dh)}  (T = cache length)

``local_flag`` is a Python bool per layer (the port walks the layers in a
Python loop where JAX scans them with a traced flag).

MLA and cross-attention come with the model-family slices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attn
from repro_torch.models import common as cm


def make_mask(q_pos, kv_pos, *, causal=True, local_flag=None, window=0):
    """q_pos: (B,S) int; kv_pos: (T,) int. Returns (B,1,S,T) bool (True=keep)."""
    q = q_pos[:, :, None]  # (B,S,1)
    k = kv_pos[None, None, :]  # (1,1,T)
    if causal:
        mask = k <= q
    else:
        mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                          device=q_pos.device)
    if window and local_flag is not None and bool(local_flag):
        mask = mask & ((q - k) < window)
    return mask[:, None]  # (B,1,S,T)


def _chunked_sdpa(q, k, v, q_pos, kv_pos, *, chunk, softcap=0.0, local_flag=None,
                  window=0, causal=True):
    """Blockwise online-softmax attention over KV chunks of ``chunk`` rows
    (the JAX package's flash-style scan, a Python loop here). q is
    (B, S, KV, G, Dh). Padded rows of a ragged last chunk carry position
    -1 and are masked. Returns (out (B, S, H, Dh), lse (B, KV, G, S) f32,
    NEG for a fully masked row); the JAX function returns ``out`` only."""

    B, S, KV, G, Dh = q.shape
    T = k.shape[1]
    nc = -(-T // chunk)
    if nc * chunk != T:
        pad = nc * chunk - T
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    # 1 / sqrt(Dh), both steps rounded to q's dtype as jnp does them
    scale = cm.round_to(1.0 / cm.round_to(math.sqrt(Dh), q.dtype), q.dtype)
    NEG = -1e30
    m = torch.full((B, KV, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KV, G, Dh), dtype=q.dtype, device=q.device)
    for c in range(nc):
        kc, vc = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        pc = kv_pos[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bskgd,btkd->bkgst", q, kc) * scale
        s = cm.softcap(s.float(), softcap)
        mask = make_mask(q_pos, pc, causal=causal, local_flag=local_flag, window=window)
        mask = mask & (pc >= 0)[None, None, None, :]
        mask_b = torch.broadcast_to(mask[:, :, None], s.shape)
        s = torch.where(mask_b, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask_b, torch.exp(s - m_new[..., None]), 0.0)
        scale_old = torch.exp(torch.clamp_max(m - m_new, 0.0))
        scale_old = torch.where(m <= NEG, 0.0, scale_old)
        l = l * scale_old + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), vc)
        acc = acc * torch.movedim(scale_old, -1, 1)[..., None].to(q.dtype) + pv
        m = m_new
    # l is 0 on a fully masked row and at least 1 on any other: the floor
    # must survive the cast to q's dtype (1e-30 is 0 in f16)
    floor = max(1e-30, torch.finfo(q.dtype).tiny)
    denom = torch.movedim(torch.clamp_min(l, floor), -1, 1)[..., None]
    out = (acc / denom.to(q.dtype)).reshape(B, S, KV * G, Dh)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), NEG)
    return out, lse


def _sdpa(q, k, v, mask, *, softcap=0.0, return_lse=False):
    """Grouped scaled-dot-product attention.
    q: (B,S,H,Dh), k/v: (B,T,KV,Dh); H = KV * G.

    The scores are formed and divided by sqrt(Dh) in q's dtype; softcap and
    softmax run in f32; the probabilities go back to q's dtype for PV. With
    ``return_lse`` also returns the scores' log-sum-exp (B, KV, G, S) f32."""

    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / cm.round_to(math.sqrt(Dh), q.dtype)
    scores = cm.softcap(scores.float(), softcap)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, -1e30)  # (B,1,S,T)->(B,1,1,S,T)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, Dh)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def init_self_attn(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = ()):
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": cm.dense_init(gen, (D, H * Dh), **kw),
        "wk": cm.dense_init(gen, (D, KV * Dh), **kw),
        "wv": cm.dense_init(gen, (D, KV * Dh), **kw),
        "wo": cm.dense_init(gen, (H * Dh, D), **kw),
    }


def _is_vector(cache_pos) -> bool:
    return isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1


def self_attention(
    cfg,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    local_flag: Optional[bool] = None,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Without a cache (training, the encoder): attention over the S new
    rows through the ``flash_attention`` kernel; returns (out, None).

    With a cache: insert the S new k/v rows at ``cache_pos`` and attend
    over the cache. ``cache_pos`` is a scalar start (a uniform batch: a
    contiguous slice) or a (B,) tensor of per-lane starts (continuous
    batching over staggered lengths: a scatter). The rows are written into
    ``cache`` in place, and ``cache`` is returned as the new cache. S == 1
    goes to the split-KV ``flash_decode`` kernel, S > 1 (block prefill) to
    ``_sdpa``. ``positions`` is (B, S) int32."""

    B, S, D = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, KV, Dh)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, KV, Dh)
    if cfg.use_rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        kv_pos = positions[0] if positions.dim() == 2 else positions
        q_pos = positions if positions.dim() == 2 else positions[None].expand(B, S)
        out = flash_attn.flash_attention(
            q, k, v, q_pos, kv_pos, local_flag, softcap=cfg.attn_logit_softcap,
            window=cfg.sliding_window, causal=causal, chunk=cfg.attn_chunk)
        return out.reshape(B, S, H * Dh) @ p["wo"].to(x.dtype), None

    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    if _is_vector(cache_pos):
        lane = torch.arange(B, device=x.device)[:, None]
        idx = cache_pos.long()[:, None] + torch.arange(S, device=x.device)
        ck[lane, idx] = k.to(ck.dtype)
        cv[lane, idx] = v.to(cv.dtype)
    else:
        # lax.dynamic_update_slice clamps the start so the slice fits
        start = min(max(int(cache_pos), 0), T - S)
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)

    if S == 1:
        out = flash_attn.flash_decode(
            q, ck.to(q.dtype), cv.to(q.dtype), positions, local_flag,
            softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)
    else:
        mask = make_mask(positions, torch.arange(T, device=x.device), causal=True,
                         local_flag=local_flag, window=cfg.sliding_window)
        out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask,
                    softcap=cfg.attn_logit_softcap)

    out = out.reshape(B, S, H * Dh) @ p["wo"].to(x.dtype)
    return out, cache


def init_kv_cache(cfg, batch: int, length: int, dtype=torch.bfloat16, *, device,
                  lead: Tuple[int, ...] = ()):
    shape = tuple(lead) + (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
