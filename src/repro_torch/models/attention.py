"""Attention, after ``src/repro/models/attention.py``: GQA
self-attention (the training branch through the ``flash_attention``
kernel, the decode branch over an explicit KV cache), MLA (multi-head
latent attention over a compressed cache) and cross-attention (whisper's
decoder, llama-3.2-vision's gated layers), the last two plain ops in both
packages.

Layout conventions (the JAX package's):
  activations x: (B, S, D)
  q/k/v:        (B, S, H, Dh)
  KV cache:     {"k": (B, T, KV, Dh), "v": (B, T, KV, Dh)}  (T = cache length)
  MLA cache:    {"ckv": (B, T, r), "krope": (B, T, Dr)}

``local_flag`` is a Python bool per layer (the port walks the layers in a
Python loop where JAX scans them with a traced flag).
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
    _write_rows(ck, k, cache_pos)
    _write_rows(cv, v, cache_pos)

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


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, cache_pos) -> None:
    """Write the S new rows (B, S, ...) into ``cache`` (B, T, ...) in
    place at ``cache_pos``: a scalar start (a contiguous slice, clamped so
    that it fits, as ``lax.dynamic_update_slice``) or a (B,) tensor of
    per-lane starts (a scatter)."""
    B, S = rows.shape[:2]
    if _is_vector(cache_pos):
        lane = torch.arange(B, device=rows.device)[:, None]
        idx = cache_pos.long()[:, None] + torch.arange(S, device=rows.device)
        cache[lane, idx] = rows.to(cache.dtype)
    else:
        start = min(max(int(cache_pos), 0), cache.shape[1] - S)
        cache[:, start:start + S] = rows.to(cache.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek/MiniCPM3-style multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = ()):
    D, H = cfg.d_model, cfg.num_heads
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)

    def ones(n):  # the norms' f32 scales
        return torch.ones(tuple(lead) + (n,), dtype=torch.float32, device=device)

    p = {
        "wkv_a": cm.dense_init(gen, (D, r + dr), **kw),
        "kv_norm": ones(r),
        "wkv_b": cm.dense_init(gen, (r, H * (dn + dv)), **kw),
        "wo": cm.dense_init(gen, (H * dv, D), **kw),
    }
    if rq:
        p["wq_a"] = cm.dense_init(gen, (D, rq), **kw)
        p["q_norm"] = ones(rq)
        p["wq_b"] = cm.dense_init(gen, (rq, H * (dn + dr)), **kw)
    else:
        p["wq"] = cm.dense_init(gen, (D, H * (dn + dr)), **kw)
    return p


def _rmsnorm_vec(x, scale, eps=1e-6):
    """RMS norm in f32 with an f32 scale, back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * scale).to(x.dtype)


def mla_attention(cfg, p, x, positions, *, cache=None, cache_pos=None):
    """Without a cache (training): causal attention over the S new rows;
    returns (out, None). With a cache: the S new ``ckv`` and ``krope`` rows
    are written into it in place at ``cache_pos`` (a scalar start or (B,)
    per-lane starts) and the queries attend over the whole cache, masked by
    position; returns (out, cache). ``wkv_b`` expands the normalised
    ``ckv`` of every cached row at every step, as in the reference."""

    B, S, D = x.shape
    H = cfg.num_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    if "wq_a" in p:
        q = _rmsnorm_vec(x @ p["wq_a"].to(x.dtype), p["q_norm"]) @ p["wq_b"].to(x.dtype)
    else:
        q = x @ p["wq"].to(x.dtype)
    q = q.reshape(B, S, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = cm.apply_rope(qr, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"].to(x.dtype)  # (B, S, r + dr)
    ckv, krope = kv_a[..., :r], kv_a[..., r:]
    krope = cm.apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]  # one shared head

    if cache is not None:
        _write_rows(cache["ckv"], ckv, cache_pos)
        _write_rows(cache["krope"], krope, cache_pos)
        ckv, krope = cache["ckv"], cache["krope"]
        T = ckv.shape[1]
        kv_pos = torch.arange(T, device=x.device)
    else:
        T = S
        kv_pos = positions[0] if positions.dim() == 2 else positions

    kv = _rmsnorm_vec(ckv.to(x.dtype), p["kv_norm"]) @ p["wkv_b"].to(x.dtype)
    kv = kv.reshape(B, T, H, dn + dv)
    kn, v = kv[..., :dn], kv[..., dn:]

    # 1 / sqrt(dn + dr), both steps rounded to x's dtype as jnp does them
    scale = cm.round_to(1.0 / cm.round_to(math.sqrt(dn + dr), x.dtype), x.dtype)
    scores = (torch.einsum("bshd,bthd->bhst", qn, kn)
              + torch.einsum("bshd,btd->bhst", qr, krope.to(x.dtype))) * scale
    mask = make_mask(positions, kv_pos, causal=True)  # (B, 1, S, T)
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * dv)
    return out @ p["wo"].to(x.dtype), cache


def init_mla_cache(cfg, batch: int, length: int, dtype=torch.bfloat16, *, device,
                   lead: Tuple[int, ...] = ()):
    lead = tuple(lead)
    return {
        "ckv": torch.zeros(lead + (batch, length, cfg.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros(lead + (batch, length, cfg.qk_rope_head_dim), dtype=dtype,
                             device=device),
    }


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder, llama-3.2-vision layers)
# ---------------------------------------------------------------------------


def init_cross_attn(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = (),
                    kv_dim: Optional[int] = None):
    """Queries from the d_model stream, keys and values from memory rows of
    ``kv_dim`` (default d_model)."""
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kv_dim = kv_dim or D
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wq": cm.dense_init(gen, (D, H * Dh), **kw),
        "wk": cm.dense_init(gen, (kv_dim, KV * Dh), **kw),
        "wv": cm.dense_init(gen, (kv_dim, KV * Dh), **kw),
        "wo": cm.dense_init(gen, (H * Dh, D), **kw),
    }


def cross_attention(cfg, p, x, *, memory=None, memory_kv=None):
    """x (B, S, D) attends, unmasked, over ``memory`` (B, M, D_mem)
    (encoder or vision states; K and V projected in memory's dtype, then
    cast to x's) or over precomputed ``memory_kv`` {"k", "v"} (B, M, KV,
    Dh) (the decode path's cache, from ``cross_kv``)."""

    B, S, D = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    if memory_kv is None:
        k, v = (kv.to(x.dtype) for kv in _memory_kv(cfg, p, memory))
    else:
        k, v = memory_kv["k"].to(x.dtype), memory_kv["v"].to(x.dtype)
    out = _sdpa(q, k, v, None)
    return out.reshape(B, S, H * Dh) @ p["wo"].to(x.dtype)


def _memory_kv(cfg, p, memory):
    B = memory.shape[0]
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    k = (memory @ p["wk"].to(memory.dtype)).reshape(B, -1, KV, Dh)
    v = (memory @ p["wv"].to(memory.dtype)).reshape(B, -1, KV, Dh)
    return k, v


def cross_kv(cfg, p, memory):
    """The decode cache's cross K and V of ``memory`` (B, M, D_mem), in
    memory's dtype: {"k", "v"} (B, M, KV, Dh)."""
    k, v = _memory_kv(cfg, p, memory)
    return {"k": k, "v": v}
