"""State-space and linear-recurrence layers, after
``src/repro/models/ssm.py``.

* Mamba2 (SSD): chunkwise-parallel scan. Intra-chunk masked products
  (attention-like) and the (B, H, P, N) state carried across chunks. Every
  decay exponent is a difference of a monotone cumsum with i >= j, so it
  is <= 0 and safe to exponentiate in f32.
* RWKV6 ("Finch"): data-dependent per-channel decay. The intra-chunk term
  needs a per-(i, j, k) exponent, the (B, Q, Q, H, K) block of a chunk.

JAX's ``lax.scan`` runs one chunk's whole body per step. Here the terms
that need no carried state (the intra-chunk products, each chunk's own
state contribution and decay) are formed for every chunk at once, and the
carried state enters each chunk's output in one batched product after the
recurrence: a few launches a layer rather than a few dozen a chunk (an
eager step is bound by its launches on the host). Mamba's recurrence runs
as a Python loop over its chunks (8 at zamba2's S 1024), multiplying in the
state's dtype as the scan does; RWKV's 32 f32 chunks sum it in closed form,
each chunk's contribution weighted by the exponential of its later chunks'
summed log-decays (exponents <= 0), the products of the scan as sums.

Both have a one-token ``*_decode`` with O(1) state. Each dtype cast stands
where the JAX code has it: Mamba's state follows the activations' dtype
and is cast back to the cache's at every token; RWKV's chunk and its state
``S`` work in f32.

The masked intra-chunk exponents (the pairs j > i, whose exponent is
positive) are set to -inf before the exponential, where JAX takes
``where(mask, exp(diff), 0)``: the same values, but once a masked exponent
passes f32's range (Mamba with large dt, RWKV with strong decays) JAX's
backward multiplies its zero cotangent by exp(diff) = inf and the gradient
turns NaN (0 * inf), while here it stays finite (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def _check_chunk(S: int, Q: int) -> None:
    """The JAX package asserts this (``ssm.py:92, 263``); here it raises."""
    if S % Q:
        raise ValueError(f"seq {S} not divisible by ssm chunk {Q}")


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, K) depthwise causal filter; b: (C,)."""
    K, S = w.shape[1], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[:, 0]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[:, i]
    return out + b


# ===========================================================================
# Mamba2 / SSD
# ===========================================================================


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state


def _full(lead, shape, value, device):
    return torch.full(tuple(lead) + tuple(shape), value, dtype=torch.float32, device=device)


def init_mamba(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    d_inner, H, P, N = mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "in_proj": cm.dense_init(gen, (D, 2 * d_inner + 2 * N + H), **kw),
        "conv_w": cm.dense_init(gen, (conv_dim, cfg.ssm_conv), scale=1.0, **kw),
        "conv_b": torch.zeros(tuple(lead) + (conv_dim,), dtype=dtype, device=device),
        "A_log": _full(lead, (H,), 0.0, device),  # A = -exp(A_log) = -1 at init
        "D": _full(lead, (H,), 1.0, device),
        "dt_bias": _full(lead, (H,), -2.0, device),  # softplus(-2) ~ 0.12
        "norm": _full(lead, (d_inner,), 1.0, device),
        "out_proj": cm.dense_init(gen, (d_inner, D), **kw),
    }


def _mamba_preproj(cfg, p, x):
    d_inner, H, P, N = mamba_dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H) f32
    return z, xBC, dt


def _mamba_postproc(cfg, p, y, z):
    d_inner = mamba_dims(cfg)[0]
    B, S = y.shape[:2]
    y = y.reshape(B, S, d_inner) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6) * p["norm"]).to(y.dtype)
    return y @ p["out_proj"].to(y.dtype)


def apply_mamba(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Training and prefill path. x: (B, S, D)."""

    d_inner, H, P, N = mamba_dims(cfg)
    Bsz, S, _ = x.shape
    Q = min(cfg.ssm_chunk, S)
    _check_chunk(S, Q)
    nc = S // Q

    z, xBC, dt = _mamba_preproj(cfg, p, x)
    xBC = F.silu(causal_depthwise_conv(xBC, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    xs = xBC[..., :d_inner].reshape(Bsz, S, H, P)
    Bm = xBC[..., d_inner:d_inner + N]  # (B, S, N), shared across heads
    Cm = xBC[..., d_inner + N:]

    A = -torch.exp(p["A_log"])  # (H,)
    a = dt * A  # (B, S, H) <= 0
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    def ch(t):  # (B, S, ...) -> (B, nc, Q, ...)
        return t.reshape((Bsz, nc, Q) + t.shape[2:])

    a_c, dt_c, x_c, B_c, C_c = ch(a), ch(dt), ch(xs), ch(Bm), ch(Cm)
    cum = torch.cumsum(a_c, dim=2)  # (B, nc, Q, H), decreasing in Q

    # intra-chunk, every chunk at once
    scores = torch.einsum("bcin,bcjn->bcij", C_c, B_c)  # (B, nc, Q, Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, H): <= 0 for i >= j
    L = torch.exp(torch.where(causal[None, None, :, :, None], diff, -torch.inf))
    M = scores[..., None] * L * dt_c[:, :, None, :, :]  # (B, nc, i, j, H) f32
    y = torch.einsum("bcijh,bcjhp->bcihp", M.to(x.dtype), x_c)

    # each chunk's own state contribution and decay; the three-operand
    # products pair up as jnp.einsum pairs them (the outer product first),
    # so that bf16 rounds where it does in JAX
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    w_j = (decay_out * dt_c).to(x.dtype)
    S_loc = torch.einsum("bcjhn,bcjhp->bchpn", w_j[..., None] * B_c[:, :, :, None, :], x_c)
    decay_chunk = torch.exp(cum[:, :, -1, :]).to(x.dtype)  # (B, nc, H)

    # the state entering each chunk: the recurrence over the chunks
    S_prev = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(S_prev)
        S_prev = decay_chunk[:, c, :, None, None] * S_prev + S_loc[:, c]
    S_in = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    decay_in = torch.exp(cum).to(x.dtype)  # (B, nc, Q, H)
    y = y + torch.einsum("bcihn,bchpn->bcihp", C_c[:, :, :, None, :] * decay_in[..., None],
                         S_in)
    y = y.reshape(Bsz, S, H, P) + xs * p["D"].to(x.dtype)[None, None, :, None]
    return _mamba_postproc(cfg, p, y, z)


def init_mamba_state(cfg, batch: int, dtype=torch.bfloat16, *, device,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d_inner, H, P, N = mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    lead = tuple(lead)
    return {
        "ssm": torch.zeros(lead + (batch, H, P, N), dtype=dtype, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba_decode(cfg, p, x: torch.Tensor, state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, 1, D). Returns (out, new state); the new
    state is in the cache's dtypes, the arithmetic in the activations'."""

    d_inner, H, P, N = mamba_dims(cfg)
    Bsz = x.shape[0]
    z, xBC, dt = _mamba_preproj(cfg, p, x)  # (B, 1, ...)
    conv_in = torch.cat([state["conv"].to(x.dtype), xBC], dim=1)  # (B, K, conv_dim)
    xBC_t = F.silu(torch.sum(conv_in * p["conv_w"].to(x.dtype).T[None], dim=1)
                   + p["conv_b"].to(x.dtype))  # (B, conv_dim)
    new_conv = conv_in[:, 1:]

    xt = xBC_t[:, :d_inner].reshape(Bsz, H, P)
    Bt = xBC_t[:, d_inner:d_inner + N]
    Ct = xBC_t[:, d_inner + N:]
    dt_t = dt[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_t * A).to(x.dtype)  # (B, H)

    S = state["ssm"].to(x.dtype)
    dtB = dt_t.to(x.dtype)[:, :, None] * Bt[:, None, :]  # (B, H, N), as jnp.einsum pairs it
    S = decay[:, :, None, None] * S + dtB[:, :, None, :] * xt[..., None]
    y = torch.einsum("bn,bhpn->bhp", Ct, S) + xt * p["D"].to(x.dtype)[None, :, None]
    out = _mamba_postproc(cfg, p, y.reshape(Bsz, 1, H, P), z)
    return out, {"ssm": S.to(state["ssm"].dtype), "conv": new_conv.to(state["conv"].dtype)}


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================


def rwkv_dims(cfg):
    H = cfg.d_model // cfg.rwkv_head_dim
    return H, cfg.rwkv_head_dim


def init_rwkv_time_mix(cfg, gen, *, dtype=torch.float32, device,
                       lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    H, K = rwkv_dims(cfg)
    L = cfg.rwkv_decay_lora
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "mu": {n: _full(lead, (D,), 0.5, device) for n in ("r", "k", "v", "g", "w")},
        "wr": cm.dense_init(gen, (D, D), **kw),
        "wk": cm.dense_init(gen, (D, D), **kw),
        "wv": cm.dense_init(gen, (D, D), **kw),
        "wg": cm.dense_init(gen, (D, D), **kw),
        "wo": cm.dense_init(gen, (D, D), **kw),
        "w0": _full(lead, (D,), -1.0, device),  # decay bias: w ~ exp(-exp(-1 + ...))
        "wA": cm.dense_init(gen, (D, L), **kw),
        "wB": cm.dense_init(gen, (L, D), scale=0.1, **kw),
        "u": _full(lead, (H, K), 0.0, device),  # the "bonus" of the current token
        "ln_x": {"scale": _full(lead, (D,), 1.0, device), "bias": _full(lead, (D,), 0.0, device)},
    }


def init_rwkv_channel_mix(cfg, gen, *, dtype=torch.float32, device,
                          lead: Tuple[int, ...] = ()):
    D, Fd = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "mu": {n: _full(lead, (D,), 0.5, device) for n in ("k", "r")},
        "wk": cm.dense_init(gen, (D, Fd), **kw),
        "wv": cm.dense_init(gen, (Fd, D), **kw),
        "wr": cm.dense_init(gen, (D, D), **kw),
    }


def _token_shift(x: torch.Tensor, x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}, with zeros (or the carried state) at t = 0. x: (B, S, D).
    The result takes the promoted dtype of x and the state, as
    ``jnp.concatenate`` does."""
    if x_prev_last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = x_prev_last[:, None]
    dtype = torch.promote_types(pad.dtype, x.dtype)
    return torch.cat([pad.to(dtype), x[:, :-1].to(dtype)], dim=1)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _rwkv_proj(cfg, p, x, xprev):
    H, K = rwkv_dims(cfg)
    B, S, D = x.shape
    r = (_mix(x, xprev, p["mu"]["r"]) @ p["wr"].to(x.dtype)).reshape(B, S, H, K)
    k = (_mix(x, xprev, p["mu"]["k"]) @ p["wk"].to(x.dtype)).reshape(B, S, H, K)
    v = (_mix(x, xprev, p["mu"]["v"]) @ p["wv"].to(x.dtype)).reshape(B, S, H, K)
    g = F.silu(_mix(x, xprev, p["mu"]["g"]) @ p["wg"].to(x.dtype))
    xw = _mix(x, xprev, p["mu"]["w"])
    lora = torch.tanh(xw @ p["wA"].to(x.dtype)) @ p["wB"].to(x.dtype)
    logw = -torch.exp(torch.clamp(p["w0"] + lora.float(), -8.0, 3.0))  # (B, S, D) < 0
    return r, k, v, g, logw.reshape(B, S, H, K)


def _rwkv_out(cfg, p, y, g, x_dtype):
    """Per-head group norm, gate, output projection. y: (B, S, H, K) f32."""
    B, S, H, K = y.shape
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    yn = yn.reshape(B, S, H * K) * p["ln_x"]["scale"] + p["ln_x"]["bias"]
    return (yn.to(x_dtype) * g) @ p["wo"].to(x_dtype)


def apply_rwkv_time_mix(cfg, p, x: torch.Tensor,
                        x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunkwise WKV6. x: (B, S, D)."""

    H, K = rwkv_dims(cfg)
    B, S, D = x.shape
    Q = min(cfg.ssm_chunk, S)
    _check_chunk(S, Q)
    nc = S // Q

    xprev = _token_shift(x, x_prev_last)
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, xprev)
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device), diagonal=-1)

    def ch(t):  # (B, S, H, K) -> (B, nc, Q, H, K) f32
        return t.float().reshape(B, nc, Q, H, K)

    r_c, k_c, v_c, w_c = ch(r), ch(k), ch(v), ch(logw)
    cw = torch.cumsum(w_c, dim=2)  # decreasing in Q
    q_shift = F.pad(cw[:, :, :-1], (0, 0, 0, 0, 1, 0))  # cw_{t-1}

    # intra, every chunk at once: y_t = sum_{j<t} (r_t . e^{cw_{t-1} - cw_j} k_j) v_j + bonus_t
    diff = q_shift[:, :, :, None] - cw[:, :, None, :]  # (B, nc, i, j, H, K) <= 0 where j < i
    dec = torch.exp(torch.where(strict[None, None, :, :, None, None], diff, -torch.inf))
    del diff
    att = torch.einsum("bcijhk,bcjhk->bcijh", dec * r_c[:, :, :, None], k_c)
    y = torch.einsum("bcijh,bcjhk->bcihk", att, v_c)
    bonus = torch.einsum("bcihk,bcihk->bcih", r_c * p["u"], k_c)
    y = y + bonus[..., None] * v_c

    # each chunk's own state contribution, and the state entering chunk c:
    # sum over c' < c of S_loc[c'] decayed by the chunks c' + 1 .. c - 1
    decay_out = torch.exp(cw[:, :, -1:] - cw)  # (B, nc, Q, H, K)
    S_loc = torch.einsum("bcjhk,bcjhv->bchkv", decay_out * k_c, v_c)
    logdec = cw[:, :, -1]  # (B, nc, H, K): a chunk's summed log-decay
    before = torch.cumsum(logdec, dim=1) - logdec  # those of the chunks before it
    expo = before[:, :, None] - before[:, None, :] - logdec[:, None, :]  # (B, c, c', H, K)
    earlier = torch.tril(torch.ones((nc, nc), dtype=torch.bool, device=x.device), diagonal=-1)
    weight = torch.exp(torch.where(earlier[None, :, :, None, None], expo, -torch.inf))
    S_in = torch.einsum("bcdhk,bdhkv->bchkv", weight, S_loc)  # (B, nc, H, K, K)

    # inter: from the carried state
    rd = r_c * torch.exp(q_shift)  # exponent <= 0
    y = y + torch.einsum("bcihk,bchkv->bcihv", rd, S_in)
    return _rwkv_out(cfg, p, y.reshape(B, S, H, K), g, x.dtype)


def init_rwkv_state(cfg, batch: int, dtype=torch.float32, *, device,
                    lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    H, K = rwkv_dims(cfg)
    D = cfg.d_model
    lead = tuple(lead)
    return {
        "S": torch.zeros(lead + (batch, H, K, K), dtype=torch.float32,
                         device=device),  # f32 whatever the cache dtype
        "x_att": torch.zeros(lead + (batch, D), dtype=dtype, device=device),
        "x_ffn": torch.zeros(lead + (batch, D), dtype=dtype, device=device),
    }


def rwkv_time_mix_decode(cfg, p, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """x: (B, 1, D). Returns (out, the new state's "S" and "x_att")."""

    xprev = state["x_att"][:, None].to(x.dtype)
    r, k, v, g, logw = _rwkv_proj(cfg, p, x, xprev)
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))  # (B, H, K)
    w1 = torch.exp(logw[:, 0].float())  # (B, H, K)
    S = state["S"]
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1, S + p["u"][None, :, :, None] * kv)
    S_new = w1[..., None] * S + kv
    out = _rwkv_out(cfg, p, y[:, None], g, x.dtype)
    return out, {"S": S_new, "x_att": x[:, 0].to(state["x_att"].dtype)}


def apply_rwkv_channel_mix(cfg, p, x: torch.Tensor,
                           x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    xprev = _token_shift(x, x_prev_last)
    k = _mix(x, xprev, p["mu"]["k"]) @ p["wk"].to(x.dtype)
    k = torch.square(F.relu(k))
    kv = k @ p["wv"].to(x.dtype)
    rgate = torch.sigmoid(_mix(x, xprev, p["mu"]["r"]) @ p["wr"].to(x.dtype))
    return rgate * kv


def rwkv_channel_mix_decode(cfg, p, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    out = apply_rwkv_channel_mix(cfg, p, x, state["x_ffn"])
    return out, {"x_ffn": x[:, 0].to(state["x_ffn"].dtype)}
