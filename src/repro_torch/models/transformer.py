"""Model assembly, after ``src/repro/models/transformer.py``, for seven
families: ``dense`` (GQA or MLA attention + MLP, heterogeneous
local/global layers), ``moe`` (leading dense layers, then attention +
mixture-of-experts layers whose load-balance aux losses sum into the
forward's aux), ``ssm`` (RWKV6 blocks: time mix + channel mix), ``hybrid``
(Zamba2: leading Mamba2 blocks, then groups of Mamba2 blocks each followed
by ONE shared attention block, whose gradient sums over its uses),
``audio`` (Whisper: a bidirectional encoder over the batch's precomputed
``frames`` with sinusoidal positions, then a causal decoder with learned
positions whose layers cross-attend to the encoder's output), ``vlm``
(Llama-3.2-Vision: groups of self-attention layers, each group followed by
one cross-attention layer over the projected ``patches``, its attention
and MLP scaled by ``tanh`` of their f32 0-d gates) and ``encoder`` (the
BERT-style classifier: init and forward). For all but the encoder: init,
the training forward, the decode cache and the decode step.

Layer parameters and the cache carry leading layer axes, as the JAX stacks
do (zamba2's ``mamba_groups`` and the vision model's ``self_groups`` two:
groups, then layers); the forward and the decode step walk the layers in a
Python loop where JAX scans them. With ``cfg.remat`` each layer of the
forward (each group, for zamba2's and the vision model's groups) runs
under ``torch.utils.checkpoint``: its activations are recomputed in the
backward pass, as ``jax.checkpoint`` on the JAX scan body does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

Tree = Any

#: families whose decode cache is recurrent state, advanced one token per step
RECURRENT_FAMILIES = ("ssm", "hybrid")
_DECODERS = ("dense", "moe", "audio", "vlm") + RECURRENT_FAMILIES


def _check_family(cfg, families=_DECODERS) -> None:
    if cfg.family not in families:
        raise ValueError(f"{cfg.name!r} (family {cfg.family!r}): this path runs the "
                         f"{'/'.join(families)} families")


def _init_dense_layer(cfg, gen, dtype, device, lead):
    init = attn.init_mla if cfg.use_mla else attn.init_self_attn
    return {
        "ln1": cm.init_norm(cfg, device=device, lead=lead),
        "ln2": cm.init_norm(cfg, device=device, lead=lead),
        "attn": init(cfg, gen, dtype=dtype, device=device, lead=lead),
        "mlp": cm.init_mlp(cfg, gen, dtype=dtype, device=device, lead=lead),
    }


def _dense_layer(cfg, p, x, positions, flag, cache=None, cache_pos=None, causal=True):
    h = cm.apply_norm(cfg, p["ln1"], x)
    if cfg.use_mla:
        out, new_cache = attn.mla_attention(cfg, p["attn"], h, positions, cache=cache,
                                            cache_pos=cache_pos)
    else:
        out, new_cache = attn.self_attention(cfg, p["attn"], h, positions, local_flag=flag,
                                             causal=causal, cache=cache, cache_pos=cache_pos)
    x = x + out
    x = x + cm.apply_mlp(cfg, p["mlp"], cm.apply_norm(cfg, p["ln2"], x))
    return x, new_cache


def _init_moe_layer(cfg, gen, dtype, device, lead):
    return {
        "ln1": cm.init_norm(cfg, device=device, lead=lead),
        "ln2": cm.init_norm(cfg, device=device, lead=lead),
        "attn": attn.init_self_attn(cfg, gen, dtype=dtype, device=device, lead=lead),
        "moe": moe_mod.init_moe(cfg, gen, dtype=dtype, device=device, lead=lead),
    }


def _moe_layer(cfg, p, x, positions, cache=None, cache_pos=None):
    h = cm.apply_norm(cfg, p["ln1"], x)
    out, new_cache = attn.self_attention(cfg, p["attn"], h, positions, cache=cache,
                                         cache_pos=cache_pos)
    x = x + out
    h2, aux = moe_mod.apply_moe(cfg, p["moe"], cm.apply_norm(cfg, p["ln2"], x))
    return x + h2, aux, new_cache


def _flags(cfg) -> List[bool]:
    return [k == "local" for k in cfg.layer_kinds]


def _hybrid_layout(cfg) -> Tuple[int, int, int]:
    """zamba2: (blocks per group, groups, leading blocks before the first
    group)."""
    k_grp = cfg.hybrid_attn_every
    return k_grp, cfg.num_layers // k_grp, cfg.num_layers % k_grp


def _init_rwkv_block(cfg, gen, dtype, device, lead):
    return {
        "ln1": cm.init_norm(cfg, device=device, lead=lead),
        "ln2": cm.init_norm(cfg, device=device, lead=lead),
        "tmix": ssm_mod.init_rwkv_time_mix(cfg, gen, dtype=dtype, device=device, lead=lead),
        "cmix": ssm_mod.init_rwkv_channel_mix(cfg, gen, dtype=dtype, device=device, lead=lead),
    }


def _rwkv_block(cfg, lp, h):
    h = h + ssm_mod.apply_rwkv_time_mix(cfg, lp["tmix"], cm.apply_norm(cfg, lp["ln1"], h))
    return h + ssm_mod.apply_rwkv_channel_mix(cfg, lp["cmix"], cm.apply_norm(cfg, lp["ln2"], h))


def _init_mamba_block(cfg, gen, dtype, device, lead):
    return {"ln1": cm.init_norm(cfg, device=device, lead=lead),
            "mamba": ssm_mod.init_mamba(cfg, gen, dtype=dtype, device=device, lead=lead)}


def _mamba_block(cfg, lp, h):
    return h + ssm_mod.apply_mamba(cfg, lp["mamba"], cm.apply_norm(cfg, lp["ln1"], h))


def _init_cross_decoder_layer(cfg, gen, dtype, device, lead):
    """whisper's decoder layer: a dense layer with ``ln_x`` and ``xattn``."""
    p = _init_dense_layer(cfg, gen, dtype, device, lead)
    p["ln_x"] = cm.init_norm(cfg, device=device, lead=lead)
    p["xattn"] = attn.init_cross_attn(cfg, gen, dtype=dtype, device=device, lead=lead)
    return p


def _dense_layer_with_cross(cfg, p, x, positions, memory=None, memory_kv=None, cache=None,
                            cache_pos=None):
    """Self-attention, then cross-attention under ``ln_x``, then the MLP,
    each added to the residual."""
    h = cm.apply_norm(cfg, p["ln1"], x)
    out, new_cache = attn.self_attention(cfg, p["attn"], h, positions, cache=cache,
                                         cache_pos=cache_pos)
    x = x + out
    x = x + attn.cross_attention(cfg, p["xattn"], cm.apply_norm(cfg, p["ln_x"], x),
                                 memory=memory, memory_kv=memory_kv)
    x = x + cm.apply_mlp(cfg, p["mlp"], cm.apply_norm(cfg, p["ln2"], x))
    return x, new_cache


def _vision_layout(cfg) -> Tuple[int, int]:
    """llama-3.2-vision: (groups, self layers per group); each group ends in
    one gated cross-attention layer."""
    k_grp = cfg.cross_attn_every
    return cfg.num_layers // k_grp, k_grp - 1


def _init_gated_cross(cfg, gen, dtype, device, lead):
    return {
        "ln1": cm.init_norm(cfg, device=device, lead=lead),
        "ln2": cm.init_norm(cfg, device=device, lead=lead),
        "xattn": attn.init_cross_attn(cfg, gen, dtype=dtype, device=device, lead=lead),
        "mlp": cm.init_mlp(cfg, gen, dtype=dtype, device=device, lead=lead),
        # 0 at init: the layer starts as the identity, as in the reference
        "gate_attn": torch.zeros(lead, dtype=torch.float32, device=device),
        "gate_mlp": torch.zeros(lead, dtype=torch.float32, device=device),
    }


def _gated_cross(cfg, cl, h, memory=None, memory_kv=None):
    """The vision model's cross layer: attention over the image, then the
    MLP, each scaled by ``tanh`` of its f32 gate cast to h's dtype."""
    a = attn.cross_attention(cfg, cl["xattn"], cm.apply_norm(cfg, cl["ln1"], h),
                             memory=memory, memory_kv=memory_kv)
    h = h + torch.tanh(cl["gate_attn"]).to(h.dtype) * a
    m = cm.apply_mlp(cfg, cl["mlp"], cm.apply_norm(cfg, cl["ln2"], h))
    return h + torch.tanh(cl["gate_mlp"]).to(h.dtype) * m


def _embed(cfg, params, tokens, dtype, positions: Optional[torch.Tensor] = None):
    """``positions`` (B, S) for the learned position table; None means the
    tokens start at position 0 (training)."""
    x = params["embed"][tokens].to(dtype) * cm.round_to(math.sqrt(cfg.d_model), dtype)
    if cfg.pos_embed == "learned":
        table = params["pos_embed"]
        x = x + (table[: tokens.shape[1]] if positions is None else table[positions]).to(dtype)
    return x


def _unembed(cfg, params, x):
    """Product with the tied embedding in the activation dtype, then the
    softcap in f32."""
    logits = x @ params["embed"].to(x.dtype).T
    return cm.softcap(logits.float(), cfg.final_logit_softcap)


def init_params(cfg, seed: int = 0, *, device="cuda") -> Tree:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``); on the ``meta`` device, shapes only."""

    _check_family(cfg, _DECODERS + ("encoder",))
    device = cm.resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dtype = cm.dtype_of(cfg.param_dtype)
    params = {
        "embed": cm.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype,
                               device=device),
        "final_norm": cm.init_norm(cfg, device=device),
    }
    if cfg.family == "moe":
        nd = cfg.first_k_dense
        if nd:
            params["dense_layers"] = _init_dense_layer(cfg, gen, dtype, device, (nd,))
        params["layers"] = _init_moe_layer(cfg, gen, dtype, device, (cfg.num_layers - nd,))
    elif cfg.family == "ssm":
        params["layers"] = _init_rwkv_block(cfg, gen, dtype, device, (cfg.num_layers,))
    elif cfg.family == "hybrid":
        k_grp, n_groups, n_extra = _hybrid_layout(cfg)
        if n_extra:
            params["mamba_head"] = _init_mamba_block(cfg, gen, dtype, device, (n_extra,))
        params["mamba_groups"] = _init_mamba_block(cfg, gen, dtype, device, (n_groups, k_grp))
        params["shared_attn"] = _init_dense_layer(cfg, gen, dtype, device, ())
    elif cfg.family == "audio":
        params["encoder"] = {
            "layers": _init_dense_layer(cfg, gen, dtype, device, (cfg.encoder_layers,)),
            "norm": cm.init_norm(cfg, device=device),
        }
        params["layers"] = _init_cross_decoder_layer(cfg, gen, dtype, device,
                                                     (cfg.num_layers,))
    elif cfg.family == "vlm":
        n_groups, n_self = _vision_layout(cfg)
        params["self_groups"] = _init_dense_layer(cfg, gen, dtype, device, (n_groups, n_self))
        params["cross_layers"] = _init_gated_cross(cfg, gen, dtype, device, (n_groups,))
        params["projector"] = cm.dense_init(gen, (cfg.vision_dim, cfg.d_model), dtype=dtype,
                                            device=device)
    else:
        params["layers"] = _init_dense_layer(cfg, gen, dtype, device, (cfg.num_layers,))
    if cfg.pos_embed == "learned":
        params["pos_embed"] = cm.dense_init(gen, (cfg.max_position, cfg.d_model), dtype=dtype,
                                            device=device)
    if cfg.family == "encoder":
        params["cls_head"] = {
            "w": cm.dense_init(gen, (cfg.d_model, cfg.num_labels), dtype=dtype, device=device),
            "b": torch.zeros((cfg.num_labels,), dtype=torch.float32, device=device),
        }
    return params


def _run_layer(cfg, fn, *args):
    """One layer of the training forward, under ``torch.utils.checkpoint``
    with ``cfg.remat`` while gradients are taken. The recomputation, which
    the backward runs outside the loss, sees the forward's
    ``moe.rows_split`` group."""
    if cfg.remat and torch.is_grad_enabled():
        rows = moe_mod.row_group()
        if rows is None:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), moe_mod.rows_split(rows)))
    return fn(*args)


def forward(cfg, params: Tree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (logits, aux loss). batch: tokens (B, S), and
    for audio ``frames`` (B, F, d_model), for vlm ``patches`` (B, M,
    vision_dim). Every decoder family: next-token logits (B, S, V) f32, and
    for moe the sum of the MoE layers' load-balance losses as aux (else 0);
    the recurrent families need S to be a multiple of ``cfg.ssm_chunk``
    where S exceeds it. Encoder: bidirectional layers, then the classifier
    on the first token, (B, num_labels) f32."""

    _check_family(cfg, _DECODERS + ("encoder",))
    dtype = cm.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(cfg, params, tokens, dtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    causal = cfg.family != "encoder"  # BERT-style encoders are bidirectional
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    def dense(h, lp, flag):
        return _dense_layer(cfg, lp, h, positions, flag, causal=causal)[0]

    def moe(h, lp):
        h, aux_l, _ = _moe_layer(cfg, lp, h, positions)
        return h, aux_l

    if cfg.family == "moe":
        if cfg.first_k_dense:
            for lp in cm.unbind_layers(params["dense_layers"]):
                x = _run_layer(cfg, dense, x, lp, False)
        for lp in cm.unbind_layers(params["layers"]):
            x, aux_l = _run_layer(cfg, moe, x, lp)
            aux = aux + aux_l
    elif cfg.family == "ssm":
        for lp in cm.unbind_layers(params["layers"]):
            x = _run_layer(cfg, lambda h, p: _rwkv_block(cfg, p, h), x, lp)
    elif cfg.family == "hybrid":
        if "mamba_head" in params:
            for lp in cm.unbind_layers(params["mamba_head"]):
                x = _run_layer(cfg, lambda h, p: _mamba_block(cfg, p, h), x, lp)

        def group(h, gp, shared):  # k Mamba blocks, then the shared block
            for lp in cm.unbind_layers(gp):
                h = _mamba_block(cfg, lp, h)
            return _dense_layer(cfg, shared, h, positions, False)[0]

        for gp in cm.unbind_layers(params["mamba_groups"]):
            x = _run_layer(cfg, group, x, gp, params["shared_attn"])
    elif cfg.family == "audio":
        memory = _encode(cfg, params, batch["frames"].to(dtype))

        def cross(h, lp, mem):
            return _dense_layer_with_cross(cfg, lp, h, positions, memory=mem)[0]

        for lp in cm.unbind_layers(params["layers"]):
            x = _run_layer(cfg, cross, x, lp, memory)
    elif cfg.family == "vlm":
        memory = batch["patches"].to(dtype) @ params["projector"].to(dtype)

        def vgroup(h, sg, cl, mem):  # the self layers, then the gated cross layer
            for lp in cm.unbind_layers(sg):
                h = _dense_layer(cfg, lp, h, positions, False)[0]
            return _gated_cross(cfg, cl, h, memory=mem)

        for sg, cl in zip(cm.unbind_layers(params["self_groups"]),
                          cm.unbind_layers(params["cross_layers"])):
            x = _run_layer(cfg, vgroup, x, sg, cl, memory)
    else:
        for lp, flag in zip(cm.unbind_layers(params["layers"]), _flags(cfg)):
            x = _run_layer(cfg, dense, x, lp, flag)

    x = cm.apply_norm(cfg, params["final_norm"], x)
    if cfg.family == "encoder":
        cls = x[:, 0]
        logits = cls @ params["cls_head"]["w"].to(x.dtype) + params["cls_head"]["b"]
        return logits.float(), aux
    return _unembed(cfg, params, x), aux


def _encode(cfg, params, frames):
    """whisper's encoder: sinusoidal positions on the frames, bidirectional
    self-attention layers, the final norm. Returns the memory (B, F, D)."""
    B, F = frames.shape[:2]
    enc = frames + cm.sinusoidal_pos(F, cfg.d_model, frames.dtype, frames.device)[None]
    enc_pos = torch.arange(F, dtype=torch.int32, device=frames.device)[None].expand(B, F)

    def layer(h, lp):
        return _dense_layer(cfg, lp, h, enc_pos, None, causal=False)[0]

    for lp in cm.unbind_layers(params["encoder"]["layers"]):
        enc = _run_layer(cfg, layer, enc, lp)
    return cm.apply_norm(cfg, params["encoder"]["norm"], enc)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> Tree:
    """The decode cache, leaves stacked over layers: dense {"kv": {"k",
    "v"}} of (L, B, T, KV, Dh), or with MLA {"kv": {"ckv" (L, B, T, r),
    "krope" (L, B, T, Dr)}}; moe {"kv"} over its MoE layers and, with
    leading dense layers, {"dense_kv"} over those. The recurrent families
    hold state with no time axis: ssm {"layers": {"S" (L, B, H, K, K) f32
    whatever ``dtype``, "x_att", "x_ffn" (L, B, D)}}; hybrid {"groups":
    {"ssm" (G, k, B, H, P, N), "conv" (G, k, B, K - 1, C)}, "attn_kv"
    (G, B, T, KV, Dh) for the shared block's G uses and, with leading
    blocks, "head" as "groups" over those}. The cross-attending families
    add "cross_kv" {"k", "v"}, zeros as in the reference (fill it with
    ``attention.cross_kv`` of the memory): audio {"kv" over the decoder
    layers, "cross_kv" (L, B, encoder_seq, KV, Dh)}; vlm {"self_kv" (G,
    n_self, B, T, KV, Dh), "cross_kv" (G, B, vision_tokens, KV, Dh)}."""

    _check_family(cfg)
    device = cm.resolve_device(device)

    def one(n):
        init = attn.init_mla_cache if cfg.use_mla else attn.init_kv_cache
        return init(cfg, batch, cache_len, dtype, device=device, lead=(n,))

    if cfg.family == "ssm":
        return {"layers": ssm_mod.init_rwkv_state(cfg, batch, dtype, device=device,
                                                  lead=(cfg.num_layers,))}
    if cfg.family == "hybrid":
        k_grp, n_groups, n_extra = _hybrid_layout(cfg)
        cache = {"groups": ssm_mod.init_mamba_state(cfg, batch, dtype, device=device,
                                                    lead=(n_groups, k_grp)),
                 "attn_kv": attn.init_kv_cache(cfg, batch, cache_len, dtype, device=device,
                                               lead=(n_groups,))}
        if n_extra:
            cache["head"] = ssm_mod.init_mamba_state(cfg, batch, dtype, device=device,
                                                     lead=(n_extra,))
        return cache
    if cfg.family == "audio":
        return {"kv": one(cfg.num_layers),
                "cross_kv": attn.init_kv_cache(cfg, batch, cfg.encoder_seq, dtype,
                                               device=device, lead=(cfg.num_layers,))}
    if cfg.family == "vlm":
        n_groups, n_self = _vision_layout(cfg)
        return {"self_kv": attn.init_kv_cache(cfg, batch, cache_len, dtype, device=device,
                                              lead=(n_groups, n_self)),
                "cross_kv": attn.init_kv_cache(cfg, batch, cfg.vision_tokens, dtype,
                                               device=device, lead=(n_groups,))}
    if cfg.family == "moe":
        nd = cfg.first_k_dense
        cache = {"kv": attn.init_kv_cache(cfg, batch, cache_len, dtype, device=device,
                                          lead=(cfg.num_layers - nd,))}
        if nd:
            cache["dense_kv"] = one(nd)
        return cache
    return {"kv": one(cfg.num_layers)}


def decode_step(cfg, params: Tree, cache: Tree, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, S) int — S = 1 for one-token decode, S > 1 for a
    teacher-forced prefill block (attention caches only: the recurrent
    families advance their state one token per call, and their prefill is
    the token scan of ``repro_torch.serve.prefill``).

    pos: position of tokens[:, 0] — an int when every lane is at the same
    position, or a (B,) tensor of per-lane positions (continuous batching
    over staggered sequences). Token j of the block lands at pos + j.

    The new cache rows are written into ``cache`` in place (where JAX
    returns a new cache); the same tree is returned. A MoE layer routes
    the B x S tokens of the call as its dispatch group (under continuous
    batching, one token per lane). Returns (logits (B,S,V) f32, cache)."""

    _check_family(cfg)
    dtype = cm.dtype_of(cfg.dtype)
    B, S = tokens.shape
    dev = tokens.device
    if S != 1 and cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} is recurrent: decode_step advances one token per "
            "call (chunked prefill uses the token-scan path, repro_torch.serve.prefill)")
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos_col = pos.to(device=dev, dtype=torch.int32)[:, None]
    else:
        pos_col = torch.full((B, 1), int(pos), dtype=torch.int32, device=dev)
    positions = pos_col + torch.arange(S, dtype=torch.int32, device=dev)[None]
    x = _embed(cfg, params, tokens, dtype, positions)

    def layer_caches(stack):  # per layer, views into the stacked leaves
        return [{name: leaf[i] for name, leaf in stack.items()}
                for i in range(next(iter(stack.values())).shape[0])]

    def commit(stack, idx, new):  # a layer's new state, into its stacked leaves
        for name, value in new.items():
            stack[name][idx].copy_(value)

    def mamba_step(h, lp, stack, idx):
        st = {name: leaf[idx] for name, leaf in stack.items()}
        out, new = ssm_mod.mamba_decode(cfg, lp["mamba"], cm.apply_norm(cfg, lp["ln1"], h), st)
        commit(stack, idx, new)
        return h + out

    if cfg.family == "ssm":
        stack = cache["layers"]
        for i in range(cfg.num_layers):
            lp = cm.unstack_layer(params["layers"], i)
            st = {name: leaf[i] for name, leaf in stack.items()}
            out, st_att = ssm_mod.rwkv_time_mix_decode(cfg, lp["tmix"],
                                                       cm.apply_norm(cfg, lp["ln1"], x), st)
            x = x + out
            out, st_ffn = ssm_mod.rwkv_channel_mix_decode(cfg, lp["cmix"],
                                                          cm.apply_norm(cfg, lp["ln2"], x), st)
            x = x + out
            commit(stack, i, {**st_att, **st_ffn})
    elif cfg.family == "hybrid":
        k_grp, n_groups, n_extra = _hybrid_layout(cfg)
        for i in range(n_extra):
            x = mamba_step(x, cm.unstack_layer(params["mamba_head"], i), cache["head"], i)
        akv = cache["attn_kv"]
        for g in range(n_groups):
            gp = cm.unstack_layer(params["mamba_groups"], g)
            for j in range(k_grp):
                x = mamba_step(x, cm.unstack_layer(gp, j), cache["groups"], (g, j))
            x, _ = _dense_layer(cfg, params["shared_attn"], x, positions, False,
                                {"k": akv["k"][g], "v": akv["v"][g]}, pos)
    elif cfg.family == "audio":
        xkv = cache["cross_kv"]
        for i, lc in enumerate(layer_caches(cache["kv"])):
            x, _ = _dense_layer_with_cross(cfg, cm.unstack_layer(params["layers"], i), x,
                                           positions, memory_kv={"k": xkv["k"][i],
                                                                 "v": xkv["v"][i]},
                                           cache=lc, cache_pos=pos)
    elif cfg.family == "vlm":
        n_groups, n_self = _vision_layout(cfg)
        skv, xkv = cache["self_kv"], cache["cross_kv"]
        for g in range(n_groups):
            sg = cm.unstack_layer(params["self_groups"], g)
            for j in range(n_self):
                x, _ = _dense_layer(cfg, cm.unstack_layer(sg, j), x, positions, False,
                                    {"k": skv["k"][g, j], "v": skv["v"][g, j]}, pos)
            x = _gated_cross(cfg, cm.unstack_layer(params["cross_layers"], g), x,
                             memory_kv={"k": xkv["k"][g], "v": xkv["v"][g]})
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            for i, lc in enumerate(layer_caches(cache["dense_kv"])):
                x, _ = _dense_layer(cfg, cm.unstack_layer(params["dense_layers"], i), x,
                                    positions, False, lc, pos)
        for i, lc in enumerate(layer_caches(cache["kv"])):
            x, _, _ = _moe_layer(cfg, cm.unstack_layer(params["layers"], i), x, positions,
                                 lc, pos)
    else:
        for i, (flag, lc) in enumerate(zip(_flags(cfg), layer_caches(cache["kv"]))):
            x, _ = _dense_layer(cfg, cm.unstack_layer(params["layers"], i), x, positions,
                                flag, lc, pos)

    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), cache
