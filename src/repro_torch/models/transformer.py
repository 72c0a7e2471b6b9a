"""Model assembly, after ``src/repro/models/transformer.py``, for three
families: ``dense`` (GQA or MLA attention + MLP, heterogeneous
local/global layers), ``moe`` (leading dense layers, then attention +
mixture-of-experts layers whose load-balance aux losses sum into the
forward's aux) and ``encoder`` (the BERT-style classifier: init and
forward). For dense and moe: init, the training forward, the decode cache
and the decode step. The recurrent, audio and vision families come with
their slices (ROADMAP queue 1 items 4b and 4c).

Layer parameters and the cache carry a leading layer axis, as the JAX
stacks do; the forward and the decode step walk the layers in a Python
loop where JAX scans them. With ``cfg.remat`` each layer of the forward
runs under ``torch.utils.checkpoint``: its activations are recomputed in
the backward pass, as ``jax.checkpoint`` on the JAX scan body does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod

Tree = Any

#: the ROADMAP item that ports each family the port does not run yet
_UNPORTED = {"ssm": "queue 1 item 4b", "hybrid": "queue 1 item 4b",
             "audio": "queue 1 item 4c", "vlm": "queue 1 item 4c"}


def _check_family(cfg, families=("dense", "moe")) -> None:
    if cfg.family not in families:
        where = _UNPORTED.get(cfg.family)
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}) is not ported here: this path runs the "
            f"{'/'.join(families)} families"
            + (f"; ROADMAP {where} ports it" if where else ""))


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

    _check_family(cfg, ("dense", "moe", "encoder"))
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
    with ``cfg.remat`` while gradients are taken."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(cfg, params: Tree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (logits, aux loss). batch: tokens (B, S).
    Dense and moe: next-token logits (B, S, V) f32, and for moe the sum of
    the MoE layers' load-balance losses as aux (else 0). Encoder:
    bidirectional layers, then the classifier on the first token,
    (B, num_labels) f32."""

    _check_family(cfg, ("dense", "moe", "encoder"))
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
    else:
        for lp, flag in zip(cm.unbind_layers(params["layers"]), _flags(cfg)):
            x = _run_layer(cfg, dense, x, lp, flag)

    x = cm.apply_norm(cfg, params["final_norm"], x)
    if cfg.family == "encoder":
        cls = x[:, 0]
        logits = cls @ params["cls_head"]["w"].to(x.dtype) + params["cls_head"]["b"]
        return logits.float(), aux
    return _unembed(cfg, params, x), aux


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> Tree:
    """The decode cache, leaves stacked over layers: dense {"kv": {"k",
    "v"}} of (L, B, T, KV, Dh), or with MLA {"kv": {"ckv" (L, B, T, r),
    "krope" (L, B, T, Dr)}}; moe {"kv"} over its MoE layers and, with
    leading dense layers, {"dense_kv"} over those."""

    _check_family(cfg)
    device = cm.resolve_device(device)

    def one(n):
        init = attn.init_mla_cache if cfg.use_mla else attn.init_kv_cache
        return init(cfg, batch, cache_len, dtype, device=device, lead=(n,))

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
    teacher-forced prefill block.

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
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        pos_col = pos.to(device=dev, dtype=torch.int32)[:, None]
    else:
        pos_col = torch.full((B, 1), int(pos), dtype=torch.int32, device=dev)
    positions = pos_col + torch.arange(S, dtype=torch.int32, device=dev)[None]
    x = _embed(cfg, params, tokens, dtype, positions)

    def layer_caches(stack):  # per layer, views into the stacked leaves
        return [{name: leaf[i] for name, leaf in stack.items()}
                for i in range(next(iter(stack.values())).shape[0])]

    if cfg.family == "moe":
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
