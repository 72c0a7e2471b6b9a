"""Model assembly, after ``src/repro/models/transformer.py``, for two
families: ``dense`` (GQA attention + MLP, heterogeneous local/global
layers: init, the training forward, the decode cache and the decode step)
and ``encoder`` (the BERT-style classifier: init and forward). The other
families come with their slices.

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

Tree = Any


def _check_family(cfg, families=("dense",)) -> None:
    if cfg.family not in families or cfg.use_mla:
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}, use_mla={cfg.use_mla}) is not "
            f"ported yet here: this path runs the {'/'.join(families)} families without MLA")


def _dense_layer(cfg, p, x, positions, flag, cache=None, cache_pos=None, causal=True):
    h = cm.apply_norm(cfg, p["ln1"], x)
    out, new_cache = attn.self_attention(cfg, p["attn"], h, positions, local_flag=flag,
                                         causal=causal, cache=cache, cache_pos=cache_pos)
    x = x + out
    x = x + cm.apply_mlp(cfg, p["mlp"], cm.apply_norm(cfg, p["ln2"], x))
    return x, new_cache


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

    _check_family(cfg, ("dense", "encoder"))
    device = cm.resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dtype = cm.dtype_of(cfg.param_dtype)
    lead = (cfg.num_layers,)
    params = {
        "embed": cm.dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype,
                               device=device),
        "final_norm": cm.init_norm(cfg, device=device),
        "layers": {
            "ln1": cm.init_norm(cfg, device=device, lead=lead),
            "ln2": cm.init_norm(cfg, device=device, lead=lead),
            "attn": attn.init_self_attn(cfg, gen, dtype=dtype, device=device, lead=lead),
            "mlp": cm.init_mlp(cfg, gen, dtype=dtype, device=device, lead=lead),
        },
    }
    if cfg.pos_embed == "learned":
        params["pos_embed"] = cm.dense_init(gen, (cfg.max_position, cfg.d_model), dtype=dtype,
                                            device=device)
    if cfg.family == "encoder":
        params["cls_head"] = {
            "w": cm.dense_init(gen, (cfg.d_model, cfg.num_labels), dtype=dtype, device=device),
            "b": torch.zeros((cfg.num_labels,), dtype=torch.float32, device=device),
        }
    return params


def forward(cfg, params: Tree, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (logits, aux loss). batch: tokens (B, S).
    Dense: next-token logits (B, S, V) f32. Encoder: bidirectional layers,
    then the classifier on the first token, (B, num_labels) f32."""

    _check_family(cfg, ("dense", "encoder"))
    dtype = cm.dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(cfg, params, tokens, dtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    causal = cfg.family != "encoder"  # BERT-style encoders are bidirectional

    def layer(h, lp, flag):
        return _dense_layer(cfg, lp, h, positions, flag, causal=causal)[0]

    for lp, flag in zip(cm.unbind_layers(params["layers"]), _flags(cfg)):
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(layer, x, lp, flag, use_reentrant=False)
        else:
            x = layer(x, lp, flag)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    if cfg.family == "encoder":
        cls = x[:, 0]
        logits = cls @ params["cls_head"]["w"].to(x.dtype) + params["cls_head"]["b"]
        return logits.float(), aux
    return _unembed(cfg, params, x), aux


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device="cuda") -> Tree:
    """The decode cache: {"kv": {"k", "v"}} of (L, B, T, KV, Dh)."""

    _check_family(cfg)
    device = cm.resolve_device(device)
    return {"kv": attn.init_kv_cache(cfg, batch, cache_len, dtype, device=device,
                                     lead=(cfg.num_layers,))}


def decode_step(cfg, params: Tree, cache: Tree, tokens: torch.Tensor,
                pos) -> Tuple[torch.Tensor, Tree]:
    """tokens: (B, S) int — S = 1 for one-token decode, S > 1 for a
    teacher-forced prefill block.

    pos: position of tokens[:, 0] — an int when every lane is at the same
    position, or a (B,) tensor of per-lane positions (continuous batching
    over staggered sequences). Token j of the block lands at pos + j.

    The new K/V rows are written into ``cache`` in place (where JAX returns
    a new cache); the same tree is returned. Returns (logits (B,S,V) f32,
    cache)."""

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

    kv = cache["kv"]
    for i, flag in enumerate(_flags(cfg)):
        layer_cache = {"k": kv["k"][i], "v": kv["v"][i]}  # views into the stack
        x, _ = _dense_layer(cfg, cm.unstack_layer(params["layers"], i), x, positions,
                            flag, layer_cache, pos)

    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), cache
