"""Model assembly of the dense family (GQA attention + MLP, heterogeneous
local/global layers): init, the decode cache and the decode step, after
``src/repro/models/transformer.py``.

Layer parameters and the cache carry a leading layer axis, as the JAX
stacks do; the decode step walks the layers in a Python loop where JAX
scans them. ``forward`` (training) and the other families come with their
slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm

Tree = Any


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.use_mla:
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family!r}, use_mla={cfg.use_mla}) is not "
            "ported yet: the port runs the dense family without MLA")


def _dense_layer(cfg, p, x, positions, flag, cache, cache_pos):
    h = cm.apply_norm(cfg, p["ln1"], x)
    out, new_cache = attn.self_attention(cfg, p["attn"], h, positions, local_flag=flag,
                                         cache=cache, cache_pos=cache_pos)
    x = x + out
    x = x + cm.apply_mlp(cfg, p["mlp"], cm.apply_norm(cfg, p["ln2"], x))
    return x, new_cache


def _flags(cfg) -> List[bool]:
    return [k == "local" for k in cfg.layer_kinds]


def _embed(cfg, params, tokens, dtype):
    return params["embed"][tokens].to(dtype) * cm.round_to(math.sqrt(cfg.d_model), dtype)


def _unembed(cfg, params, x):
    """Product with the tied embedding in the activation dtype, then the
    softcap in f32."""
    logits = x @ params["embed"].to(x.dtype).T
    return cm.softcap(logits.float(), cfg.final_logit_softcap)


def init_params(cfg, seed: int = 0, *, device="cuda") -> Tree:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``); on the ``meta`` device, shapes only."""

    _check_family(cfg)
    device = cm.resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    dtype = cm.dtype_of(cfg.param_dtype)
    lead = (cfg.num_layers,)
    return {
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
    x = _embed(cfg, params, tokens, dtype)

    kv = cache["kv"]
    for i, flag in enumerate(_flags(cfg)):
        layer_cache = {"k": kv["k"][i], "v": kv["v"][i]}  # views into the stack
        x, _ = _dense_layer(cfg, cm.unstack_layer(params["layers"], i), x, positions,
                            flag, layer_cache, pos)

    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), cache
