"""Shared model building blocks: norms, MLPs, RoPE, initializers, and the
small nested-dict tree helpers the port uses in place of ``jax.tree_util``.

Parameters are nested dicts of tensors. Layer stacks carry a leading layer
axis, as the JAX package's ``lax.scan`` stacks do, so the two parameter
trees map one to one; the port walks the layers in a Python loop.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` needs a card: without
    one this raises instead of carrying on on the CPU."""

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev


def round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to f32 and then to ``dtype``, as the JAX code forms its
    scalar factors (``jnp.sqrt(n).astype(dtype)``): sqrt(1152) is 34.0 in
    bf16, not 33.94."""

    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def tree_flatten(tree: Tree) -> Tuple[List[Any], Tuple[Tuple[str, ...], ...]]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts) and their key paths, which serve as the treedef."""

    paths: List[Tuple[str, ...]] = []
    leaves: List[Any] = []

    def rec(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                rec(node[key], path + (key,))
        else:
            paths.append(path)
            leaves.append(node)

    rec(tree, ())
    return leaves, tuple(paths)


def tree_unflatten(paths: Sequence[Tuple[str, ...]], leaves: Sequence[Any]) -> Tree:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree: Tree) -> Tree:
    leaves, paths = tree_flatten(tree)
    return tree_unflatten(paths, [fn(x) for x in leaves])


def unstack_layer(params: Tree, idx: int) -> Tree:
    """One layer's params from a stacked tree (views, no copies)."""
    return tree_map(lambda x: x[idx], params)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

_PHI_MINUS_2 = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))


def dense_init(gen: Optional[torch.Generator], shape, *, device, scale: float = 1.0,
               dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """Truncated-normal (at +-2 sigma) fan-in init of a ``shape`` weight,
    stacked over the ``lead`` axes. ``gen=None`` on the ``meta`` device
    allocates shapes only. The draws differ from ``jax.random``'s; carry
    JAX's parameters across with ``repro_torch.convert`` to compare."""

    full = tuple(lead) + tuple(shape)
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(full, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    u = torch.rand(full, generator=gen, dtype=torch.float32, device=device)
    u = u * (1.0 - 2.0 * _PHI_MINUS_2) + _PHI_MINUS_2
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg, *, device, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p, x, eps=1e-6):
    """In f32, cast back to the input dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP / GLU
# ---------------------------------------------------------------------------


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact erf
    return F.gelu(x, approximate="tanh")


def _act(name):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def init_mlp(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = ()):
    d_in, d_ff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"up": dense_init(gen, (d_in, d_ff), **kw),
         "down": dense_init(gen, (d_ff, d_in), **kw)}
    if cfg.mlp_type == "glu":
        p["gate"] = dense_init(gen, (d_in, d_ff), **kw)
    return p


def apply_mlp(cfg, p, x):
    """Weights are kept in f32 and cast to the activation dtype at each
    product, as the JAX code does."""
    act = _act(cfg.act)
    up = x @ p["up"].to(x.dtype)
    if cfg.mlp_type == "glu":
        up = up * act(x @ p["gate"].to(x.dtype))
    else:
        up = act(up)
    return up @ p["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates the
    split halves (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (D/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
