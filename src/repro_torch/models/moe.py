"""Mixture-of-Experts layer, after ``src/repro/models/moe.py``: a top-k
router with capacity-based one-hot dispatch (GShard/Switch style),
optional always-on shared experts (Qwen-MoE, Kimi-K2) and the auxiliary
load-balance loss.

Expert weights carry an E axis after the layer axis, ``(L, E, D, F)``,
as the JAX package's ``stacked_init`` nested in the layer stack's, so the
trees cross leaf for leaf (``repro_torch.convert``). The router, dispatch
and experts are einsums in both packages, no kernel: the reference vmaps
one dispatch group at a time, the port runs all groups in one einsum with
a leading group axis, each group's arithmetic unchanged.

Tokens are dispatched in groups of ``MOE_GROUP``; a token count above it
must be a multiple of it (the reference asserts this, the port raises).

Under a live model axis a loss's rows are split over the model group
(``launch.fsdp``, which enters :func:`rows_split` around each loss), while
the reference routes its data shard's tokens as one call. The layer then
computes the reference's function of the whole shard: where this rank's
rows hold whole dispatch groups it routes them itself and sums the
load-balance statistics over the group; otherwise it gathers the call's
tokens over the group, routes them all and keeps its rows of the output.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
from torch.profiler import record_function

from repro_torch.models import common as cm

Tree = Any

MOE_GROUP = 1024  # tokens per dispatch group: bounds the one-hot dispatch
# tensor to (G, E, C) with C ~ k G / E

#: the model groups over which the running loss's rows are split, innermost
#: last (None: not split); a plain list, not a context variable, since
#: autograd may recompute a layer on its own threads
_ROWS: List[Any] = []


class rows_split:
    """Within the block a MoE layer's rows are this rank's of a data shard
    split over ``group`` (a ``launch.fsdp.FSDP``: ``mesh``, ``gather_rows``,
    ``group_sum``), or not split (None). Enterable again: remat's
    recomputation enters one such block at each backward that needs it."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        _ROWS.append(self.group)
        return self.group

    def __exit__(self, *exc):
        _ROWS.pop()


def row_group():
    """The innermost :func:`rows_split` group, or None."""
    return _ROWS[-1] if _ROWS else None


def init_moe(cfg, gen, *, dtype=torch.float32, device, lead: Tuple[int, ...] = ()):
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    lead = tuple(lead)
    p = {
        "router": cm.dense_init(gen, (D, E), dtype=torch.float32, device=device, lead=lead),
        "experts": init_expert_ffn(cfg, gen, D, Fe, dtype=dtype, device=device,
                                   lead=lead + (E,)),
    }
    if cfg.num_shared_experts:
        p["shared"] = cm.init_mlp(cfg, gen, d_in=D,
                                  d_ff=cfg.shared_d_ff or cfg.num_shared_experts * Fe,
                                  dtype=dtype, device=device, lead=lead)
    return p


def init_expert_ffn(cfg, gen, d: int, f: int, *, dtype=torch.float32, device,
                    lead: Tuple[int, ...] = ()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"up": cm.dense_init(gen, (d, f), **kw), "down": cm.dense_init(gen, (f, d), **kw)}
    if cfg.mlp_type == "glu":
        p["gate"] = cm.dense_init(gen, (d, f), **kw)
    return p


def _expert_ffn(cfg, p, x):
    """x: (n, E, C, D) with per-expert stacked weights (E, ...); the
    weights cast to x's dtype at each product, as in the reference."""
    act = cm._act(cfg.act)
    up = torch.einsum("necd,edf->necf", x, p["up"].to(x.dtype))
    if cfg.mlp_type == "glu":
        up = up * act(torch.einsum("necd,edf->necf", x, p["gate"].to(x.dtype)))
    else:
        up = act(up)
    return torch.einsum("necf,efd->necd", up, p["down"].to(x.dtype))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest entries along the last axis, in
    descending order, equal entries by the lower index first (a stable
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, probs: torch.Tensor, capacity: int):
    """The routing of every dispatch group. probs: (n, G, E) f32.
    Returns (expert_idx (n, G, K), keep (n, K, G) bool: whether each
    (choice, token) got a capacity slot, dispatch and combine (n, G, E, C)
    f32). Capacity positions are choice-major, as in the reference: every
    token's first choice takes its slot before any second choice."""

    n, G, E = probs.shape
    K = cfg.top_k
    gate_vals, expert_idx = top_k(probs, K)  # (n, G, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    assign = cm.one_hot(expert_idx, E)  # (n, G, K, E)
    flat = assign.transpose(1, 2).reshape(n, K * G, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(pos * flat, dim=-1)  # (n, K*G)
    keep = (pos < capacity) & (flat.sum(-1) > 0)
    # jax.nn.one_hot of an index >= capacity is all zeros; keep is False there
    pos_oh = cm.one_hot(pos.long().clamp_max(capacity - 1), capacity) * keep[..., None]
    flat_k = flat.reshape(n, K, G, E)
    pos_oh_k = pos_oh.reshape(n, K, G, capacity)
    dispatch = torch.einsum("nkge,nkgc->ngec", flat_k, pos_oh_k)  # 0/1
    gates_k = gate_vals.transpose(1, 2)  # (n, K, G)
    combine = torch.einsum("nkge,nkgc->ngec", flat_k * gates_k[..., None], pos_oh_k)
    return expert_idx, keep.reshape(n, K, G), dispatch, combine


def moe_capacity(cfg, group: int) -> int:
    return max(int(cfg.capacity_factor * cfg.top_k * group / cfg.num_experts), 4)


def moe_groups(T: int) -> Tuple[int, int]:
    """(n_groups, group) for T tokens; raises where the reference asserts."""
    group = min(MOE_GROUP, T)
    n_groups = T // group
    if n_groups * group != T:
        raise ValueError(
            f"apply_moe: {T} tokens are neither at most the dispatch group MOE_GROUP = "
            f"{MOE_GROUP} nor a multiple of it (group {group}); B * S must be")
    return n_groups, group


def router_probs(p, tokens: torch.Tensor) -> torch.Tensor:
    """Router logits and softmax in f32. tokens: (n, G, D)."""
    logits = torch.einsum("ngd,de->nge", tokens.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)


@record_function("apply_moe")
def apply_moe(cfg, p: Tree, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B, S, D), the GShard load-balance aux
    loss, f32 scalar). A ``torch.profiler`` range of its name holds the
    call (its forward, and its recomputation under remat). Within
    :func:`rows_split` ``x`` is this rank's rows of the data shard, and
    the layer computes the whole shard's function (module docstring)."""

    B, S, D = x.shape
    E = cfg.num_experts
    rows = row_group()
    # this rank's tokens hold whole dispatch groups of the data shard's
    whole = rows is None or (B * S) % MOE_GROUP == 0
    tokens_in = x if whole else rows.gather_rows(x)
    T = tokens_in.shape[0] * S
    n_groups, group = moe_groups(T)
    capacity = moe_capacity(cfg, group)

    tokens = tokens_in.reshape(n_groups, group, D)
    probs = router_probs(p, tokens)  # (n, G, E)
    expert_idx, _, dispatch, combine = route(cfg, probs, capacity)
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(tokens.dtype), tokens)
    expert_out = _expert_ffn(cfg, p["experts"], expert_in)  # (n, E, C, D)
    out = torch.einsum("ngec,necd->ngd", combine.to(tokens.dtype), expert_out)
    out = out.reshape(T, D)
    if not whole:  # this rank's rows of the gathered call
        out = out.reshape(-1, B * S, D)[rows.mesh.model_rank]

    if cfg.num_shared_experts:
        out = out + cm.apply_mlp(cfg, p["shared"], x.reshape(B * S, D))

    # GShard aux loss: E * sum_e f_e * p_e over the whole batch (the
    # reference takes top_k of the same rows again: the same indices)
    probs_flat = probs.reshape(T, E)
    assign = cm.one_hot(expert_idx.reshape(T, -1), E)
    if whole and rows is not None and rows.mesh.model_size > 1:
        # the shard's means from the group's sums (the all-reduce's backward
        # sums the ranks' cotangents, so each rank's probs get the whole
        # shard's gradient share once)
        n = T * rows.mesh.model_size
        me = rows.group_sum(probs_flat.sum(0)) / n
        ce = rows.group_sum(assign.sum(1).sum(0)) / n
    else:
        me = probs_flat.mean(0)
        ce = assign.sum(1).mean(0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return out.reshape(B, S, D), aux.float()
