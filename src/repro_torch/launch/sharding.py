"""Parameter, batch and cache partition rules, after
``src/repro/launch/sharding.py``.

The rules are the reference's, one for one. The "model" axis lays out:
  column-parallel (output dim sharded): QKV projections, MLP up and gate,
    MLA decompressors, SSM in-projections, embeddings (vocabulary-sharded);
  row-parallel (input dim sharded): attention O, MLP down, SSM out-proj;
  expert-parallel: MoE expert stacks shard their leading E axis;
  replicated: norms, biases, scalars, routers, meta-learner parameters.

Rules are matched on a leaf's path as ``tree.flatten_with_keys`` renders it
(``jax.tree_util.keystr`` form, "['layers']['attn']['wq']"), most specific
first, and give the spec of the TRAILING dims; leading stacked-layer axes
are padded with None, so one table covers flat, scanned and grouped stacks.

A spec is a tuple with one entry per dim, as a ``PartitionSpec``: None
(replicated), an axis name, or a tuple of axis names; ``()`` replicates a
leaf whole. The port stores a leaf whose spec names "model" as this rank's
contiguous block along that dim, the block a ``NamedSharding`` with the
same spec places on the device (:func:`shard`), and gathers it whole where
it is read (:func:`unshard`; ``launch.fsdp`` for the autograd form).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import torch

from repro_torch import tree as tu

Tree = Any
Spec = Tuple[Any, ...]

# (path regex, candidate trailing-dims specs). First rule match wins; within
# a rule, the first candidate whose sharded dims all divide evenly wins
# (qwen's 60 experts do not split 16 ways: tensor parallel within each
# expert instead of replicating the expert stack).
_PARAM_RULES = [
    # --- MoE ---
    (r"experts.*(up|gate)", [("model", None, None), (None, None, "model")]),
    (r"experts.*down", [("model", None, None), (None, "model", None)]),
    (r"moe.*router", (None, None)),
    # --- rwkv channel-mix (wv is a down-projection here) ---
    (r"cmix.*wv", ("model", None)),
    (r"cmix.*(wk|wr)", (None, "model")),
    # --- rwkv time-mix ---
    (r"tmix.*wo", ("model", None)),
    (r"tmix.*(wr|wk|wv|wg)\b", (None, "model")),
    (r"tmix.*(wA|wB)", (None, None)),  # decay LoRA: tiny, replicated
    (r"tmix.*\bu\b", (None, None)),
    # --- MLA ---
    (r"(wq_a|wkv_a)", (None, None)),  # into tiny latent ranks: replicated
    (r"(wq_b|wkv_b)", (None, "model")),
    # --- attention / cross-attention ---
    (r"(attn|xattn).*wo", ("model", None)),
    (r"(attn|xattn).*(wq|wk|wv)", (None, "model")),
    # --- MLPs (incl. MoE shared expert) ---
    (r"(mlp|shared).*down", ("model", None)),
    (r"(mlp|shared).*(up|gate)", (None, "model")),
    # --- mamba ---
    (r"in_proj", (None, "model")),
    (r"out_proj", ("model", None)),
    (r"conv_w", ("model", None)),
    (r"conv_b", ("model",)),
    # --- embeddings / heads ---
    (r"pos_embed", (None, None)),
    (r"embed", ("model", None)),  # vocab-sharded
    (r"projector", (None, "model")),
    (r"cls_head", (None, None)),
]


def _head_aligned(path: str, cfg, mesh) -> bool:
    """Attention projections are sharded only where whole heads land on
    each rank (the reference's rule; under FSDP it decides the layout of
    the stored blocks, not the math)."""

    if cfg is None:
        return True
    model = mesh.shape.get("model", 1)
    if re.search(r"(attn|xattn).*(wk|wv)\b", path):
        return cfg.num_kv_heads % model == 0 and cfg.num_kv_heads > 0
    if re.search(r"(attn|xattn).*(wq|wo)\b", path) or re.search(r"(wq_b|wkv_b)", path):
        return cfg.num_heads % model == 0 and cfg.num_heads > 0
    return True


def param_spec(path: str, shape: Tuple[int, ...], mesh, cfg=None) -> Spec:
    ndim = len(shape)
    if not _head_aligned(path, cfg, mesh):
        return ()
    for pat, candidates in _PARAM_RULES:
        if not re.search(pat, path):
            continue
        if isinstance(candidates, tuple):
            candidates = [candidates]
        chosen = None
        for trailing in candidates:
            if len(trailing) > ndim:
                continue
            dims = [None] * (ndim - len(trailing)) + list(trailing)
            if all(ax is None or shape[i] % mesh.shape[ax] == 0 for i, ax in enumerate(dims)):
                chosen = dims
                break
        if chosen is None:
            # last resort: the first candidate with its indivisible dims replicated
            trailing = candidates[0]
            if len(trailing) > ndim:
                return ()
            chosen = [None] * (ndim - len(trailing)) + list(trailing)
            for i, ax in enumerate(chosen):
                if ax is not None and shape[i] % mesh.shape[ax] != 0:
                    chosen[i] = None
        return tuple(chosen)
    return ()  # replicated by default (norms, biases, scalars)


def param_specs(tree: Tree, mesh, cfg=None) -> Tuple[List[str], List[Spec]]:
    """The leaves' names (``tree.flatten_with_keys``) and their specs, in
    leaf order."""

    names, leaves = tu.flatten_with_keys(tree)
    return names, [param_spec(n, tuple(x.shape), mesh, cfg) for n, x in zip(names, leaves)]


def tree_param_specs(tree: Tree, mesh, cfg=None) -> Tree:
    """A tree like ``tree`` (of tensors, or of anything with a ``shape``)
    with each leaf's spec tuple in its place. ``cfg`` enables the
    head-alignment rule. Walk it alongside ``tree`` with
    :func:`param_specs`, which gives the same specs as a list."""

    return tu.unflatten_like(tree, param_specs(tree, mesh, cfg)[1])


# ---------------------------------------------------------------------------
# batch and cache specs
# ---------------------------------------------------------------------------


def _divisible(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def _dp_entry(dp: Tuple[str, ...]):
    """A spec entry for the data axes: the bare name when there is one,
    the tuple when the batch shards over pod x data jointly."""
    return dp[0] if len(dp) == 1 else dp


def _dp(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(mesh, *, leading_unroll: bool = False) -> Spec:
    """Shard the (global) batch dim over pod x data (one axis as its bare
    name, as a ``PartitionSpec`` normalises it)."""
    dp = _dp_entry(_dp(mesh))
    if leading_unroll:
        return (None, dp)
    return (dp,)


def dp_size(mesh) -> int:
    n = 1
    for a in _dp(mesh):
        n *= mesh.shape[a]
    return n


def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """Decode-cache sharding. Batch-shards when the batch divides the dp
    axes; otherwise (B = 1 at long context) shards the cache's sequence
    over data and heads over model where divisible. A pure function here:
    serving takes no mesh in either package."""

    dp = _dp(mesh)
    dpn = dp_size(mesh)
    ndim = len(shape)
    is_kv = re.search(r"(kv|krope|ckv)", path) is not None

    if is_kv:
        # trailing dims for plain kv: (B, T, KV, Dh); mla ckv: (B, T, r); krope: (B, T, dr)
        n_lead = ndim - (4 if re.search(r"(attn_kv|kv)", path)
                         and not re.search(r"ckv|krope", path) else 3)
        lead = (None,) * max(n_lead, 0)
        b = shape[len(lead)]
        t_axis_shardable = _divisible(shape[len(lead) + 1], mesh, "data")
        if b % dpn == 0 and b >= dpn:
            spec = (_dp_entry(dp), None) + ((None,) * (ndim - len(lead) - 2))
        elif t_axis_shardable:
            spec = (None, "data") + ((None,) * (ndim - len(lead) - 2))
        else:
            spec = (None,) * (ndim - len(lead))
        spec = list(spec)
        if ndim - len(lead) == 4 and _divisible(shape[len(lead) + 2], mesh, "model"):
            spec[2] = "model"
        return lead + tuple(spec)

    # SSM, conv and token-shift states: the batch over dp where a dim
    # divides, else the last dim that divides over model, else replicated
    spec = [None] * ndim
    for i in range(ndim):
        if shape[i] % dpn == 0 and shape[i] >= dpn:
            spec[i] = _dp_entry(dp)
            break
    else:
        for i in range(ndim - 1, -1, -1):
            if _divisible(shape[i], mesh, "model"):
                spec[i] = "model"
                break
    return tuple(spec)


def tree_cache_specs(tree: Tree, mesh) -> Tree:
    names, leaves = tu.flatten_with_keys(tree)
    return tu.unflatten_like(tree, [cache_spec(n, tuple(x.shape), mesh)
                                    for n, x in zip(names, leaves)])


# ---------------------------------------------------------------------------
# a leaf's block on this rank
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a parameter spec shards over "model", or None. A parameter
    spec names "model" at most once and no other axis (the rules above);
    anything else raises."""

    dim = None
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        if axes != ("model",) or dim is not None:
            raise NotImplementedError(f"spec {spec}: the port shards parameters over the "
                                      "model axis alone, on one dim")
        dim = i
    return dim


def shard(leaf: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: along each sharded dim
    the contiguous slice at this rank's coordinate on the entry's axes
    (row-major over them when an entry names several), as a
    ``NamedSharding`` places it. A fresh contiguous tensor, which holds
    no reference to ``leaf``'s storage."""

    coords = mesh.coords()
    out = leaf
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if leaf.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(leaf.shape)} does not split over {axes} ({n})")
        b = leaf.shape[i] // n
        out = out.narrow(i, idx * b, b)
    return out.clone(memory_format=torch.contiguous_format)


def unshard(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block: one all-gather over the model
    group along the spec's model dim (counted, ``launch.distributed.
    collective``); a replicated leaf comes back as it is. Every rank of the
    model group must call it."""

    from repro_torch.launch.distributed import collective

    dim = model_dim(spec)
    if dim is None:
        return block
    return collective("all-gather", block, mesh, over="model", dim=dim)
