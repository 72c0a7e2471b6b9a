"""Teacher-forced prefill, and the serial greedy reference loop, after
``src/repro/serve/prefill.py``. Prefill runs in one of two modes:

* ``block``: the whole prompt as one multi-token ``decode_step``. Valid
  for attention caches: padded positions write garbage K/V *beyond* every
  valid query position, causal masking never attends it, and continuous
  decode overwrites position ``len`` onward token by token before it ever
  enters a mask. Recurrent families cannot use it: their state updates
  are order-dependent and cannot be masked after the fact.
* ``scan``: one single-token ``decode_step`` per prompt position (a Python
  loop where JAX runs ``lax.scan``), with per-lane validity gating on
  every cache leaf (on its batch axis, from ``cache.build_spec``), so
  that a lane's recurrent state and cache stop evolving exactly at its
  length. This is the serial loop's sequence of steps, and the only
  correct mode for the ssm and hybrid families.

``mode="auto"`` picks block for attention families and scan for
recurrent ones. Either mode is the ``serve_prefill`` phase.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.models import common as cm
from repro_torch.models.transformer import RECURRENT_FAMILIES
from repro_torch.obs.trace import phase
from repro_torch.serve import cache as cache_mod


def default_mode(cfg) -> str:
    return "scan" if cfg.family in RECURRENT_FAMILIES else "block"


def _block(model, params, prompt, cache, lengths):
    logits, cache = model.decode_step(params, cache, prompt, 0)
    last = logits[torch.arange(prompt.shape[0], device=prompt.device), lengths - 1]
    return last, cache


def _axes(model) -> List[Tuple[int, Optional[int]]]:
    """(batch axis, time axis or None) of every cache leaf, from a shape
    probe (the axes do not depend on the dtype)."""
    spec = cache_mod.build_spec(model, page_size=1, dtype=torch.float32)
    return [(ls.batch_axis, ls.time_axis) for ls in spec.leaves]


def _scan(model, params, prompt, cache, lengths):
    """One decode step per position t. Where ``lengths`` leaves a lane
    invalid at t, every leaf keeps that lane's value from before the step:
    a state leaf whole, a time-axis leaf at column t, the only column the
    step writes (the step advances the cache in place, so the old values
    are saved first). ``lengths=None``: every lane valid, nothing saved."""

    B, P = prompt.shape
    leaves = cm.tree_flatten(cache)[0]
    axes = _axes(model) if lengths is not None else []
    last = None
    for t in range(P):
        valid = None if lengths is None else t < lengths
        saved = [leaf.clone() if tax is None else leaf.select(tax, t).clone()
                 for leaf, (_, tax) in zip(leaves, axes)]
        logits, cache = model.decode_step(params, cache, prompt[:, t:t + 1], t)
        step = logits[:, 0]
        if valid is not None:
            for leaf, (bax, tax), old in zip(leaves, axes, saved):
                now = leaf if tax is None else leaf.select(tax, t)
                keep = cache_mod.lane_mask(now.dim(), bax if tax is None or bax < tax
                                           else bax - 1, valid)
                now.copy_(torch.where(keep, now, old))
            if last is not None:
                step = torch.where(valid[:, None], step, last)
        last = step
    return last, cache


def chunked_prefill(model, params, prompt: torch.Tensor, cache,
                    *, lengths: Optional[torch.Tensor] = None, mode: str = "auto"):
    """Prefill ``prompt`` (B, P) into ``cache`` (in place).

    ``lengths`` (B,) marks each lane's valid prompt length (``None`` = all
    P). Returns ``(last_logits, cache)`` where ``last_logits[b]`` is the
    logits after lane b's token ``lengths[b] - 1``: the distribution the
    first generated token is taken from."""

    if mode == "auto":
        mode = default_mode(model.cfg)
    if mode == "block" and model.cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"block prefill is order-unsafe for family={model.cfg.family!r}; "
            "use mode='scan'")
    if mode not in ("block", "scan"):
        raise ValueError(f"unknown prefill mode {mode!r}")
    B, P = prompt.shape
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=prompt.device).long()
    with phase("serve_prefill"):
        if mode == "block":
            if lengths is None:
                lengths = torch.full((B,), P, dtype=torch.long, device=prompt.device)
            return _block(model, params, prompt, cache, lengths)
        return _scan(model, params, prompt, cache, lengths)


@torch.no_grad()
def greedy_generate(model, params, prompt: torch.Tensor, gen: int,
                    cache_len: int, *, dtype=None, prefill_mode: str = "auto") -> torch.Tensor:
    """Serial dense-cache greedy decode: the correctness reference every
    served output is pinned against. prompt: (B, P) int; returns (B, gen)
    int32 greedy tokens. The cache dtype follows the model config unless
    overridden."""

    prompt = torch.as_tensor(prompt).to(model.device)
    B, P = prompt.shape
    dtype = cm.dtype_of(model.cfg.dtype) if dtype is None else dtype
    cache = model.init_cache(B, cache_len, dtype=dtype)
    last, cache = chunked_prefill(model, params, prompt, cache, mode=prefill_mode)
    toks = [torch.argmax(last, dim=-1).to(torch.int32)]
    for t in range(P, P + gen - 1):
        logits, cache = model.decode_step(params, cache, toks[-1][:, None], t)
        toks.append(torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1)
