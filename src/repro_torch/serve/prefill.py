"""Teacher-forced block prefill in one decode step, and the serial greedy
reference loop, after ``src/repro/serve/prefill.py``.

Block prefill runs the whole (right-padded) prompt as one multi-token
``decode_step``. That is valid for attention caches: padded positions
write garbage K/V *beyond* every valid query position, causal masking
never attends it, and continuous decode overwrites position ``len``
onward token by token before it ever enters a mask. Recurrent families
cannot use it (their state updates are order-dependent); their scan-mode
prefill comes with them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import common as cm

RECURRENT_FAMILIES = ("ssm", "hybrid")


def chunked_prefill(model, params, prompt: torch.Tensor, cache,
                    *, lengths: Optional[torch.Tensor] = None):
    """Prefill ``prompt`` (B, P) into ``cache`` (in place) with one
    decode step.

    ``lengths`` (B,) marks each lane's valid prompt length (``None`` = all
    P). Returns ``(last_logits, cache)`` where ``last_logits[b]`` is the
    logits after lane b's token ``lengths[b] - 1``: the distribution the
    first generated token is taken from."""

    if model.cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"block prefill is order-unsafe for family={model.cfg.family!r}")
    B, P = prompt.shape
    if lengths is None:
        lengths = torch.full((B,), P, dtype=torch.long, device=prompt.device)
    lengths = torch.as_tensor(lengths, device=prompt.device).long()
    logits, cache = model.decode_step(params, cache, prompt, 0)
    last = logits[torch.arange(B, device=prompt.device), lengths - 1]
    return last, cache


@torch.no_grad()
def greedy_generate(model, params, prompt: torch.Tensor, gen: int,
                    cache_len: int, *, dtype=None) -> torch.Tensor:
    """Serial dense-cache greedy decode: the correctness reference every
    served output is pinned against. prompt: (B, P) int; returns (B, gen)
    int32 greedy tokens. The cache dtype follows the model config unless
    overridden."""

    prompt = torch.as_tensor(prompt).to(model.device)
    B, P = prompt.shape
    dtype = cm.dtype_of(model.cfg.dtype) if dtype is None else dtype
    cache = model.init_cache(B, cache_len, dtype=dtype)
    last, cache = chunked_prefill(model, params, prompt, cache)
    toks = [torch.argmax(last, dim=-1).to(torch.int32)]
    for t in range(P, P + gen - 1):
        logits, cache = model.decode_step(params, cache, toks[-1][:, None], t)
        toks.append(torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
    return torch.stack(toks, dim=1)
