"""Continuous batching over fixed decode lanes, after
``src/repro/serve/batcher.py``.

The decode batch is ``slots`` fixed lanes. A lane is bound to one request
from admission to retirement; finished lanes free immediately and the
next queued request prefills into the freed slot, joining the in-flight
batch between steps.

One decode step is :func:`fused_step`: gather (paged pool -> dense bucket
view, beside the per-slot recurrent state, which the step advances in
place) -> ``decode_step`` -> scatter (one column per lane back to its page,
in place) -> argmax and finiteness. Its launches are queued on the
current CUDA stream and it returns device tensors without waiting, so the
host work of the next tick overlaps the device. The bucket view length is
the smallest member of a power-of-two page-multiple bucket set covering
the longest live lane: short traffic never pays long-context attention.

Per-lane positions are ragged (``pos[lane] = seq_len``). Inactive lanes
run the step on trash inputs (position 0, trash page) and their outputs
are discarded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm
from repro_torch.obs.trace import phase
from repro_torch.serve import prefill as prefill_mod
from repro_torch.serve.cache import CacheSpec, PagedCache, gather_dense, scatter_token
from repro_torch.serve.queue import Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for the serving stack. ``max_len`` bounds prompt + generated
    tokens per request and must be a multiple of ``page_size``;
    ``dtype=None`` serves in the model config's dtype."""

    slots: int = 4
    page_size: int = 8
    max_len: int = 128
    max_new_tokens: int = 16
    queue_depth: int = 64
    default_timeout_s: Optional[float] = None
    hbm_budget_bytes: Optional[int] = None
    initial_pages: Optional[int] = None
    max_pages: Optional[int] = None
    dtype: Optional[str] = None
    prefill_mode: str = "auto"  # "auto" | "block" | "scan"
    # flight recorder and hang watchdog (repro_torch.obs.flight):
    # flight_capacity=0 disables the always-on postmortem ring;
    # hang_deadline_s=None disables the watchdog thread
    flight_capacity: int = 2048
    flight_dir: Optional[str] = None
    flight_snapshot_every: int = 16   # ticks between flight metric snapshots
    hang_deadline_s: Optional[float] = None


def decode_buckets(spec: CacheSpec, cfg: ServeConfig) -> Tuple[int, ...]:
    """Power-of-two page-multiple view lengths up to ``max_len``, filtered
    by the gathered-view memory cost (``slots x bucket x bytes/token``).
    The ``max_len`` bucket must survive the filter: a request the config
    admits must also be decodable. A cache of state alone costs nothing
    per token, so its every bucket survives."""

    buckets: List[int] = []
    b = cfg.page_size
    while b < cfg.max_len:
        buckets.append(b)
        b *= 2
    buckets.append(cfg.max_len)
    if cfg.hbm_budget_bytes is not None:
        per_token = spec.token_view_bytes() * cfg.slots
        kept = [b for b in buckets if b * per_token <= cfg.hbm_budget_bytes]
        if cfg.max_len not in kept:
            raise ValueError(
                f"hbm_budget_bytes={cfg.hbm_budget_bytes} cannot fit the "
                f"max_len={cfg.max_len} decode view "
                f"({cfg.max_len * per_token} bytes); lower max_len or slots")
        buckets = kept
    return tuple(buckets)


@torch.no_grad()
def fused_step(model, spec: CacheSpec, params, pools: List[torch.Tensor],
               states: List[torch.Tensor], table_view: torch.Tensor, pos: torch.Tensor,
               tokens: torch.Tensor, active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gather -> decode_step -> scatter -> argmax/finiteness for all lanes,
    the ``serve_step`` phase. Updates ``pools`` and ``states`` in place;
    returns (next token (slots,) int32, finite (slots,) bool) on the
    device."""

    with phase("serve_step"):
        dense = gather_dense(spec, pools, states, table_view)
        logits, new_cache = model.decode_step(params, dense, tokens[:, None], pos)
        scatter_token(spec, pools, new_cache, table_view, pos, active)
        lg = logits[:, 0].float()
        return torch.argmax(lg, dim=-1).to(torch.int32), torch.isfinite(lg).all(dim=-1)


@dataclasses.dataclass
class Lane:
    """One live request bound to a decode slot."""

    request: Request
    slot: int
    prompt_len: int
    target_new: int
    tokens: List[int]
    admitted_t: float
    # set by the executor once prefill has produced the first token: the
    # TTFT anchor (and the point TPOT measures from)
    first_token_t: Optional[float] = None


@dataclasses.dataclass
class PendingStep:
    """In-flight device step: the tensors are ready only after ``harvest``
    copies them to the host."""

    next_tok: torch.Tensor
    finite: torch.Tensor
    lanes: List[Optional[Lane]]


class ContinuousBatcher:
    """Admission + fused-step mechanics. The executor owns the loop,
    deadlines and terminal statuses; this class owns lanes and pages."""

    def __init__(self, model, params, cfg: ServeConfig):
        if model.cfg.family == "encoder":
            raise ValueError(
                f"{model.cfg.name!r} is encoder-only: no decode step to serve")
        if cfg.max_len % cfg.page_size != 0:
            raise ValueError("max_len must be a multiple of page_size")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.dtype = cm.dtype_of(cfg.dtype if cfg.dtype is not None
                                 else model.cfg.dtype)
        self.cache = PagedCache(
            model, slots=cfg.slots, page_size=cfg.page_size,
            max_len=cfg.max_len, dtype=self.dtype,
            initial_pages=cfg.initial_pages, max_pages=cfg.max_pages,
        )
        self.buckets = decode_buckets(self.cache.spec, cfg)
        self.lanes: List[Optional[Lane]] = [None] * cfg.slots
        self.steps_dispatched = 0
        # per-slot goodput accounting: every dispatched step runs ALL
        # slots; an inactive slot burns the step on trash inputs
        self.useful_ticks = [0] * cfg.slots
        self.trash_ticks = [0] * cfg.slots
        self.tokens_emitted = [0] * cfg.slots

    # -- admission -----------------------------------------------------------

    def can_admit(self) -> bool:
        return self.cache.free_slot_count() > 0

    def admit(self, request: Request, now: float) -> Lane:
        """Prefill the request's prompt into a free slot: prefill of its P
        tokens (``ServeConfig.prefill_mode``: one block step, or the token
        scan of the recurrent families) into a cache of P rounded up to a
        page multiple rows produces the first greedy token and the slot's
        pages and state. The JAX package pads the prompt to that length
        instead (a static shape for its compiled step) and gates the scan
        at P; here the prompt goes in unpadded, so that a MoE layer routes
        the serial path's tokens: padded rows would take expert capacity
        from the prompt's own. The scan reaches the same state either
        way."""

        prompt = np.asarray(request.payload["prompt"], np.int64).reshape(-1)
        target_new = int(request.payload.get("max_new_tokens",
                                             self.cfg.max_new_tokens))
        P = int(prompt.size)
        if P < 1:
            raise ValueError("empty prompt")
        if P + target_new > self.cfg.max_len:
            raise ValueError(
                f"prompt_len={P} + max_new_tokens={target_new} exceeds "
                f"max_len={self.cfg.max_len}")
        pg = self.cfg.page_size
        P_pad = pg * math.ceil(P / pg)
        slot = self.cache.alloc_slot()
        try:
            self.cache.reserve(slot, P)
            cache0 = self.model.init_cache(1, P_pad, dtype=self.dtype)
            last, filled = prefill_mod.chunked_prefill(
                self.model, self.params, torch.as_tensor(prompt[None]).to(self.device),
                cache0, mode=self.cfg.prefill_mode)
            self.cache.write_prefill(slot, filled, P)
        except Exception:
            self.cache.free(slot)
            raise
        tok0 = int(torch.argmax(last[0], dim=-1))
        lane = Lane(request=request, slot=slot, prompt_len=P,
                    target_new=target_new, tokens=[tok0], admitted_t=now)
        self.lanes[slot] = lane
        return lane

    # -- decode --------------------------------------------------------------

    def live_lanes(self) -> List[Lane]:
        return [ln for ln in self.lanes if ln is not None]

    def lane_done(self, lane: Lane) -> bool:
        return len(lane.tokens) >= lane.target_new

    def bucket_for(self, need: int) -> int:
        for b in self.buckets:
            if b >= need:
                return b
        raise ValueError(f"no bucket covers length {need}")  # unreachable: max_len gates admission

    def dispatch(self) -> Optional[PendingStep]:
        """Queue one fused decode step for all live lanes on the device
        without waiting for it. Returns None when no lane is live."""

        live = self.live_lanes()
        if not live:
            return None
        need = 0
        for ln in live:
            self.cache.reserve(ln.slot, int(self.cache.seq_lens[ln.slot]) + 1)
            need = max(need, int(self.cache.seq_lens[ln.slot]) + 1)
        bucket = self.bucket_for(need)

        S = self.cfg.slots
        # per-lane positions from the cache's ragged qo_indptr: consecutive
        # row-pointer differences are each active slot's live length, the
        # view the split-KV decode kernel keys its per-lane masking on.
        # Inactive lanes diff to 0.
        pos = np.diff(self.cache.qo_indptr()).astype(np.int32)
        toks = np.zeros((S,), np.int64)
        active = np.zeros((S,), bool)
        for ln in live:
            toks[ln.slot] = ln.tokens[-1]
            active[ln.slot] = True
        for s in range(S):
            if active[s]:
                self.useful_ticks[s] += 1
            else:
                self.trash_ticks[s] += 1

        dev = self.device
        next_tok, finite = fused_step(
            self.model, self.cache.spec, self.params, self.cache.pools, self.cache.states,
            self.cache.table_view(bucket), torch.as_tensor(pos).to(dev),
            torch.as_tensor(toks).to(dev), torch.as_tensor(active).to(dev))
        self.steps_dispatched += 1
        return PendingStep(next_tok=next_tok, finite=finite, lanes=list(self.lanes))

    def harvest(self, pending: PendingStep) -> List[Tuple[Lane, int, bool]]:
        """Wait for a dispatched step; append each live lane's token and
        advance its length. Returns ``(lane, token, finite)`` per lane:
        the executor decides retirement."""

        next_tok = pending.next_tok.cpu().numpy()
        finite = pending.finite.cpu().numpy()
        out: List[Tuple[Lane, int, bool]] = []
        for slot, lane in enumerate(pending.lanes):
            if lane is None or self.lanes[slot] is not lane:
                continue  # retired while in flight (executor shed it)
            tok = int(next_tok[slot])
            ok = bool(finite[slot])
            if ok:
                lane.tokens.append(tok)
                self.cache.set_len(slot, int(self.cache.seq_lens[slot]) + 1)
                self.tokens_emitted[slot] += 1
            out.append((lane, tok, ok))
        return out

    def retire(self, lane: Lane) -> None:
        self.cache.free(lane.slot)
        self.lanes[lane.slot] = None

    # -- telemetry -----------------------------------------------------------

    def lane_stats(self) -> List[Dict[str, Any]]:
        """Per-slot occupancy/goodput over the run so far."""

        out: List[Dict[str, Any]] = []
        for s in range(self.cfg.slots):
            useful = self.useful_ticks[s]
            trash = self.trash_ticks[s]
            total = useful + trash
            out.append({
                "slot": s, "useful_ticks": useful, "trash_ticks": trash,
                "tokens": self.tokens_emitted[s],
                "goodput": (useful / total) if total else None,
            })
        return out

    def memory_stats(self) -> Dict[str, Any]:
        return {
            "allocated_bytes": self.cache.allocated_bytes(),
            "peak_bytes": self.cache.peak_bytes,
            "live_tokens": self.cache.live_tokens(),
            "grow_events": self.cache.grow_events,
            "buckets": list(self.buckets),
        }
