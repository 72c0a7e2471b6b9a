"""Paged decode cache: fixed-size pages, a free-list allocator, and ragged
``qo_indptr`` accounting, after ``src/repro/serve/cache.py``.

The *time* axis of every cache leaf is chopped into fixed-size pages living
in one shared pool per leaf; a per-slot page table maps logical token
positions to physical pages, so allocated bytes track live tokens (plus one
partially-filled page per sequence) and the pool grows by doubling only
when the free list runs dry.

``build_spec`` finds the time axis by probing ``init_cache`` on the
``meta`` device (shapes, no memory) with two batch sizes and two cache
lengths: the axis that moves with ``cache_len`` is the time axis (paged).
Leaves with no such axis are per-slot state stored dense at ``slots``
lanes: the RWKV and Mamba recurrent state, and the cross-attention K/V of
the audio and vision families, whose encoder or image axis is
config-sized and is never paged. rwkv6's cache is all state; zamba2's,
whisper's and llama-3.2-vision's have both.

Physical page 0 is reserved as a trash page: inactive lanes' page-table
rows are all-zero, so their decode writes land in the trash and their
gathers read finite garbage that the batcher discards. The decode step
advances the state store in place, inactive lanes too: ``write_prefill``
writes a slot's whole state row when the slot is taken.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import common as cm

Tree = Any


class PagedCacheError(RuntimeError):
    """Allocation failure: pool capacity exhausted at ``max_pages``."""


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Axis roles for one cache leaf. ``time_axis is None``: a state leaf."""

    batch_axis: int
    time_axis: Optional[int]
    rest_shape: Tuple[int, ...]  # non-batch non-time dims, original order
    dtype: torch.dtype

    @property
    def paged(self) -> bool:
        return self.time_axis is not None


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static layout of a model's decode cache under paging."""

    treedef: Tuple[Tuple[str, ...], ...]
    leaves: Tuple[LeafSpec, ...]
    paged_idx: Tuple[int, ...]  # leaf indices with a time axis
    state_idx: Tuple[int, ...]
    page_size: int

    def token_view_bytes(self) -> int:
        """Bytes per (lane, token) of a gathered dense view: the unit the
        bucket planner multiplies by ``slots x bucket_len`` (0 for a cache
        of state alone)."""

        return sum(int(np.prod(self.leaves[i].rest_shape, dtype=np.int64))
                   * self.leaves[i].dtype.itemsize for i in self.paged_idx)

    def state_bytes(self, slots: int) -> int:
        return sum(slots * int(np.prod(self.leaves[i].rest_shape, dtype=np.int64))
                   * self.leaves[i].dtype.itemsize for i in self.state_idx)


def _axis_diff(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def _probe(model, batch: int, cache_len: int, dtype) -> List[torch.Tensor]:
    return cm.tree_flatten(model.init_cache(batch, cache_len, dtype=dtype,
                                            device="meta"))[0]


def build_spec(model, *, page_size: int, dtype, allow_unpaged: bool = True) -> CacheSpec:
    """Classify every cache leaf's axes by probing ``model.init_cache`` on
    the ``meta`` device. No device memory is touched.

    A pure-recurrent cache (every leaf constant-size state) has nothing to
    page: paging degenerates to the dense per-slot state store, which
    already scales with slots rather than length. ``allow_unpaged=False``
    rejects that instead."""

    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    b1, b2, l1, l2 = 2, 3, 2 * page_size, 3 * page_size
    ref_leaves, treedef = cm.tree_flatten(
        model.init_cache(b1, l1, dtype=dtype, device="meta"))
    b_leaves = _probe(model, b2, l1, dtype)
    l_leaves = _probe(model, b1, l2, dtype)

    specs: List[LeafSpec] = []
    for ref, lb, ll in zip(ref_leaves, b_leaves, l_leaves):
        bdiff = _axis_diff(ref.shape, lb.shape)
        if len(bdiff) != 1:
            raise ValueError(
                f"cache leaf {tuple(ref.shape)} has {len(bdiff)} batch-dependent "
                "axes; paged serving needs exactly one")
        tdiff = _axis_diff(ref.shape, ll.shape)
        if len(tdiff) > 1:
            raise ValueError(
                f"cache leaf {tuple(ref.shape)} has {len(tdiff)} cache_len-dependent axes")
        b_ax = bdiff[0]
        t_ax = tdiff[0] if tdiff else None
        rest = tuple(d for i, d in enumerate(ref.shape) if i not in (b_ax, t_ax))
        specs.append(LeafSpec(b_ax, t_ax, rest, ref.dtype))
    paged = tuple(i for i, ls in enumerate(specs) if ls.paged)
    state = tuple(i for i, ls in enumerate(specs) if not ls.paged)
    if not paged and not allow_unpaged:
        raise ValueError("no cache leaf depends on cache_len: nothing to page")
    return CacheSpec(treedef, tuple(specs), paged, state, page_size)


def dense_cache_bytes(model, batch: int, cache_len: int, dtype) -> int:
    """Bytes a dense ``init_cache(batch, cache_len)`` would allocate (meta
    probe, nothing is materialized)."""

    return sum(x.numel() * x.element_size() for x in _probe(model, batch, cache_len, dtype))


# ---------------------------------------------------------------------------
# view / update functions (the batcher runs them around decode_step)
# ---------------------------------------------------------------------------


def _dense_perm(ls: LeafSpec) -> Tuple[int, ...]:
    """permute order taking ``(B, T, *rest)`` to the leaf's native layout."""

    ndim = 2 + len(ls.rest_shape)
    others = [i for i in range(ndim) if i not in (ls.batch_axis, ls.time_axis)]
    perm = [0] * ndim
    perm[ls.batch_axis] = 0
    perm[ls.time_axis] = 1
    for k, i in enumerate(others):
        perm[i] = 2 + k
    return tuple(perm)


def _bt_first(leaf: torch.Tensor, ls: LeafSpec) -> torch.Tensor:
    """The leaf as ``(B, T, *rest)`` (inverse of ``_dense_perm``)."""

    return torch.movedim(leaf, (ls.batch_axis, ls.time_axis), (0, 1))


def lane_mask(ndim: int, batch_axis: int, lanes: torch.Tensor) -> torch.Tensor:
    """A (B,) bool as a mask that broadcasts over an ``ndim`` leaf's batch
    axis."""
    shape = [1] * ndim
    shape[batch_axis] = lanes.shape[0]
    return lanes.reshape(shape)


def gather_dense(spec: CacheSpec, pools: List[torch.Tensor],
                 states: List[torch.Tensor], table_view: torch.Tensor) -> Tree:
    """Materialize a dense, contiguous cache view of ``table_view.shape[1] *
    page_size`` tokens per lane from the pools, beside the state store
    itself, which the decode step advances in place. Inactive lanes
    (all-zero table rows) read the trash page: finite garbage, discarded by
    the caller. An inactive lane's state row is a free slot's: the step
    advances it and nothing reads it, since ``write_prefill`` writes the
    whole row when the slot is taken again (where the JAX package commits
    the state of the active lanes only)."""

    nv = table_view.shape[1]
    dense: List[Optional[torch.Tensor]] = [None] * len(spec.leaves)
    for pool, i in zip(pools, spec.paged_idx):
        v = pool[table_view]  # (slots, nv, page, *rest)
        v = v.reshape(v.shape[0], nv * spec.page_size, *v.shape[3:])
        dense[i] = v.permute(_dense_perm(spec.leaves[i])).contiguous()
    for state, i in zip(states, spec.state_idx):
        dense[i] = state
    return cm.tree_unflatten(spec.treedef, dense)


def scatter_token(spec: CacheSpec, pools: List[torch.Tensor], new_cache: Tree,
                  table_view: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor) -> None:
    """Write back one decoded token per lane: column ``pos[lane]`` of every
    paged leaf of ``new_cache`` goes into physical page ``table[lane, pos //
    page]``; inactive lanes write the trash page. The state leaves need no
    write: the decode step advanced the store in place (``gather_dense``).

    The pools are updated in place. This stands in for the JAX package's
    donated pool buffers, which let XLA update the pages in place inside
    its jitted step."""

    leaves = cm.tree_flatten(new_cache)[0]
    B = table_view.shape[0]
    pg = spec.page_size
    lanes = torch.arange(B, device=table_view.device)
    pos = pos.long()
    page_col = table_view[lanes, pos // pg]
    page_col = torch.where(active, page_col, torch.zeros_like(page_col))
    off = pos % pg
    for pool, i in zip(pools, spec.paged_idx):
        col = _bt_first(leaves[i], spec.leaves[i])[lanes, pos]  # (B, *rest)
        pool[page_col, off] = col.to(pool.dtype)


# ---------------------------------------------------------------------------
# the host-side allocator
# ---------------------------------------------------------------------------


class PagedCache:
    """Free-list page allocator + per-slot bookkeeping over device pools.

    ``slots`` is the fixed lane count of the continuous batch; ``max_len``
    caps any single sequence (prompt + generated) and sizes the page table
    width. The pool starts at ``initial_pages`` physical pages (plus the
    trash page) and doubles on demand up to ``max_pages``.
    """

    def __init__(self, model, *, slots: int, page_size: int, max_len: int,
                 dtype=None, initial_pages: Optional[int] = None,
                 max_pages: Optional[int] = None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if max_len < 1 or max_len % page_size != 0:
            raise ValueError("max_len must be a positive multiple of page_size")
        self.model = model
        self.device = model.device
        self.dtype = cm.dtype_of(model.cfg.dtype) if dtype is None else dtype
        self.spec = build_spec(model, page_size=page_size, dtype=self.dtype)
        self.slots = slots
        self.page_size = page_size
        self.max_len = max_len
        self.pages_per_seq = max_len // page_size
        # +1 everywhere: physical page 0 is the trash page, never allocated
        self.max_pages = (1 + slots * self.pages_per_seq if max_pages is None
                          else max_pages)
        cap = min(self.max_pages, 1 + (initial_pages if initial_pages is not None
                                       else slots))
        self.pools: List[torch.Tensor] = [
            torch.zeros((cap, page_size, *self.spec.leaves[i].rest_shape),
                        dtype=self.spec.leaves[i].dtype, device=self.device)
            for i in self.spec.paged_idx
        ]
        self.states: List[torch.Tensor] = []
        for i in self.spec.state_idx:
            ls = self.spec.leaves[i]
            shape = list(ls.rest_shape)
            shape.insert(ls.batch_axis, slots)
            self.states.append(torch.zeros(shape, dtype=ls.dtype, device=self.device))
        self._capacity = cap
        self._free_pages: List[int] = list(range(cap - 1, 0, -1))  # pop() -> low ids first
        self._free_slots: List[int] = list(range(slots - 1, -1, -1))
        # int32 as in the reference, whose allocated_bytes counts it; the
        # views index the pools with it widened to int64
        self.table = np.zeros((slots, self.pages_per_seq), np.int32)
        self.seq_lens = np.zeros((slots,), np.int64)
        self.active = np.zeros((slots,), bool)
        self._pages_held = np.zeros((slots,), np.int64)
        self.grow_events = 0
        self.peak_bytes = self.allocated_bytes()

    # -- accounting ----------------------------------------------------------

    def allocated_bytes(self) -> int:
        """Live allocation: pools at current capacity + state store + table."""

        total = sum(x.numel() * x.element_size() for x in self.pools + self.states)
        return int(total + self.table.size * self.table.itemsize)

    def live_tokens(self) -> int:
        return int(self.seq_lens[self.active].sum())

    def qo_indptr(self) -> np.ndarray:
        """Ragged row-pointer over active slots' lengths: ``indptr[k+1] -
        indptr[k]`` is slot k's live length (0 for inactive lanes)."""

        lens = np.where(self.active, self.seq_lens, 0)
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)

    def free_slot_count(self) -> int:
        return len(self._free_slots)

    # -- allocation ----------------------------------------------------------

    def _grow(self, min_extra: int) -> None:
        new_cap = min(self.max_pages, max(2 * self._capacity,
                                          self._capacity + min_extra))
        if new_cap <= self._capacity:
            raise PagedCacheError(
                f"page pool exhausted: capacity {self._capacity} at "
                f"max_pages={self.max_pages}")
        extra = new_cap - self._capacity
        self.pools = [
            torch.cat([p, p.new_zeros((extra, *p.shape[1:]))], dim=0)
            for p in self.pools
        ]
        self._free_pages = list(range(new_cap - 1, self._capacity - 1, -1)) \
            + self._free_pages
        self._capacity = new_cap
        self.grow_events += 1
        self.peak_bytes = max(self.peak_bytes, self.allocated_bytes())

    def alloc_slot(self) -> int:
        if not self._free_slots:
            raise PagedCacheError("no free decode slot")
        slot = self._free_slots.pop()
        self.table[slot] = 0
        self.seq_lens[slot] = 0
        self._pages_held[slot] = 0
        self.active[slot] = True
        return slot

    def reserve(self, slot: int, length: int) -> None:
        """Ensure slot owns pages covering ``length`` tokens."""

        if length > self.max_len:
            raise PagedCacheError(f"sequence length {length} > max_len={self.max_len}")
        need = math.ceil(length / self.page_size)
        held = int(self._pages_held[slot])
        if need <= held:
            return
        if need - held > len(self._free_pages):
            self._grow(need - held - len(self._free_pages))
        for k in range(held, need):
            self.table[slot, k] = self._free_pages.pop()
        self._pages_held[slot] = need

    def set_len(self, slot: int, length: int) -> None:
        self.reserve(slot, length)
        self.seq_lens[slot] = length

    def free(self, slot: int) -> None:
        held = int(self._pages_held[slot])
        self._free_pages.extend(int(p) for p in self.table[slot, :held])
        self.table[slot] = 0
        self.seq_lens[slot] = 0
        self._pages_held[slot] = 0
        self.active[slot] = False
        self._free_slots.append(slot)

    # -- views / writes ------------------------------------------------------

    def table_view(self, view_len: int) -> torch.Tensor:
        """Page-table slice covering ``view_len`` tokens (a bucket length),
        on the device."""

        if view_len % self.page_size != 0:
            raise ValueError(f"view_len {view_len} not a multiple of page_size")
        nv = view_len // self.page_size
        if nv > self.pages_per_seq:
            raise ValueError(f"view_len {view_len} > max_len={self.max_len}")
        return torch.as_tensor(self.table[:, :nv]).to(self.device, torch.int64)

    def write_prefill(self, slot: int, dense_cache: Tree, n_tokens: int) -> None:
        """Commit a B=1 prefill cache (``n_tokens`` valid, padded to a page
        multiple) into slot's pages and state row, and set its length."""

        n_pages = math.ceil(n_tokens / self.page_size)
        self.reserve(slot, n_tokens)
        leaves = cm.tree_flatten(dense_cache)[0]
        pages = torch.as_tensor(self.table[slot, :n_pages]).to(self.device, torch.int64)
        for pool, i in zip(self.pools, self.spec.paged_idx):
            v = _bt_first(leaves[i], self.spec.leaves[i])[0, : n_pages * self.page_size]
            v = v.reshape(n_pages, self.page_size, *v.shape[1:])
            pool[pages] = v.to(pool.dtype)
        for state, i in zip(self.states, self.spec.state_idx):
            ax = self.spec.leaves[i].batch_axis
            state.select(ax, slot).copy_(leaves[i].select(ax, 0))
        self.seq_lens[slot] = n_tokens
