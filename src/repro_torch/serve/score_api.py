"""Dataopt score API, after ``src/repro/serve/score_api.py``: serves
per-example keep/weight scores from an exported score store through the
same queue/shed/latency machinery as token serving.

The store is a ``dataopt/export.py`` artifact (npz + validated manifest,
written by either package): per-example meta-learned scores, optionally a
keep mask. Requests are id-batches; the endpoint coalesces every queued
batch into ONE ragged lookup per drain (ids concatenated, split back by a
``qo_indptr`` row-pointer), so per-request overhead is amortized as decode
lanes amortize a decode step.

``weight`` answers are softmax weights over the FULL dataset's scores at a
requested temperature (the ``dataopt.reweight`` sampling distribution), so
callers can turn scores into sampling probabilities without holding the
store.

It stays numpy on the host, as in the JAX package. With ``obs=`` each
request's trace is ``enqueued`` (the queue) and one terminal event:
``done`` when answered, ``deadline_miss`` or ``shed`` when shed, the
decode executor's vocabulary, so the SLO monitor and the timeline checks
read both planes alike.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dataopt import export as export_mod
from repro_torch.obs import NULL_OBS
from repro_torch.perf.timers import LatencyStats
from repro_torch.serve.queue import SHED_DEADLINE, QueueFull, QueueStats, RequestQueue

KINDS = ("score", "keep", "weight")


class ScoreStore:
    """In-memory view over one exported score set."""

    def __init__(self, scores: np.ndarray, mask: Optional[np.ndarray] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.scores = np.asarray(scores, np.float32)
        if self.scores.ndim != 1:
            raise ValueError(f"scores must be 1-D, got shape {self.scores.shape}")
        self.mask = None if mask is None else np.asarray(mask, bool)
        if self.mask is not None and self.mask.shape != self.scores.shape:
            raise ValueError("mask/scores shape mismatch")
        self.meta = dict(meta or {})
        self._logz: Dict[float, float] = {}  # per-temperature log-normalizer

    @classmethod
    def load(cls, path: str, *, expect_n: Optional[int] = None,
             expect_scorer: Optional[str] = None) -> "ScoreStore":
        scores, mask, meta = export_mod.import_scores(
            path, expect_n=expect_n, expect_scorer=expect_scorer)
        return cls(scores, mask, meta)

    def __len__(self) -> int:
        return int(self.scores.size)

    def _check(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= len(self)):
            raise IndexError(
                f"example ids must be in [0, {len(self)}), got range "
                f"[{ids.min()}, {ids.max()}]")
        return ids

    def lookup(self, ids) -> np.ndarray:
        return self.scores[self._check(ids)]

    def keep(self, ids) -> np.ndarray:
        ids = self._check(ids)
        if self.mask is None:
            return np.ones(ids.shape, bool)
        return self.mask[ids]

    def weight(self, ids, temperature: float = 1.0) -> np.ndarray:
        """Softmax sampling weights over the full dataset at ``temperature``
        (the dataopt.reweight distribution), gathered at ``ids``."""

        if temperature <= 0:
            raise ValueError("temperature must be > 0")
        ids = self._check(ids)
        t = float(temperature)
        if t not in self._logz:
            s = self.scores.astype(np.float64) / t
            m = s.max()
            self._logz[t] = float(m + np.log(np.exp(s - m).sum()))
        return np.exp(self.scores[ids].astype(np.float64) / t
                      - self._logz[t]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ScoreAPIStats:
    answered: int
    batches: int
    latency: Optional[LatencyStats]
    queue: QueueStats


class ScoreAPI:
    """Queued, coalescing endpoint over a :class:`ScoreStore`. ``submit``
    returns a Future; ``run_pending`` drains the queue in ragged
    coalesced batches."""

    def __init__(self, store: ScoreStore, *, max_batch: int = 64,
                 queue_depth: int = 256,
                 default_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, obs=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.store = store
        self.max_batch = max_batch
        self._obs = obs if obs is not None else NULL_OBS
        self.queue = RequestQueue(queue_depth, default_timeout_s=default_timeout_s,
                                  clock=clock, obs=self._obs)
        self._clock = clock
        self._latency_s: List[float] = []
        self.answered = 0
        self.batches = 0

    def submit(self, ids, *, kind: str = "score", temperature: float = 1.0,
               timeout_s: Optional[float] = None) -> "Future[np.ndarray]":
        """Enqueue an id-batch; the Future resolves on the next drain.
        Shed requests (overflow here, deadline at drain) resolve with the
        shed reason as the exception."""

        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        ids = self.store._check(ids)  # validate before queuing, not at drain
        fut: "Future[np.ndarray]" = Future()
        payload = {"ids": ids, "kind": kind, "temperature": temperature, "future": fut}
        try:
            self.queue.submit(payload, timeout_s=timeout_s)
        except QueueFull as e:
            fut.set_exception(e)
        return fut

    def _answer(self, batch) -> None:
        """One coalesced lookup for every request in ``batch`` that shares
        a kind/temperature signature."""

        groups: Dict[Tuple[str, float], List[Any]] = {}
        for req in batch:
            key = (req.payload["kind"], float(req.payload["temperature"]))
            groups.setdefault(key, []).append(req)
        for (kind, temp), reqs in groups.items():
            indptr = np.cumsum([0] + [r.payload["ids"].size for r in reqs])
            flat = np.concatenate([r.payload["ids"] for r in reqs]) \
                if indptr[-1] else np.zeros((0,), np.int64)
            if kind == "score":
                vals = self.store.lookup(flat)
            elif kind == "keep":
                vals = self.store.keep(flat)
            else:
                vals = self.store.weight(flat, temperature=temp)
            now = self._clock()
            for k, req in enumerate(reqs):
                req.payload["future"].set_result(vals[indptr[k]:indptr[k + 1]])
                self._latency_s.append(now - req.submit_t)
                self.answered += 1
                # a score trace is enqueued -> done (no decode stages)
                self._obs.emit("serve", "done", data={
                    "trace_id": req.trace_id, "request_id": req.id,
                    "status": "ok", "kind": kind,
                    "resident_us": (now - req.submit_t) * 1e6,
                    "latency_us": (now - req.submit_t) * 1e6})
        self.batches += 1

    def run_pending(self) -> int:
        """Drain the queue (coalesced ``max_batch`` at a time). Returns the
        number of requests answered; shed futures resolve exceptionally."""

        answered_before = self.answered
        while True:
            batch = self.queue.pop(self.max_batch)
            for ev in self.queue.drain_shed():
                fut = ev.request.payload["future"]
                if not fut.done():  # overflow futures resolved at submit
                    fut.set_exception(TimeoutError(f"request shed: {ev.reason}"))
                self._obs.emit("serve", "deadline_miss" if ev.reason == SHED_DEADLINE
                               else "shed",
                               data={"trace_id": ev.request.trace_id,
                                     "request_id": ev.request.id, "status": ev.reason,
                                     "resident_us": (ev.t - ev.request.submit_t) * 1e6})
            if not batch:
                break
            self._answer(batch)
        return self.answered - answered_before

    def stats(self) -> ScoreAPIStats:
        return ScoreAPIStats(
            answered=self.answered,
            batches=self.batches,
            latency=LatencyStats.from_samples(self._latency_s),  # n=0 when none
            queue=self.queue.stats(),
        )
