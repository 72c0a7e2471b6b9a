"""Deterministic synthetic data pipelines, after
``src/repro/data/pipeline.py`` (the port keeps its own copy: that module
imports jax). The generators are numpy and give the same arrays as the
JAX package's for the same seeds:

* ``lm_batch``: Zipfian token sequences with short-range Markov structure;
* ``make_classification_dataset``: class-banded token sequences with
  controllable label noise (the WRENCH-analog benchmarks), and
  ``weak_labels``, majority votes of noisy labeling functions;
* ``BatchIterator``: (base_batches[K], meta_batch) pairs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# synthetic LM stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    zipf_a: float = 1.2
    markov_strength: float = 0.7  # prob. of following the deterministic chain
    seed: int = 0


def lm_batch(cfg: LMStreamConfig, rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
    """Markov-perturbed Zipf stream: next ~ (cur * 31 + 7) % V with prob p,
    else a Zipf sample."""

    V = cfg.vocab_size
    zipf = rng.zipf(cfg.zipf_a, size=(batch, cfg.seq_len)).astype(np.int64)
    zipf = np.minimum(zipf - 1, V - 1)
    toks = np.empty((batch, cfg.seq_len), np.int32)
    toks[:, 0] = zipf[:, 0]
    follow = rng.random((batch, cfg.seq_len)) < cfg.markov_strength
    for t in range(1, cfg.seq_len):
        chain = (toks[:, t - 1].astype(np.int64) * 31 + 7) % V
        toks[:, t] = np.where(follow[:, t], chain, zipf[:, t])
    return {"tokens": toks}


# ---------------------------------------------------------------------------
# synthetic classification ("WRENCH-analog")
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClassificationConfig:
    num_classes: int = 4
    vocab_size: int = 512
    seq_len: int = 32
    class_token_bias: float = 3.0  # how strongly class-indicative tokens dominate
    seed: int = 0


def make_classification_dataset(
    cfg: ClassificationConfig, n: int, *, noise: float = 0.0, seed: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Each class c over-samples a disjoint token band; labels optionally
    corrupted uniformly with prob ``noise``. Returns tokens, y (observed),
    y_true, corrupted (bool mask)."""

    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    C, V, S = cfg.num_classes, cfg.vocab_size, cfg.seq_len
    y_true = rng.integers(0, C, size=n)
    band = V // C
    logits = np.full((n, V), 1.0)
    for c in range(C):
        rows = y_true == c
        logits[rows, c * band : (c + 1) * band] += cfg.class_token_bias
    probs = logits / logits.sum(-1, keepdims=True)
    toks = np.stack([rng.choice(V, size=S, p=probs[i]) for i in range(n)]).astype(np.int32)

    corrupted = rng.random(n) < noise
    y_obs = np.where(corrupted, rng.integers(0, C, size=n), y_true).astype(np.int32)
    return {
        "tokens": toks,
        "y": y_obs,
        "y_true": y_true.astype(np.int32),
        "corrupted": corrupted,
    }


def weak_labels(y_true: np.ndarray, num_classes: int, *, num_lfs: int = 5,
                lf_accuracy: float = 0.7, seed: int = 0) -> np.ndarray:
    """Weak supervision via majority vote of ``num_lfs`` noisy labeling
    functions (the paper's WRENCH setup, App. B.1)."""

    rng = np.random.default_rng(seed)
    n = len(y_true)
    votes = np.where(
        rng.random((num_lfs, n)) < lf_accuracy,
        y_true[None, :],
        rng.integers(0, num_classes, size=(num_lfs, n)),
    )
    maj = np.empty(n, np.int32)
    for i in range(n):
        maj[i] = np.bincount(votes[:, i], minlength=num_classes).argmax()
    return maj


# ---------------------------------------------------------------------------
# batch iterators
# ---------------------------------------------------------------------------


class BatchIterator:
    """Yields (base_batches[K], meta_batch) pairs for the Engine, as dicts
    of tensors on ``device`` (``"cuda"`` unless the caller passes
    ``device="cpu"``). Base batches carry a leading unroll axis (K, B,
    ...). The index draws are the JAX package's, so both iterators give the
    same batches for the same seed. Subclasses override ``_base_idx`` to
    change the base sampling distribution."""

    def __init__(
        self,
        base_data: Dict[str, np.ndarray],
        meta_data: Dict[str, np.ndarray],
        *,
        batch_size: int,
        meta_batch_size: int,
        unroll: int,
        seed: int = 0,
        fields: Tuple[str, ...] = ("tokens", "y"),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.base = {k: v for k, v in base_data.items() if k in fields}
        self.meta = {k: v for k, v in meta_data.items() if k in fields}
        self.bs, self.mbs, self.k = batch_size, meta_batch_size, unroll
        self.rng = np.random.default_rng(seed)
        self.n = len(next(iter(self.base.values())))
        self.nm = len(next(iter(self.meta.values())))

    def _base_idx(self) -> np.ndarray:
        """(K, B) base example indices; the uniform default."""
        return self.rng.integers(0, self.n, size=(self.k, self.bs))

    def _put(self, x: np.ndarray) -> torch.Tensor:
        # non_blocking: the copy is queued on the stream, the host goes on
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device, non_blocking=True)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        idx = self._base_idx()
        midx = self.rng.integers(0, self.nm, size=self.mbs)
        base = {k: self._put(v[idx]) for k, v in self.base.items()}
        meta = {k: self._put(v[midx]) for k, v in self.meta.items()}
        return base, meta
