"""Prune schedules and the retrain harness, after
``src/repro/dataopt/prune.py``.

Masks, not index lists, are the interchange format: a boolean ``keep``
mask of shape (N,) aligned with the scored dataset. Schedules: one-shot
(keep the top (1 - ratio) by score), class-balanced (the same ratio within
each label class, so pruning cannot empty a class) and iterative
(``DataOptimizer.prune(rounds=...)``: each round rescores the survivors).
The masks are numpy and equal the JAX package's for the same scores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.dataopt.distributed import map_batches
from repro_torch.dataopt.scores import fit_plain

Tree = Any


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def keep_count(n: int, ratio: float) -> int:
    """How many of ``n`` examples survive pruning ``ratio`` (at least 1)."""

    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"prune ratio must be in [0, 1), got {ratio}")
    return max(int(round(n * (1.0 - ratio))), 1)


def keep_mask(scores: np.ndarray, ratio: float) -> np.ndarray:
    """Boolean mask of the top (1 - ratio) by score (higher = keep; ties
    broken by index)."""

    scores = np.asarray(scores)
    k = keep_count(len(scores), ratio)
    order = np.argsort(-scores, kind="stable")
    mask = np.zeros(len(scores), dtype=bool)
    mask[order[:k]] = True
    return mask


def class_balanced_mask(scores: np.ndarray, labels: np.ndarray, ratio: float) -> np.ndarray:
    """``keep_mask`` within each label class."""

    scores = np.asarray(scores)
    labels = np.asarray(labels)
    if len(scores) != len(labels):
        raise ValueError(f"scores ({len(scores)}) and labels ({len(labels)}) disagree")
    mask = np.zeros(len(scores), dtype=bool)
    for c in np.unique(labels):
        rows = np.flatnonzero(labels == c)
        mask[rows] = keep_mask(scores[rows], ratio)
    return mask


def apply_mask(dataset: Dict[str, np.ndarray], mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Every aligned field of the dataset subset by a boolean keep mask."""

    mask = np.asarray(mask, dtype=bool)
    n = len(next(iter(dataset.values())))
    if mask.shape != (n,):
        raise ValueError(f"mask shape {mask.shape} != dataset length ({n},)")
    return {k: v[mask] for k, v in dataset.items()}


# ---------------------------------------------------------------------------
# retrain harness and evaluation
# ---------------------------------------------------------------------------


def retrain(per_example_fn, init_fn, dataset: Dict[str, np.ndarray], *,
            mask: Optional[np.ndarray] = None, steps: int, seed: int = 0, batch: int = 32,
            lr: float = 1e-3, fields: Tuple[str, ...] = ("tokens", "y")) -> Tree:
    """Train a fresh model (``init_fn(seed)``) on the kept subset: the
    paper's prune-then-retrain protocol. ``mask=None`` retrains on
    everything (the full-data arm)."""

    sub = dataset if mask is None else apply_mask(dataset, mask)
    return fit_plain(per_example_fn, init_fn(seed), sub, steps=steps, seed=seed, batch=batch,
                     lr=lr, fields=fields)


def train_plain(model, train: Dict[str, np.ndarray], *, steps: int, seed: int = 0,
                batch: int = 32, lr: float = 1e-3) -> Tree:
    """``fit_plain`` for a ``repro_torch.models.Model``, on its device."""

    return fit_plain(model.classifier_per_example, model.init(seed), train, steps=steps,
                     seed=seed, batch=batch, lr=lr)


def accuracy(forward_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor], theta: Tree,
             dataset: Dict[str, np.ndarray], *, label_key: str = "y_true",
             fields: Tuple[str, ...] = ("tokens",), batch_size: int = 128, mesh=None) -> float:
    """Top-1 accuracy of ``argmax forward_fn(theta, batch)`` against
    ``dataset[label_key]``, batched like scoring on theta's device.
    ``fields`` names the batch keys the forward reads."""

    preds = map_batches(lambda p, b: torch.argmax(forward_fn(p, b), dim=-1), dataset,
                        args=(theta,), fields=fields, batch_size=batch_size, mesh=mesh,
                        device=tu.tree_leaves(theta)[0].device)
    return float(np.mean(preds == dataset[label_key]))


def model_accuracy(model, theta, dataset, *, label_key: str = "y_true", batch_size: int = 128,
                   mesh=None) -> float:
    """``accuracy`` for a ``repro_torch.models.Model`` (its forward returns
    (logits, aux))."""

    return accuracy(lambda p, b: model.forward(p, b)[0], theta, dataset, label_key=label_key,
                    batch_size=batch_size, mesh=mesh)
