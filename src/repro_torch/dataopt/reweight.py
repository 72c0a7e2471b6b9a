"""Online reweighted and curriculum batch iteration, after
``src/repro/dataopt/reweight.py``.

``ReweightedIterator`` extends ``data.BatchIterator`` (the same
``(base_batches[K], meta_batch)`` protocol, on the same device) but draws
base examples from a score-proportional distribution (the ``_base_idx``
hook), with numpy's generator as the JAX package draws them: for one seed
and one score array both give the same indices. The sharpness follows a
temperature schedule T(step): T -> inf is uniform, T -> 0 concentrates on
the top scores; ``temperature=(T0, T1, steps)`` anneals linearly, a
callable is taken as it is. The meta split stays uniformly sampled.

With a ``mesh`` every rank draws the same global batch from the same
generator and keeps its rows of it (axis 1 of the base batches, axis 0 of
the meta batch), as the reference's NamedSharding places them: the
batches come as ``launch.mesh.LocalBatch``, on the mesh's device, which
the distributed steps take without slicing again.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np

from repro_torch.data import BatchIterator
from repro_torch.dataopt.distributed import batch_sharding

TemperatureLike = Union[float, Tuple[float, float, int], Callable[[int], float]]


def _temperature_fn(temperature: TemperatureLike) -> Callable[[int], float]:
    if callable(temperature):
        return temperature
    if isinstance(temperature, tuple):
        t0, t1, steps = temperature
        if steps <= 0:
            raise ValueError(f"curriculum steps must be positive, got {steps}")
        return lambda i: t0 + (t1 - t0) * min(i / steps, 1.0)
    return lambda i: float(temperature)


def sampling_probs(scores: np.ndarray, temperature: float) -> np.ndarray:
    """The sampling distribution at a temperature: a softmax over scores
    normalized to their own range, ``p_i ~ exp((s_i - max s) / (range T))``
    (scale-invariant). T -> inf is uniform, T -> 0 the top scores."""

    s = np.asarray(scores, np.float64)
    if not np.all(np.isfinite(s)):
        raise ValueError("scores must be finite to derive sampling probabilities")
    span = s.max() - s.min()
    if span <= 0.0:  # all-equal scores: uniform
        return np.full(len(s), 1.0 / len(s))
    z = (s - s.max()) / span  # in [-1, 0]
    p = np.exp(z / max(temperature, 1e-6))
    return p / p.sum()


class ReweightedIterator(BatchIterator):
    """``BatchIterator`` with score-weighted base sampling."""

    def __init__(self, base_data: Dict[str, np.ndarray], meta_data: Dict[str, np.ndarray],
                 scores: np.ndarray, *, temperature: TemperatureLike = 1.0, mesh=None,
                 **kwargs):
        self.rows = batch_sharding(mesh)
        if mesh is not None:
            kwargs["device"] = mesh.device
        super().__init__(base_data, meta_data, **kwargs)
        self.temperature_fn = _temperature_fn(temperature)
        self.step = 0
        self.update_scores(scores)

    def update_scores(self, scores: np.ndarray):
        """Swap in fresh scores mid-stream (online reweighting)."""

        scores = np.asarray(scores)
        if scores.shape != (self.n,):
            raise ValueError(f"scores shape {scores.shape} != ({self.n},)")
        self.scores = scores.astype(np.float32)

    def _batches(self, idx: np.ndarray, midx: np.ndarray):
        if self.rows is None:
            return super()._batches(idx, midx)
        from repro_torch.launch.mesh import LocalBatch

        base, meta = super()._batches(idx[:, self.rows(self.bs)], midx[self.rows(self.mbs)])
        return LocalBatch(base), LocalBatch(meta)

    def _base_idx(self) -> np.ndarray:
        p = sampling_probs(self.scores, self.temperature_fn(self.step))
        self.step += 1
        return self.rng.choice(self.n, size=(self.k, self.bs), p=p)
