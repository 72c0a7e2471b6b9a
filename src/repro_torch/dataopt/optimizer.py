"""The DataOptimizer facade, after ``src/repro/dataopt/optimizer.py``:
data optimization as one object.

    from repro_torch.dataopt import DataOptimizer

    opt = DataOptimizer(model, train, meta=dev, scorer="meta", steps=80)
    scores = opt.fit_scores()                 # any registered scorer
    pruned, mask = opt.prune(ratio=0.3)       # or class_balanced=True
    theta = opt.retrain(steps=150)            # a fresh model on the keep set
    it = opt.reweighted_iterator(batch_size=32, meta_batch_size=32, unroll=2)
    opt.export("out/scores")                  # the JAX package's format

Swapping ``scorer="meta"`` for ``"el2n"`` or any registered name is the one
argument that changes: everything downstream reads the score array. It
runs on the model's device, or on ``device`` (``"cuda"`` unless the caller
passes ``device="cpu"``) for a bare ``per_example_fn``. A ``mesh``
(``repro_torch.launch.mesh``) shards every full-dataset pass over its data
axes and the meta scorer's meta-training with them (every rank builds the
same optimizer and gets the same scores); ``obs`` waits for the port of
``obs/`` (ROADMAP queue 1 item 6) and must be None.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.dataopt import export as export_mod
from repro_torch.dataopt import prune as prune_mod
from repro_torch.dataopt.reweight import ReweightedIterator
from repro_torch.dataopt.scores import ScoreContext, resolve_scorer

Tree = Any


class DataOptimizer:
    """Owns one dataset and one scorer; every product (masks, subsets,
    iterators, retrained parameters, exports) derives from
    ``self.scores``. ``model`` is anything with ``init(seed)``, a
    ``device`` and ``classifier_per_example``; bare function models pass
    ``per_example_fn`` and ``init_fn``."""

    def __init__(self, model=None, train: Dict[str, np.ndarray] = None, *,
                 meta: Optional[Dict[str, np.ndarray]] = None, scorer: Any = "meta",
                 per_example_fn=None, init_fn=None, num_classes: Optional[int] = None,
                 fields: Tuple[str, ...] = ("tokens", "y"), mesh=None, batch_size: int = 128,
                 seed: int = 0, theta: Optional[Tree] = None, obs=None, device=None,
                 **scorer_knobs):
        if train is None:
            raise TypeError("DataOptimizer needs the train dataset")
        if per_example_fn is None:
            if model is None:
                raise TypeError("pass a model or an explicit per_example_fn")
            per_example_fn = model.classifier_per_example
        if init_fn is None:
            if model is None:
                raise TypeError("pass a model or an explicit init_fn")
            init_fn = model.init
        if num_classes is None and model is not None:
            num_classes = getattr(model.cfg, "num_labels", None)
        if device is None:
            device = model.device if model is not None else "cuda"
        self.model = model
        self.ctx = ScoreContext(per_example_fn=per_example_fn, init_fn=init_fn, train=train,
                                meta=meta, fields=fields, mesh=mesh, batch_size=batch_size,
                                seed=seed, theta=theta, num_classes=num_classes, obs=obs,
                                device=device)
        self.scorer_name = scorer if isinstance(scorer, str) else getattr(scorer, "name", "custom")
        self.scorer = resolve_scorer(scorer, **scorer_knobs)
        self.scores: Optional[np.ndarray] = None

    # -- scoring -----------------------------------------------------------

    def fit_scores(self) -> np.ndarray:
        """Run the scorer over the full train set; caches and returns the
        (N,) keep-priority array."""

        scores = np.asarray(self.scorer(self.ctx), np.float32)
        if scores.shape != (self.ctx.n,):
            raise ValueError(f"scorer {self.scorer_name!r} returned shape {scores.shape}, "
                             f"expected ({self.ctx.n},)")
        self.scores = scores
        return scores

    def _require_scores(self) -> np.ndarray:
        if self.scores is None:
            return self.fit_scores()
        return self.scores

    # -- pruning -----------------------------------------------------------

    def prune(self, ratio: float, *, class_balanced: bool = False, label_key: str = "y",
              rounds: int = 1) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Keep the top (1 - ratio) by score. ``rounds > 1`` prunes
        iteratively: each round rescores the survivors and removes an equal
        slice of the original dataset. Returns ``(pruned_dataset,
        keep_mask)`` over the original index space."""

        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        train = self.ctx.train
        n = self.ctx.n
        mask = np.ones(n, dtype=bool)
        per_round = ratio / rounds

        for r in range(rounds):
            if r == 0:
                scores = self._require_scores()
            else:  # rescore the survivors only
                sub_opt = DataOptimizer(
                    self.model, prune_mod.apply_mask(train, mask), meta=self.ctx.meta,
                    scorer=self.scorer, per_example_fn=self.ctx.per_example_fn,
                    init_fn=self.ctx.init_fn, num_classes=self.ctx.num_classes,
                    fields=self.ctx.fields, mesh=self.ctx.mesh, batch_size=self.ctx.batch_size,
                    seed=self.ctx.seed + r, theta=self.ctx.theta, device=self.ctx.device)
                scores = sub_opt.fit_scores()
            # the share of the current survivors to drop so that the kept
            # count tracks (1 - (r + 1) per_round) n of the original
            target_keep = prune_mod.keep_count(n, per_round * (r + 1))
            alive = int(mask.sum())
            round_ratio = 1.0 - target_keep / alive
            if round_ratio <= 0.0:
                continue
            if class_balanced:
                sub_mask = prune_mod.class_balanced_mask(scores, train[label_key][mask],
                                                         round_ratio)
            else:
                sub_mask = prune_mod.keep_mask(scores, round_ratio)
            next_mask = np.zeros(n, dtype=bool)
            next_mask[np.flatnonzero(mask)[sub_mask]] = True
            mask = next_mask
        return prune_mod.apply_mask(train, mask), mask

    # -- retraining and evaluation -----------------------------------------

    def retrain(self, *, steps: int, mask: Optional[np.ndarray] = None, seed: int = 0,
                batch: int = 32, lr: float = 1e-3) -> Tree:
        """A fresh model trained on the kept subset (``mask=None``: the
        full-data baseline)."""

        return prune_mod.retrain(self.ctx.per_example_fn, self.ctx.init_fn, self.ctx.train,
                                 mask=mask, steps=steps, seed=seed, batch=batch, lr=lr,
                                 fields=self.ctx.fields)

    def evaluate(self, theta: Tree, test: Dict[str, np.ndarray], *,
                 label_key: str = "y_true") -> float:
        """Test accuracy of ``theta`` (a Model-backed optimizer; otherwise
        ``prune.accuracy`` with an explicit forward)."""

        if self.model is None:
            raise RuntimeError("evaluate() needs a Model; use prune.accuracy with an explicit "
                               "forward_fn instead")
        return prune_mod.model_accuracy(self.model, theta, test, label_key=label_key,
                                        batch_size=self.ctx.batch_size, mesh=self.ctx.mesh)

    # -- online reweighting ------------------------------------------------

    def reweighted_iterator(self, *, batch_size: int, meta_batch_size: int, unroll: int,
                            temperature=1.0, seed: Optional[int] = None,
                            mesh=None) -> ReweightedIterator:
        """A score-proportional (base level) batch stream over the train
        set, on the optimizer's device; sharded over the optimizer's mesh
        unless ``mesh`` overrides it."""

        return ReweightedIterator(
            self.ctx.train, self.ctx.meta_data, self._require_scores(), batch_size=batch_size,
            meta_batch_size=meta_batch_size, unroll=unroll,
            seed=self.ctx.seed if seed is None else seed, fields=self.ctx.fields,
            temperature=temperature, mesh=self.ctx.mesh if mesh is None else mesh,
            device=self.ctx.device)

    # -- persistence -------------------------------------------------------

    def export(self, path: str, *, mask: Optional[np.ndarray] = None,
               meta: Optional[Dict[str, Any]] = None) -> str:
        """The fitted scores (and optionally a keep mask) with the manifest."""

        return export_mod.export_scores(path, self._require_scores(), scorer=self.scorer_name,
                                        mask=mask, meta=meta)

    def load(self, path: str, *, expect_scorer: Optional[str] = None) -> np.ndarray:
        """Adopt previously exported scores for this dataset (length checked
        against the train set)."""

        scores, _, _ = export_mod.import_scores(path, expect_n=self.ctx.n,
                                                expect_scorer=expect_scorer)
        self.scores = scores
        return scores
