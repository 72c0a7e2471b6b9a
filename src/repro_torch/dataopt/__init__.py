"""repro_torch.dataopt: data optimization, after ``src/repro/dataopt``.

The application layer of the paper's Sec. 4: per-example scoring
(meta-learned importance through any registered hypergradient method, and
the EL2N, GraNd, margin, loss and random heuristics), prune schedules with
a retrain harness, online score-proportional reweighting, full-dataset
scoring and score export in the JAX package's format, behind the
``DataOptimizer`` facade where the scorer is one argument. A mesh
(``repro_torch.launch.mesh``) shards the full-dataset passes, the
reweighted batches and the meta scorer's meta-training over its data
axes; the observability hooks wait for ROADMAP queue 1 item 6.
"""

from repro_torch.dataopt.distributed import batch_sharding, map_batches, score_dataset
from repro_torch.dataopt.export import export_scores, import_scores
from repro_torch.dataopt.optimizer import DataOptimizer
from repro_torch.dataopt.prune import (
    accuracy,
    apply_mask,
    class_balanced_mask,
    keep_count,
    keep_mask,
    model_accuracy,
    retrain,
    train_plain,
)
from repro_torch.dataopt.reweight import ReweightedIterator, sampling_probs
from repro_torch.dataopt.scores import (
    EMATracker,
    ScoreContext,
    ScoreProvider,
    available_scorers,
    ema_disagreement,
    fit_meta,
    fit_plain,
    meta_train,
    register_scorer,
    resolve_scorer,
    unregister_scorer,
)

__all__ = [
    "DataOptimizer",
    "EMATracker",
    "ReweightedIterator",
    "ScoreContext",
    "ScoreProvider",
    "accuracy",
    "apply_mask",
    "available_scorers",
    "batch_sharding",
    "class_balanced_mask",
    "ema_disagreement",
    "export_scores",
    "fit_meta",
    "fit_plain",
    "import_scores",
    "keep_count",
    "keep_mask",
    "map_batches",
    "meta_train",
    "model_accuracy",
    "register_scorer",
    "resolve_scorer",
    "retrain",
    "sampling_probs",
    "score_dataset",
    "train_plain",
    "unregister_scorer",
]
