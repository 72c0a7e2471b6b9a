"""Data substrate: deterministic synthetic pipelines + weak supervision."""

from repro_torch.data.pipeline import (
    BatchIterator,
    ClassificationConfig,
    LMStreamConfig,
    lm_batch,
    make_classification_dataset,
    weak_labels,
)

__all__ = [
    "BatchIterator",
    "ClassificationConfig",
    "LMStreamConfig",
    "lm_batch",
    "make_classification_dataset",
    "weak_labels",
]
