"""Optimizer substrate: tree optimizers + analytic SAMA adaptation matrices."""

from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adam,
    adamw,
    apply_updates,
    get_optimizer,
    momentum,
    sgd,
)

__all__ = [
    "OptState",
    "Optimizer",
    "adam",
    "adamw",
    "apply_updates",
    "get_optimizer",
    "momentum",
    "sgd",
    "schedules",
]
